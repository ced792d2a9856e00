"""Layer blocks: (mixer, ffn) pairs composed per the config's pattern —
counterpart of ``repro/models/blocks.py``.

A *group* is the config's repeating pattern of layers (dense and ssm:
1 layer; moe: ``moe_every``; hybrid: one period of ``attn_period``
layers mixing attention and SSM mixers, MLPs and MoEs).  The JAX
package scans over stacked group params; here the LM holds a
``ModuleList`` of groups and loops over it, and each group is a module
holding its layers ``l0``, ``l1``, ….  A layer's FFN
is an MLP (``mlp``) or a mixture of experts (``moe``,
``models/moe.py``), called as a module so that forward hooks see its
input.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.models.moe import init_moe


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """[(mixer, ffn)] for each layer in one period."""
    period = group_size(cfg)
    out = []
    for i in range(period):
        if cfg.family in ("ssm",):
            mixer = "ssm"
        elif cfg.family == "hybrid":
            mixer = "attn" if i % cfg.attn_period == cfg.attn_offset \
                else "ssm"
        else:
            mixer = "attn"
        if cfg.n_experts and (i % cfg.moe_every == cfg.moe_every - 1):
            ffn = "moe"
        elif mixer == "ssm" and cfg.d_ff == 0:
            ffn = "none"           # pure mamba blocks have no FFN
        else:
            ffn = "mlp"
        out.append((mixer, ffn))
    return out


def group_size(cfg: ModelConfig) -> int:
    period = 1
    if cfg.family == "hybrid":
        period = cfg.attn_period
    if cfg.n_experts:
        period = max(period, cfg.moe_every)
    return period


def n_groups(cfg: ModelConfig) -> int:
    g = group_size(cfg)
    assert cfg.n_layers % g == 0, (cfg.n_layers, g)
    return cfg.n_layers // g


def init_group(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    group = nn.Module()
    for i, (mixer, ffn) in enumerate(layer_kinds(cfg)):
        layer = nn.Module()
        layer.norm1 = init_norm(cfg, dtype, device)
        if mixer == "attn":
            layer.attn = A.init_attention(gen, cfg, dtype, device)
        else:
            layer.ssm = S.init_ssm(gen, cfg, dtype, device)
        if ffn != "none":
            layer.norm2 = init_norm(cfg, dtype, device)
        if ffn == "moe":
            layer.moe = init_moe(gen, cfg, dtype, device)
        elif ffn == "mlp":
            layer.mlp = init_mlp(gen, cfg, dtype, device)
        group.add_module(f"l{i}", layer)
    return group


def init_group_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                     device) -> dict:
    """Cache dict for one group."""
    caches = {}
    for i, (mixer, _) in enumerate(layer_kinds(cfg)):
        if mixer == "attn":
            caches[f"l{i}"] = A.init_cache(cfg, batch, cache_len, dtype,
                                           device)
        else:
            caches[f"l{i}"] = S.init_ssm_cache(cfg, batch, dtype, device)
    return caches


def _ffn(lp: nn.Module, ffn: str, x: torch.Tensor, cfg: ModelConfig):
    h = apply_norm(lp.norm2, x, cfg.norm_kind)
    if ffn == "moe":
        return lp.moe(h, cfg)
    return apply_mlp(lp.mlp, h, cfg.mlp_kind)


def apply_group(group: nn.Module, x: torch.Tensor, cfg: ModelConfig, *,
                positions=None, make_cache: bool = False,
                cache_cap: int | None = None, init_caches=None):
    """Full-sequence pass over one group. Returns (x, caches | None)."""
    caches = {} if make_cache else None
    for i, (mixer, ffn) in enumerate(layer_kinds(cfg)):
        lp = getattr(group, f"l{i}")
        h = apply_norm(lp.norm1, x, cfg.norm_kind)
        if mixer == "attn":
            mixed, c = A.attention(lp.attn, h, cfg, causal=True,
                                   positions=positions,
                                   make_cache=make_cache,
                                   cache_cap=cache_cap)
        else:
            prev = (init_caches[f"l{i}"]
                    if init_caches is not None else None)
            mixed, c = S.apply_ssm(lp.ssm, h, cfg, cache=prev,
                                   return_cache=make_cache)
        x = x + mixed
        if ffn != "none":
            x = x + _ffn(lp, ffn, x, cfg)
        if make_cache:
            caches[f"l{i}"] = c
    return x, caches


def decode_group(group: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                 caches: dict, pos: int):
    """One-token step over one group. Returns (x, caches), the caches
    updated in place."""
    for i, (mixer, ffn) in enumerate(layer_kinds(cfg)):
        lp = getattr(group, f"l{i}")
        h = apply_norm(lp.norm1, x, cfg.norm_kind)
        if mixer == "attn":
            mixed, c = A.decode_attention(lp.attn, h, cfg,
                                          caches[f"l{i}"], pos)
        else:
            mixed, c = S.decode_ssm(lp.ssm, h, cfg, caches[f"l{i}"])
        x = x + mixed
        if ffn != "none":
            x = x + _ffn(lp, ffn, x, cfg)
        caches[f"l{i}"] = c
    return x, caches
