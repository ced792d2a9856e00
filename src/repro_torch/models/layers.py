"""Shared NN layers: norms, positional encodings, MLP variants,
embedding (counterpart of ``repro/models/layers.py``).

Parameters live in ``nn.Module``s whose attribute names are the JAX
param dict's keys (``repro_torch.convert`` relies on that); every init
function takes an explicit ``torch.Generator``, a dtype and a device.
Compute dtype is the input dtype; norms and rope compute in float32.
A product of a float32 operand and a bfloat16 one runs in float32
(``mm``), as JAX promotes them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.sharding import (current_mesh, gathered, on_local_shards,
                                  replicated_like, spec)


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """``scale · N(0, 1)`` drawn in float32 on the generator's device,
    then cast (the JAX package's ``_normal``)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return x.to(device=device, dtype=dtype)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two: JAX promotes a float32
    operand and a bfloat16 one to float32, where torch's matmul raises.
    Operands of one dtype go in unchanged."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def params_module(module: nn.Module | None = None, /,
                  **tensors: torch.Tensor) -> nn.Module:
    """``module`` (a new plain ``nn.Module`` by default) holding
    ``tensors`` as parameters by name."""
    m = nn.Module() if module is None else module
    for k, v in tensors.items():
        m.register_parameter(k, nn.Parameter(v))
    return m


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dtype, device) -> nn.Module:
    if cfg.norm_kind == "ln_nonparam":      # OLMo: non-parametric LN
        return params_module()
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_kind == "ln":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return params_module(**p)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 where it is float64: the steps
    that compute in float32 keep a float64 copy of a model (the
    reference its float32 runs are read against) in float64."""
    return x if x.dtype == torch.float64 else x.float()


def apply_norm(p: nn.Module, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = at_least_f32(x)
    if kind == "rms":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p.scale.to(xf.dtype)).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "ln":
        y = y * p.scale.to(xf.dtype) + p.bias.to(xf.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, D] (D even, halves rotated, not interleaved);
    positions: [..., S].  Computed in float32."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq           # [..., S, half]
    cos = replicated_like(torch.cos(ang)[..., :, None, :], x)
    sin = replicated_like(torch.sin(ang)[..., :, None, :], x)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal(seq: int, d: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    d, f = cfg.d_model, cfg.d_ff
    scale_in, scale_out = d ** -0.5, f ** -0.5
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return params_module(
            w_gate=_normal(gen, (d, f), scale_in, dtype, device),
            w_up=_normal(gen, (d, f), scale_in, dtype, device),
            w_down=_normal(gen, (f, d), scale_out, dtype, device))
    return params_module(w_up=_normal(gen, (d, f), scale_in, dtype, device),
                         w_down=_normal(gen, (f, d), scale_out, dtype,
                                        device))


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def ffn(x: torch.Tensor, w_up, w_down, kind: str,
        w_gate=None) -> torch.Tensor:
    """The MLP on its weight matrices (one dense MLP, or one expert).
    On a mesh each weight's d dimension (its ZeRO split) is gathered
    for the product (``sharding.gathered``)."""
    w_up, w_down = gathered(w_up, 0, x), gathered(w_down, 1, x)
    if kind in ("swiglu", "geglu"):
        g = mm(x, gathered(w_gate, 0, x))
        act = F.silu(g) if kind == "swiglu" else _gelu(g)
        return mm(act * mm(x, w_up), w_down)
    return mm(_gelu(mm(x, w_up)), w_down)


def apply_mlp(p: nn.Module, x: torch.Tensor, kind: str) -> torch.Tensor:
    return ffn(x, p.w_up, p.w_down, kind, getattr(p, "w_gate", None))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    p = {"tok": _normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype, device)}
    if cfg.pos_kind == "learned":
        p["pos"] = _normal(gen, (cfg.max_seq, cfg.d_model), 0.02, dtype,
                           device)
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab),
                               cfg.d_model ** -0.5, dtype, device)
    return params_module(**p)


def _lookup(table: torch.Tensor, tokens: torch.Tensor,
            pos: torch.Tensor | None = None,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """``table[tokens]``, plus ``pos[positions]`` where a learned
    position table ``pos`` is given.  On a mesh, under ``local_map``:
    tokens split by batch, the tables whole on each process (DTensor's
    own rules for a lookup in a split table are not relied on)."""
    def local(tl, wl, *pl):
        x = wl[tl]
        return x + pl[0][positions] if pl else x

    tables = (table,) if pos is None else (table, pos)
    if current_mesh() is None:
        return local(tokens, *tables)
    rows = spec("batch", None, dims=tokens.shape)[0]
    return on_local_shards(local, (rows, None, None),
                           ((rows, None),) + ((None, None),) * len(tables),
                           tokens, *tables)


def embed(p: nn.Module, tokens: torch.Tensor, cfg: ModelConfig,
          positions: torch.Tensor | None = None) -> torch.Tensor:
    if cfg.pos_kind == "learned":
        return _lookup(p.tok, tokens, p.pos, positions)
    x = _lookup(p.tok, tokens)
    if cfg.pos_kind == "sinusoidal":
        x = x + replicated_like(sinusoidal(cfg.max_seq, cfg.d_model, x.dtype,
                                           x.device)[positions], x)
    return x


def unembed(p: nn.Module, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Logits in float32: the product runs in the param dtype and is
    cast afterwards, as in the JAX package."""
    w = gathered(p.unembed if hasattr(p, "unembed") else p.tok.T, 0, x)
    logits = at_least_f32(x @ w)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits

