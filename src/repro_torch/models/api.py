"""Unified model API — counterpart of ``repro/models/api.py`` for the
families the port runs (dense, moe, ssm):

  init_params(cfg, generator, dtype, device)    → params (an ``LM``)
  loss_fn(params, batch, cfg, remat)            → scalar loss (float32)
  forward(params, batch, cfg, remat)            → logits [B, S, V]
  prefill(params, batch, cfg, cache_cap)        → (logits [B, V], caches)
  decode_step(params, token, pos, caches, cfg)  → (logits [B, V], caches)
  init_decode_caches(cfg, batch, cache_len, dtype, device) → caches

Batches are dicts holding ``tokens`` (and ``labels``, optionally
``mask``, for the loss).  The other families (hybrid, encdec, vlm)
raise ``NotImplementedError``.  There is no ``impl`` argument: the device
decides how attention runs (``models/attention.py``).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import lm


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda"):
    return lm.init_params(cfg, generator, dtype, device)


def loss_fn(params, batch, cfg: ModelConfig, *, remat="block"):
    return lm.loss_fn(params, batch, cfg, remat=remat)


def forward(params, batch, cfg: ModelConfig, *, remat="none"):
    return lm.forward(params, batch["tokens"], cfg, remat=remat)


def prefill(params, batch, cfg: ModelConfig, cache_cap=None):
    return lm.prefill(params, batch["tokens"], cfg, cache_cap=cache_cap)


def decode_step(params, token, pos, caches, cfg: ModelConfig):
    return lm.decode_step(params, token, pos, caches, cfg)


def init_decode_caches(cfg: ModelConfig, batch: int, cache_len: int,
                       dtype=torch.bfloat16, device="cuda"):
    return lm.init_decode_caches(cfg, batch, cache_len, dtype, device)
