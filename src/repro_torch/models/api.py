"""Unified model API over every model family (dense, moe, ssm, hybrid,
vlm, encdec) — counterpart of ``repro/models/api.py``:

  init_params(cfg, generator, dtype, device)    → params (an ``LM`` or
                                                  an ``EncDec``)
  loss_fn(params, batch, cfg, remat)            → scalar loss (float32)
  forward(params, batch, cfg, remat)            → logits [B, S, V]
  prefill(params, batch, cfg, cache_cap)        → (logits [B, V], caches)
  decode_step(params, token, pos, caches, cfg)  → (logits [B, V], caches)
  init_decode_caches(cfg, batch, cache_len, dtype, device) → caches

Batches are dicts holding ``tokens`` (and ``labels``, optionally
``mask``, for the loss), plus ``frames`` [B, enc_seq, d] for encdec
(``models/encdec.py``) and ``patches`` [B, n_patches, d] for vlm
(``models/lm.py``; decode positions then count the patches).  There is
no ``impl`` argument: the device decides how attention runs
(``models/attention.py``).  On a mesh every family's ``loss_fn`` /
``forward`` / ``prefill`` / ``decode_step`` runs, the batch's
``tokens``, ``labels``, ``frames`` and ``patches`` placed by
``launch.dryrun.batch_sharding`` and the caches at
``launch.dryrun.cache_sharding``'s placements.  ``input_specs`` comes
with the dry-run (ROADMAP A18).
"""
from __future__ import annotations

import torch

from repro_torch import not_ported
from repro_torch.config import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.sharding import current_mesh

# the families whose training, prefill and decode run on a mesh
MESH_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_lm_mesh(cfg: ModelConfig, what: str = "training") -> None:
    """Raise, naming the ROADMAP step, where a mesh is in scope and
    ``cfg``'s family does not run ``what`` (training, prefill, decode)
    on one yet."""
    if current_mesh() is None:
        return
    if cfg.family not in MESH_FAMILIES:
        not_ported(f"{what} of the {cfg.family!r} family ({cfg.name}) on a "
                   "mesh", "A17")


def _extra(batch, cfg: ModelConfig):
    return {"patches": batch["patches"]} if cfg.family == "vlm" else None


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda"):
    if cfg.family == "encdec":
        return encdec.init_params(cfg, generator, dtype, device)
    return lm.init_params(cfg, generator, dtype, device)


def loss_fn(params, batch, cfg: ModelConfig, *, remat="block"):
    check_lm_mesh(cfg)
    if cfg.family == "encdec":
        return encdec.loss_fn(params, batch, cfg, remat=remat)
    return lm.loss_fn(params, batch, cfg, extra=_extra(batch, cfg),
                      remat=remat)


def forward(params, batch, cfg: ModelConfig, *, remat="none"):
    check_lm_mesh(cfg)
    if cfg.family == "encdec":
        enc = encdec.encode(params, batch["frames"], cfg, remat)
        return encdec.decode_seq(params, batch["tokens"], enc, cfg, remat)
    return lm.forward(params, batch["tokens"], cfg, extra=_extra(batch, cfg),
                      remat=remat)


def prefill(params, batch, cfg: ModelConfig, cache_cap=None):
    check_lm_mesh(cfg, "prefill")
    if cfg.family == "encdec":
        return encdec.prefill(params, batch["tokens"], batch["frames"], cfg,
                              cache_cap)
    return lm.prefill(params, batch["tokens"], cfg, extra=_extra(batch, cfg),
                      cache_cap=cache_cap)


def decode_step(params, token, pos, caches, cfg: ModelConfig):
    check_lm_mesh(cfg, "decode")
    if cfg.family == "encdec":
        return encdec.decode_step(params, token, pos, caches, cfg)
    return lm.decode_step(params, token, pos, caches, cfg)


def init_decode_caches(cfg: ModelConfig, batch: int, cache_len: int,
                       dtype=torch.bfloat16, device="cuda"):
    if cfg.family == "encdec":
        return encdec.init_decode_caches(cfg, batch, cache_len, dtype,
                                         device)
    return lm.init_decode_caches(cfg, batch, cache_len, dtype, device)
