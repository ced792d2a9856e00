"""Unified model API over every model family (dense, moe, ssm, hybrid,
vlm, encdec) — counterpart of ``repro/models/api.py``:

  init_params(cfg, generator, dtype, device)    → params (an ``LM`` or
                                                  an ``EncDec``)
  loss_fn(params, batch, cfg, remat)            → scalar loss (float32)
  forward(params, batch, cfg, remat)            → logits [B, S, V]
  prefill(params, batch, cfg, cache_cap)        → (logits [B, V], caches)
  decode_step(params, token, pos, caches, cfg)  → (logits [B, V], caches)
  init_decode_caches(cfg, batch, cache_len, dtype, device) → caches
  input_specs(cfg, shape, device)               → a dry-run cell's inputs
                                                  (meta or fake tensors)

Batches are dicts holding ``tokens`` (and ``labels``, optionally
``mask``, for the loss), plus ``frames`` [B, enc_seq, d] for encdec
(``models/encdec.py``) and ``patches`` [B, n_patches, d] for vlm
(``models/lm.py``; decode positions then count the patches).  There is
no ``impl`` argument: the device decides how attention runs
(``models/attention.py``).  On a mesh every family's ``loss_fn`` /
``forward`` / ``prefill`` / ``decode_step`` runs, the batch's
``tokens``, ``labels``, ``frames`` and ``patches`` placed by
``launch.dryrun.batch_sharding`` and the caches at
``launch.dryrun.cache_sharding``'s placements.
"""
from __future__ import annotations

import torch

from repro_torch import not_ported
from repro_torch.config import ModelConfig, ShapeConfig
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> dict:
    """Stand-ins for every model input of a dry-run cell: the reference's
    leaves with its shapes and dtypes (int32 tokens, labels and decode
    token; bfloat16 frames and patches; decode's ``pos`` a 0-d int32),
    as empty tensors on ``device`` — ``"meta"``, or a fake device under
    ``FakeTensorMode`` — so nothing is allocated."""
    b, s = shape.global_batch, shape.seq_len

    def empty(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "decode":    # one token against a cache of length s
        return {"token": empty((b, 1)), "pos": empty(())}
    batch = {"tokens": empty((b, s))}
    if shape.kind == "train":
        batch["labels"] = empty((b, s))
    if cfg.family == "encdec":
        batch["frames"] = empty((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        batch["patches"] = empty((b, cfg.n_patches, cfg.d_model),
                                 torch.bfloat16)
    return batch
