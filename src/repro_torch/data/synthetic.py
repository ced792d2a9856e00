"""Deterministic, stateless synthetic data pipeline — counterpart of
``repro/data/synthetic.py``.

Every batch is a pure function of (seed, step): the pipeline has no
cursor state, so resume-after-failure needs only the step counter and
the stream continues exactly.  The tokens are drawn on the CPU from a
``torch.Generator`` seeded with (seed, step) and then moved to the
device, so the card and the CPU see the same tokens.  They are not the
JAX package's tokens (its threefry bits are not reproduced); the
distribution is the same: Zipf-distributed unigrams, and in half the
rows the last quarter repeating the first, so small models have
learnable structure.  The encdec family's batches also carry
``frames`` [B, enc_seq, d] and the vlm family's ``patches`` [B,
n_patches, d]: float32, 0.02 · N(0, 1), drawn after the tokens from the
same generator.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for (seed, step): the pair hashed by numpy's
    ``SeedSequence`` into the 32 bits that the CPU generator's
    Mersenne twister keeps of a seed."""
    key = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)
    return torch.Generator().manual_seed(int(key[0]))


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        """The batch of ``step``: int32 ``tokens`` and ``labels`` [B, S],
        and float32 ``frames`` (encdec) or ``patches`` (vlm)."""
        cfg = self.cfg
        gen = _generator(self.seed, step)
        # Zipf-ish unigrams via an exponential transform of uniforms
        u = torch.rand((self.batch, self.seq), generator=gen) \
            * (1.0 - 1e-6) + 1e-6
        zipf = torch.floor(torch.exp(math.log(float(cfg.vocab)) * u)) - 1.0
        toks = torch.clamp(zipf.to(torch.int32), 0, cfg.vocab - 1)
        # splice in copy patterns: the last quarter repeats the first
        quarter = self.seq // 4
        if quarter > 0:
            do_copy = torch.rand((self.batch, 1), generator=gen) < 0.5
            tail = toks[:, self.seq - quarter:]
            toks[:, self.seq - quarter:] = torch.where(
                do_copy, toks[:, :quarter], tail)
        toks = toks.to(self.device)
        batch = {"tokens": toks, "labels": toks}
        for name, rows in stub_rows(cfg).items():
            batch[name] = (0.02 * torch.randn(
                (self.batch, rows, cfg.d_model), generator=gen)).to(
                    self.device)
        return batch


def stub_rows(cfg: ModelConfig) -> dict:
    """The family's modality-stub inputs, name → rows a sequence:
    ``frames`` (encdec), ``patches`` (vlm), none for the others."""
    if cfg.family == "encdec":
        return {"frames": cfg.enc_seq}
    if cfg.family == "vlm":
        return {"patches": cfg.n_patches}
    return {}


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Shape-and-dtype stand-ins of a batch (tensors on the ``meta``
    device, which hold no data)."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    specs = {"tokens": spec((batch, seq), torch.int32),
             "labels": spec((batch, seq), torch.int32)}
    for name, rows in stub_rows(cfg).items():
        specs[name] = spec((batch, rows, cfg.d_model), torch.float32)
    return specs
