"""Linear-warmup + cosine-decay learning-rate schedule — counterpart of
``repro/optim/schedule.py``, in float32 as there."""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def lr_schedule(step, cfg: TrainConfig) -> torch.Tensor:
    """The rate at ``step`` (an int or a tensor) as a float32 tensor on
    the step's device (the CPU for an int)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < cfg.warmup_steps, warm, cos)
