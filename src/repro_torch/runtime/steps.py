"""Step factories: train_step / prefill_step / decode_step — counterpart
of ``repro/runtime/steps.py``.

``train_step(state, batch) → (state, metrics)``: the loss and its
gradients (``make_grad_fn``), then one AdamW update, which writes the
parameters in place.  With ``microbatches`` > 1 the batch is cut along
its first axis and the gradients are summed in float32 over the slices,
then divided by their count, as the JAX package's ``lax.scan`` does.
The learning rate of the step is ``lr_schedule(step + 1)``: 1-indexed,
so the first warmup step's rate is lr/W, never zero.

On a mesh (the state placed by ``runtime.elastic.reshard_state``, the
batch by ``launch.dryrun.batch_sharding``, the step called inside
``sharding.mesh_context``) the same code runs on DTensors: each
gradient is placed as its parameter, the float32 accumulators keep
that placement, and the loss and the clip read the global values.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, ShardingConfig, TrainConfig
from repro_torch.models import api
from repro_torch.optim import adamw_init, adamw_update, lr_schedule
from repro_torch.optim.adamw import AdamWState


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module
    opt: AdamWState
    step: int


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig,
                 scfg: ShardingConfig) -> Callable:
    """(params, batch) → (loss, {name: gradient}): the first half of a
    train step.  Gradients are in the param dtype for one microbatch and
    float32 summed over several."""

    def grad_fn(params, batch):
        names, ps = zip(*params.named_parameters())
        n = tcfg.microbatches
        if n == 1:
            loss = api.loss_fn(params, batch, cfg, remat=scfg.remat)
            grads = _placed_as(torch.autograd.grad(loss, ps), ps)
            return loss.detach(), dict(zip(names, grads))
        size = batch["tokens"].shape[0] // n
        losses = []
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            l = api.loss_fn(params, mb, cfg, remat=scfg.remat)
            for a, g in zip(acc, _placed_as(torch.autograd.grad(l, ps), ps)):
                a.add_(g)
            losses.append(l.detach())
        return sum(losses) / n, {k: a / n for k, a in zip(names, acc)}

    return grad_fn


def _placed_as(grads, ps):
    """Each gradient placed as its parameter (a DTensor's gradient may
    come back partial or otherwise split); plain tensors as they are."""
    from torch.distributed.tensor import DTensor
    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(g, DTensor) and g.placements != p.placements
            else g for g, p in zip(grads, ps)]


def _global(x):
    """A metric as one plain value on every process (a DTensor's may be
    a partial sum or average until reduced)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    scfg: ShardingConfig) -> Callable:
    """(TrainState, batch) → (TrainState, metrics)."""
    grad_fn = make_grad_fn(cfg, tcfg, scfg)

    def train_step(state: TrainState, batch):
        loss, grads = grad_fn(state.params, batch)
        lr = lr_schedule(state.step + 1, tcfg)
        params, opt, stats = adamw_update(grads, state.opt, state.params,
                                          tcfg, lr)
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {k: _global(v) for k, v in {"loss": loss, **stats}.items()})

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_cap: int | None = None):
    def prefill_step(params, batch):
        return api.prefill(params, batch, cfg, cache_cap=cache_cap)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, caches, token, pos):
        return api.decode_step(params, token, pos, caches, cfg)

    return decode_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, *,
                     generator: torch.Generator | None = None, dtype=None,
                     device="cuda") -> TrainState:
    """Fresh params (``tcfg.param_dtype`` unless ``dtype``) and zero
    optimizer state.  The params are built on the CPU, the weights drawn
    from ``generator`` (default: seeded with ``tcfg.seed``), and then
    moved, so every device starts from the same bits (the SSM's
    ``A_log`` is a ``log`` of a ``linspace``, which the card rounds
    otherwise)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(tcfg.seed)
    dtype = dtype or (torch.bfloat16 if tcfg.param_dtype == "bfloat16"
                      else torch.float32)
    params = api.init_params(cfg, gen, dtype, "cpu").to(dev)
    return TrainState(params=params, opt=adamw_init(params, tcfg), step=0)
