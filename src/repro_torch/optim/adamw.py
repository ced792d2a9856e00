"""AdamW written by hand, with selectable optimizer-state dtype —
counterpart of ``repro/optim/adamw.py``.

State dtypes (TrainConfig.opt_state_dtype):
  float32  — standard
  bfloat16 — halves the optimizer's memory
  int8     — quantized m/v with one float32 absmax scale per stacked
             leaf (``QTensor``)

The update is the JAX package's arithmetic, step for step, in float32:
global-norm clipping, bias corrections ``1 − b^step`` formed in float32,
and the decoupled decay ``p − lr·(upd + wd·p)`` cast back to the param
dtype.  ``torch.optim.AdamW`` is not used: it applies the decay as a
separate multiply (other rounding) and has no int8 state.

Parameters are an ``nn.Module`` (its ``named_parameters``) or a dict of
tensors; m and v are dicts under the same names.  On a mesh they are
DTensors: the float32 and bfloat16 states take their parameters'
placements and the clip reads the global norm; the int8 state raises
there (ROADMAP A17).  ``adamw_update``
writes the new values into the parameters in place (PyTorch's idiom;
the JAX package returns fresh arrays) and returns new m / v.

The JAX package stacks every group's copy of a parameter on one leaf
(``groups/l0/attn/wq``; an encoder-decoder's layers under ``enc`` and
``dec``, ``STACKED``) and quantizes that leaf against one absmax.  The
port keeps a tensor a group or layer (``groups.0.l0.attn.wq``,
``enc.0.attn.wq``, ...), so an int8 update quantizes the slices of one
stacked leaf together (``stack_key``): one shared scale, the max over
every slice's tensor, and so the same q and scale as the JAX package,
slice by slice.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import not_ported
from repro_torch.config import TrainConfig
from repro_torch.sharding import current_mesh


@dataclasses.dataclass
class QTensor:
    """int8 tensor with a per-tensor float32 scale."""
    q: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def quantize(x: torch.Tensor,
                 absmax: torch.Tensor | None = None) -> "QTensor":
        """``x`` against ``absmax`` (default: its own) — a stacked
        leaf's groups pass the max over all of them."""
        a = (x.abs().max() if absmax is None else absmax) / 127.0
        a = torch.where(a > 0, a, torch.ones_like(a))
        return QTensor(q=torch.clamp(torch.round(x / a), -127, 127)
                       .to(torch.int8), scale=a.float())

    def dequantize(self) -> torch.Tensor:
        return self.q.float() * self.scale


@dataclasses.dataclass
class AdamWState:
    step: int
    m: dict
    v: dict


def named(params) -> dict[str, torch.Tensor]:
    """``params`` (a module or a dict of tensors) as a name → tensor dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


# the top-level names under which the JAX package stacks layers on a
# leading axis: an LM's groups, an encoder-decoder's encoder and decoder
# layers (``convert`` and ``checkpoint/io.py`` read it too)
STACKED = ("groups", "enc", "dec")


def stack_key(name: str) -> str:
    """The JAX package's stacked leaf a parameter belongs to:
    ``<stack>.<i>.<rest>`` → ``<stack>.<rest>`` for a ``STACKED`` prefix;
    any other name is a leaf of its own."""
    parts = name.split(".")
    if parts[0] in STACKED and len(parts) > 2 and parts[1].isdigit():
        return ".".join([parts[0]] + parts[2:])
    return name


def _store(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """A float32 or bfloat16 state tensor (int8: ``_quantize_stacked``)."""
    return x.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _quantize_stacked(xs: dict) -> dict:
    """Every tensor of ``xs`` (by parameter name) as a ``QTensor``, the
    groups of one stacked leaf against their one shared absmax."""
    absmax: dict[str, torch.Tensor] = {}
    for n, x in xs.items():
        k = stack_key(n)
        a = x.abs().max()
        absmax[k] = a if k not in absmax else torch.maximum(absmax[k], a)
    return {n: QTensor.quantize(x, absmax[stack_key(n)])
            for n, x in xs.items()}


def _load(x) -> torch.Tensor:
    if isinstance(x, QTensor):
        return x.dequantize()
    return x.float()


def _check_int8_off_mesh(cfg: TrainConfig) -> None:
    if cfg.opt_state_dtype == "int8" and current_mesh() is not None:
        not_ported("the int8 optimizer state on a mesh", "A17")


def adamw_init(params, cfg: TrainConfig) -> AdamWState:
    _check_int8_off_mesh(cfg)

    def zeros():
        z = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in named(params).items()}
        if cfg.opt_state_dtype == "int8":
            return _quantize_stacked(z)
        return {n: _store(x, cfg.opt_state_dtype) for n, x in z.items()}
    return AdamWState(step=0, m=zeros(), v=zeros())


def global_norm(tensors) -> torch.Tensor:
    """√(Σ ‖t‖²) over ``tensors`` in float32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params, cfg: TrainConfig,
                 lr):
    """One AdamW step with global-norm clipping; ``grads`` by parameter
    name, ``lr`` a float or a 0-d float32 tensor.  Updates ``params`` in
    place.  Returns (params, new_state, stats)."""
    _check_int8_off_mesh(cfg)
    step = state.step + 1
    ps = named(params)
    gnorm = global_norm(grads[n] for n in ps)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** t).item()
    bc2 = (1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** t).item()

    int8 = cfg.opt_state_dtype == "int8"
    new_m, new_v = {}, {}
    for n, p in ps.items():
        g32 = grads[n].float() * clip
        m32 = cfg.b1 * _load(state.m[n]) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * _load(state.v[n]) + (1 - cfg.b2) * g32 * g32
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        p32 = p32 - lr * (upd + cfg.weight_decay * p32)
        p.copy_(p32.to(p.dtype))
        if int8:    # quantized below, once every group's value is known
            new_m[n], new_v[n] = m32, v32
        else:
            new_m[n] = _store(m32, cfg.opt_state_dtype)
            new_v[n] = _store(v32, cfg.opt_state_dtype)
    if int8:
        new_m, new_v = _quantize_stacked(new_m), _quantize_stacked(new_v)
    return params, AdamWState(step=step, m=new_m, v=new_v), \
        {"grad_norm": gnorm, "lr": lr}
