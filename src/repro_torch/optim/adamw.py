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
DTensors: every state takes its parameters' placements (an int8
``QTensor``'s ``q``; its ``scale`` is replicated) and the clip reads the
global norm.  ``adamw_update``
writes the new values into the parameters in place (PyTorch's idiom;
the JAX package returns fresh arrays) and returns new m / v.

The JAX package stacks every group's copy of a parameter on one leaf
(``groups/l0/attn/wq``; an encoder-decoder's layers under ``enc`` and
``dec``, ``STACKED``) and quantizes that leaf against one absmax.  The
port keeps a tensor a group or layer (``groups.0.l0.attn.wq``,
``enc.0.attn.wq``, ...), so an int8 update quantizes the slices of one
stacked leaf together (``stack_key``): one shared scale, the max over
every slice's tensor, and so the same q and scale as the JAX package,
slice by slice.  On a mesh that max is the global one, over every
shard of every slice: each process's local max, all-reduced (MAX) over
the mesh dimensions that split the tensor (``_absmax``); each process
then quantizes its own shard, and nothing is gathered.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.config import TrainConfig
from repro_torch.sharding import is_dtensor


@dataclasses.dataclass
class QTensor:
    """int8 tensor with a per-tensor float32 scale."""
    q: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def quantize(x: torch.Tensor,
                 absmax: torch.Tensor | None = None) -> "QTensor":
        """``x`` against ``absmax`` (default: its own) — a stacked
        leaf's groups pass the max over all of them.  A DTensor ``x``
        gives a ``q`` at its placements and a replicated ``scale``,
        each process's shard quantized where it lies."""
        a = (_absmax(x) if absmax is None else absmax) / 127.0
        a = torch.where(a > 0, a, torch.ones_like(a)).float()
        q = _placed_like(torch.clamp(torch.round(_local(x) / a), -127, 127)
                         .to(torch.int8), x)
        if not is_dtensor(x):
            return QTensor(q=q, scale=a)
        from torch.distributed.tensor import DTensor, Replicate
        mesh = x.device_mesh
        return QTensor(q=q, scale=DTensor.from_local(
            a, mesh, [Replicate()] * mesh.ndim, run_check=False))

    def dequantize(self) -> torch.Tensor:
        return self.q.float() * self.scale


def _absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a plain 0-d tensor, the same on every process: a
    DTensor's local max, all-reduced (MAX) over each mesh dimension
    that splits it (one scalar a dimension; nothing is gathered)."""
    if not is_dtensor(x):
        return x.abs().max()
    import torch.distributed as dist
    m = x.to_local().abs().max()
    for j, p in enumerate(x.placements):
        if p.is_shard() and x.device_mesh.size(j) > 1:
            dist.all_reduce(m, dist.ReduceOp.MAX,
                            group=x.device_mesh.get_group(j))
    return m


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
        a = _absmax(x)
        absmax[k] = a if k not in absmax else torch.maximum(absmax[k], a)
    return {n: QTensor.quantize(x, absmax[stack_key(n)])
            for n, x in xs.items()}


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage); a plain tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def _placed_like(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A local result ``x`` as a DTensor placed as ``p`` (``x`` itself
    off a mesh)."""
    if not is_dtensor(p):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def _load(x) -> torch.Tensor:
    """A moment's local shard in float32."""
    if isinstance(x, QTensor):
        return _local(x.q).float() * _local(x.scale)
    return _local(x).float()


def adamw_init(params, cfg: TrainConfig) -> AdamWState:
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
    step = state.step + 1
    ps = named(params)
    gnorm = global_norm(grads[n] for n in ps)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** t).item()
    bc2 = (1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** t).item()

    int8 = cfg.opt_state_dtype == "int8"
    clip = clip.full_tensor() if is_dtensor(clip) else clip
    new_m, new_v = {}, {}
    for n, p in ps.items():
        # each process updates its own shard: every step below is
        # elementwise, and the shards of a parameter, its gradient and
        # its moments line up
        g = grads[n]
        if is_dtensor(g) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        g32 = _local(g).float() * clip
        m32 = cfg.b1 * _load(state.m[n]) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * _load(state.v[n]) + (1 - cfg.b2) * g32 * g32
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        pl = _local(p)
        p32 = pl.float()
        p32 = p32 - lr * (upd + cfg.weight_decay * p32)
        pl.copy_(p32.to(pl.dtype))
        if int8:    # quantized below, once every group's value is known
            new_m[n], new_v[n] = _placed_like(m32, p), _placed_like(v32, p)
        else:
            new_m[n] = _placed_like(_store(m32, cfg.opt_state_dtype), p)
            new_v[n] = _placed_like(_store(v32, cfg.opt_state_dtype), p)
    if int8:
        new_m, new_v = _quantize_stacked(new_m), _quantize_stacked(new_v)
    return params, AdamWState(step=step, m=new_m, v=new_v), \
        {"grad_norm": gnorm, "lr": lr}
