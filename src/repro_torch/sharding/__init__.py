"""Logical-axis sharding rules → per-dimension mesh axes → DTensor
placements — counterpart of ``repro/sharding/__init__.py`` — and the
graph engine's placement helpers (``sharding.graph``).

Models annotate activations with *logical* axis names (``shard``);
parameters get specs from path rules (``PARAM_RULES``).  A logical name
resolves to mesh axes through ``LOGICAL_RULES`` and is silently dropped
when the mesh in scope lacks the axis or the dimension does not divide
— so one model definition runs unchanged on the (data, model) and
(pod, data, model) production meshes, a small test mesh and no mesh.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dimension, ``None``, an axis name or a tuple of axis names.
The mesh in scope (``mesh_context``) is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the axis names, or an ``AbstractMesh`` (names and sizes only) for
resolving specs without processes.  ``placements`` turns a spec into
DTensor placements on a mesh: ``Shard(i)`` on every mesh dimension that
shards tensor dimension i, ``Replicate()`` on the others.

Decode caches take the reference's cache rules by kind
(``kv_cache_spec``, ``ssm_state_spec``, ``batch_cache_spec``; by leaf
name, ``cache_spec``), and a decode step's cross-shard reductions run
as ``all_reduce_over``.

Parameter names are the port's (``groups.3.l0.attn.wq``) with ``.``
read as ``/``; the port keeps one tensor a group where the reference
stacks the groups on a leading axis, so a port spec is the reference's
without that leading ``None``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Sequence

import numpy as np
import torch

from repro_torch.sharding.graph import (GraphMesh, Replicated,
                                        batch_pad, check_mesh, divides,
                                        graph_mesh, mesh_size, replicate,
                                        shard_rows, shard_slots,
                                        single_device)

# logical axis -> preferred mesh axes (first match that exists wins; for
# composite entries every present axis is used).
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),       # data parallel over pod × data
    "fsdp": ("data",),              # ZeRO-3 parameter sharding
    "fsdp_pod": ("pod", "data"),
    "model": ("model",),            # TP: heads / ff / vocab
    "expert": ("model",),           # EP: expert dim of MoE weights
    "moe_fsdp": ("data",),          # ZeRO-3 on MoE weights specifically
    "moe_ff": (),                   # TP within expert (small-E MoE)
    "moe_cap": (),                  # capacity dim of dispatch buffers
    "kv_seq": ("data",),            # long-context decode: shard KV seq
    "none": (),
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without devices or processes:
    specs resolve against it as against a ``DeviceMesh`` of that shape."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


_CURRENT: list = []


@contextlib.contextmanager
def mesh_context(mesh):
    """Put ``mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``) in scope
    for spec resolution and ``shard``."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


@contextlib.contextmanager
def logical_rules(**over):
    """Temporarily override LOGICAL_RULES (perf experiments)."""
    old = {k: LOGICAL_RULES[k] for k in over}
    LOGICAL_RULES.update({k: tuple(v) for k, v in over.items()})
    try:
        yield
    finally:
        LOGICAL_RULES.update(old)


def current_mesh():
    """The mesh in scope, or None."""
    return _CURRENT[-1] if _CURRENT else None


def _mesh_axis_sizes() -> dict[str, int]:
    mesh = current_mesh()
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def resolve(logical: str | None, dim: int | None = None,
            used: set | None = None):
    """Logical name -> mesh axes tuple (or None), respecting presence,
    divisibility of ``dim``, and axes already used by other dims."""
    if logical is None or logical == "none":
        return None
    sizes = _mesh_axis_sizes()
    axes = [a for a in LOGICAL_RULES.get(logical, ()) if a in sizes
            and (used is None or a not in used)]
    if not axes:
        return None
    if dim is not None:
        total = 1
        kept = []
        for a in axes:
            if dim % (total * sizes[a]) == 0:
                kept.append(a)
                total *= sizes[a]
        axes = kept
    if not axes:
        return None
    if used is not None:
        used.update(axes)
    return tuple(axes) if len(axes) > 1 else axes[0]


def spec(*logical: str | None, dims: Sequence[int] | None = None) -> tuple:
    used: set = set()
    return tuple(resolve(name, None if dims is None else dims[i], used)
                 for i, name in enumerate(logical))


def axes_of(entry) -> tuple:
    """A spec entry's mesh axes: () for None, (name,) for one name."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def mesh_dims(mesh, entry) -> list:
    """The mesh dimensions of a spec entry's axes, in the entry's order."""
    return [mesh.mesh_dim_names.index(a) for a in axes_of(entry)]


def placements(sp: tuple, mesh) -> tuple:
    """DTensor placements of spec ``sp`` on ``mesh``: mesh dimension j
    is ``Shard(i)`` where entry i names its axis, else ``Replicate()``.
    Tensor dimension i split over several axes is split in mesh order
    (pod-major for ("pod", "data"), as the reference's)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for i, entry in enumerate(sp):
        for j in mesh_dims(mesh, entry):
            out[j] = Shard(i)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  None can exist before
    ``torch.distributed.tensor`` is imported, so a run without a mesh
    never pays for that import (seconds, on the first plain step)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_device(mesh) -> torch.device:
    """This process's device on ``mesh`` (a ``DeviceMesh``): the CPU, or
    the current CUDA device.  Without a CUDA runtime a CUDA mesh can only
    be the dry-run's, on the fake process group (``launch/dryrun.py``),
    whose fake tensors sit on ``cuda:0`` (``.to("cuda")`` would ask the
    absent runtime for its current device)."""
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", 0)


def place(x: torch.Tensor, mesh, sp: tuple, *,
          local: bool = False) -> torch.Tensor:
    """``x`` (a full tensor, or a DTensor on any mesh) as a DTensor on
    ``mesh`` with spec ``sp``; a full tensor is moved to the mesh's
    device first.  By default rank 0's ``x`` is sent to every process;
    ``local`` keeps each process's own chunk of its own ``x``, with no
    communication (the dry-run's fake tensors, alike on every
    process)."""
    from torch.distributed.tensor import distribute_tensor
    want = placements(sp, mesh)
    if is_dtensor(x):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, want)
        x = x.full_tensor()
    return distribute_tensor(x.to(mesh_device(mesh)), mesh, want,
                             src_data_rank=None if local else 0)


def gathered(w: torch.Tensor, dim: int, x: torch.Tensor) -> torch.Tensor:
    """Weight ``w`` with its dimension ``dim`` (its ZeRO-3 ``fsdp`` split)
    gathered for a product with activations ``x``, where ``x`` splits its
    batch (dimension 0) over every mesh dimension that splits ``w``
    there: as ZeRO-3 gathers a parameter for compute, each process then
    multiplies its own batch rows.  Left to DTensor's strategy, such a
    product whose activations are smaller than the weight gathers the
    activations instead and repeats the work on every process (ROADMAP
    C11).  Anything else (a plain tensor, a batch not split so) as it
    is."""
    if not (is_dtensor(w) and is_dtensor(x)):
        return w
    from torch.distributed.tensor import Replicate
    dim %= w.ndim
    split = [j for j, p in enumerate(w.placements)
             if p.is_shard(dim) and w.device_mesh.size(j) > 1]
    if not split or any(not x.placements[j].is_shard(0) for j in split):
        return w
    return w.redistribute(w.device_mesh, tuple(
        Replicate() if j in split else p
        for j, p in enumerate(w.placements)))


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Annotate an activation with logical axes: off a mesh a no-op; on
    a mesh ``x`` redistributed (a full tensor: distributed) to the
    resolved placements."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return place(x, mesh, spec(*logical, dims=x.shape))


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (a plain tensor every process computes alike: a rope
    table) as a replicated DTensor on ``ref``'s mesh where ``ref`` is a
    DTensor; else ``t``."""
    if current_mesh() is None or not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _SumForward(torch.autograd.Function):
    """The sum of ``x`` over ``groups``; the backward passes the gradient
    through unchanged (the sum is replicated over the groups, and each
    process differentiates its own part of it)."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        x = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, groups: list) -> torch.Tensor:
    """``x`` (a local tensor) summed over the process groups ``groups``
    in the forward; its gradient passed through unchanged."""
    return _SumForward.apply(x, groups) if groups else x


def grad_summed_over(x: torch.Tensor, groups: list) -> torch.Tensor:
    """``x`` (a local tensor) unchanged; its gradient summed over the
    process groups ``groups``: an input replicated over them that each
    process reads for its own part of a ``sum_over``."""
    return _SumGrad.apply(x, groups) if groups and x.requires_grad else x


def shard_index(mesh, axes: tuple) -> int:
    """This process's index along mesh axes ``axes`` taken together
    (the first the slowest), as DTensor splits a dimension over them."""
    i = 0
    for a in axes:
        i = i * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return i


def _partial_grad_dims(out_sp: tuple, in_sp: tuple, mesh) -> list:
    """The mesh dimensions (of more than one process) that split the
    output and not this input: there each process's gradient of the
    input is a part of the whole (a weight applied to its own batch
    rows, an input read by its own heads)."""
    out = {j for e in out_sp for j in mesh_dims(mesh, e)}
    inp = {j for e in in_sp for j in mesh_dims(mesh, e)}
    return sorted(j for j in out - inp if mesh.size(j) > 1)


def on_local_shards(fn, out_sp: tuple | list, in_sps: tuple, *args):
    """``fn`` on each process's shards of ``args`` (``local_map``): the
    inputs placed by the specs ``in_sps``, the output by ``out_sp`` (a
    list of specs: ``fn`` returns a tuple of as many tensors).  An
    input's gradient is summed over the mesh dimensions that split the
    output and not that input.  (DTensor's own ``Partial`` gradient
    placements are not used for this: a partial gradient that meets a
    redistribution's backward is taken as reduced without being
    summed.)"""
    from torch.distributed.tensor.experimental import local_map
    mesh = current_mesh()
    outs = out_sp if isinstance(out_sp, list) else [out_sp]
    split = tuple(e for sp in outs for e in sp)
    groups = [[mesh.get_group(j)
               for j in _partial_grad_dims(split, sp, mesh)]
              for sp in in_sps]

    def summed(*local):
        return fn(*(grad_summed_over(t, g) for t, g in zip(local, groups)))

    return local_map(summed, out_placements=tuple(placements(sp, mesh)
                                                  for sp in outs),
                     in_placements=tuple(placements(sp, mesh)
                                         for sp in in_sps),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def split_dims(t, dim: int) -> tuple[str, ...]:
    """The names of the mesh dimensions over which DTensor ``t`` splits
    its dimension ``dim``, in mesh order."""
    return tuple(t.device_mesh.mesh_dim_names[j]
                 for j, p in enumerate(t.placements) if p.is_shard(dim))


def local_range(t, dim: int) -> tuple[int, int]:
    """[lo, hi) of DTensor ``t``'s dimension ``dim`` that this process
    holds (an even split: ``resolve`` keeps only axes that divide)."""
    mesh = t.device_mesh
    axes = split_dims(t, dim)
    n = t.shape[dim] // math.prod(
        mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    lo = shard_index(mesh, axes) * n
    return lo, lo + n


def all_reduce_over(x: torch.Tensor, axes: tuple, op: str) -> torch.Tensor:
    """``x`` (a local tensor) reduced by ``op`` ("sum" or "max") over the
    processes of the mesh axes ``axes`` (one all-reduce a mesh
    dimension; both reductions compose over dimensions)."""
    import torch.distributed as dist
    mesh = current_mesh()
    x = x.contiguous().clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in axes:
        dist.all_reduce(x, op=red, group=mesh.get_group(a))
    return x


# ---------------------------------------------------------------------------
# Parameter specs by path rules
# ---------------------------------------------------------------------------

# (path-substring, logical names per dim). First match wins; matched
# against "/".join(path). Entries cover every param family in
# repro_torch/models. Stacked params of the reference get a leading None.
PARAM_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    ("embed/tok", ("model", "fsdp")),          # vocab × d
    ("embed/pos", (None, "fsdp")),
    ("embed/unembed", ("fsdp", "model")),
    ("attn/wq", ("fsdp", "model", None)),      # d × Hq × hd
    ("attn/wk", ("fsdp", "model", None)),
    ("attn/wv", ("fsdp", "model", None)),
    ("attn/wo", ("model", None, "fsdp")),      # Hq × hd × d
    ("moe/wg", ("fsdp", None)),                        # d × E router
    ("moe/w_gate", ("expert", "moe_fsdp", "moe_ff")),  # E × d × ff
    ("moe/w_up", ("expert", "moe_fsdp", "moe_ff")),
    ("moe/w_down", ("expert", "moe_ff", "moe_fsdp")),  # E × ff × d
    ("mlp/w_gate", ("fsdp", "model")),
    ("mlp/w_up", ("fsdp", "model")),
    ("mlp/w_down", ("model", "fsdp")),
    ("ssm/in_proj", ("fsdp", "model")),        # d × d_in_all
    ("ssm/out_proj", ("model", "fsdp")),       # d_inner × d
    ("ssm/conv", (None, "model")),             # width × channels
    ("ssm/", (None,)),                         # A_log, D, dt_bias, norm
    ("norm", (None,)),
]


def param_spec_for(path: str, shape: tuple[int, ...]) -> tuple:
    for sub, names in PARAM_RULES:
        if sub in path:
            # align rule names to trailing dims (leading scan dims None)
            k = len(names)
            if len(shape) >= k:
                lead = (None,) * (len(shape) - k)
                dims = shape[len(shape) - k:]
                used: set = set()
                parts = [resolve(n, d, used)
                         for n, d in zip(names, dims)]
                return (*lead, *parts)
            return (None,) * len(shape)
    return (None,) * len(shape)


def param_specs(tree) -> dict:
    """{leaf name: spec} for every leaf of ``tree`` (a module, a
    ``TrainState``, a dict; names as ``checkpoint.io.leaves`` gives
    them).  Call inside ``mesh_context`` so that divisibility is checked
    against the mesh."""
    from repro_torch.checkpoint.io import leaves
    return {name: param_spec_for(name.replace(".", "/"),
                                 tuple(np.shape(leaf)))
            for name, leaf in leaves(tree)}


# ---------------------------------------------------------------------------
# Decode cache specs
# ---------------------------------------------------------------------------

# The reference's ``launch/dryrun.py::cache_sharding`` rules, on its
# stacked shapes ``(groups,) + shape`` with the group entry dropped.  It
# sets the second stacked entry of every leaf of rank >= 2 by the batch
# rule, so a ``pos_map`` [cap] splits its cap over the ``batch`` axes
# where cap divides (ROADMAP C10, reproduced)


def batch_cache_spec(shape: tuple[int, ...]) -> tuple:
    """A decode cache leaf's first dimension over the ``batch`` axes
    where it divides: an SSM ``conv`` [B, W, C], a ``pos_map`` [cap]
    (C10) and the encdec's unstacked ``xk`` / ``xv``."""
    if not shape:
        return ()
    return (resolve("batch", shape[0]),) + (None,) * (len(shape) - 1)


def kv_cache_spec(shape: tuple[int, ...]) -> tuple:
    """A k / v cache [B, cap, H, D]: the batch over the ``batch`` axes
    where it divides, else the sequence over ``kv_seq``; the heads over
    ``model``."""
    dims = list(batch_cache_spec(shape))
    if dims[0] is None:
        dims[1] = resolve("kv_seq", shape[1])
    if len(shape) == 4:
        dims[2] = resolve("model", shape[2])
    return tuple(dims)


def ssm_state_spec(shape: tuple[int, ...]) -> tuple:
    """An SSM ``state`` [B, nh, P, N]: the batch over the ``batch`` axes
    where it divides, the heads over ``model``."""
    dims = list(batch_cache_spec(shape))
    if len(shape) == 4:
        dims[1] = resolve("model", shape[1])
    return tuple(dims)


def cache_spec(name: str, shape: tuple[int, ...]) -> tuple:
    """The spec of a decode cache leaf named ``name`` within its group
    (``l0/k``, ``l1/state``, ``self/pos_map``, ``xk``) of shape
    ``shape``, by the reference's suffix test: ``/k``, ``/v``, ``/xk``,
    ``/xv`` take ``kv_cache_spec``, ``/state`` ``ssm_state_spec``, any
    other ``batch_cache_spec`` (the reference's stacked encdec ``xk`` /
    ``xv`` paths have no ``/`` before them, so they take only the batch
    rule)."""
    if name.endswith(("/k", "/v", "/xk", "/xv")):
        return kv_cache_spec(shape)
    if name.endswith("/state"):
        return ssm_state_spec(shape)
    return batch_cache_spec(shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named_shardings(tree, mesh) -> dict:
    with mesh_context(mesh):
        specs = param_specs(tree)
    return {name: NamedSharding(mesh, s) for name, s in specs.items()}


__all__ = ["AbstractMesh", "GraphMesh", "LOGICAL_RULES", "NamedSharding",
           "PARAM_RULES", "Replicated", "axes_of", "batch_pad", "check_mesh",
           "all_reduce_over", "batch_cache_spec", "cache_spec",
           "current_mesh", "divides", "gathered", "graph_mesh",
           "kv_cache_spec",
           "local_range", "logical_rules", "mesh_context", "mesh_dims",
           "mesh_device", "mesh_size", "named_shardings", "on_local_shards",
           "param_spec_for", "param_specs", "place", "placements",
           "replicate", "replicated_like", "resolve", "shard",
           "shard_index", "shard_rows", "shard_slots", "single_device",
           "spec", "split_dims", "ssm_state_spec", "sum_over",
           "grad_summed_over"]
