"""Mesh and placement helpers for the multi-device graph engine — the
PyTorch mirror of ``repro.sharding.graph``.

The graph engine uses ONE 1-D mesh whose single axis plays a different
role per (plan, anchor) group (``core/distributed.py``):

* hybrid / delta-only groups — the axis splits the *padded query batch*
  (graph + delta replicated on every device, queries split),
* two-phase groups — the axis splits the *adjacency rows* (dense) or
  the *edge slots* (edge layout): queries replicated, each device runs
  the LWW kernel on its own block, measures summed as integer partials.

One process drives the whole mesh, as in the reference: a
``GraphMesh`` is a tuple of ``torch.device``s, each shard a tensor of
its own on its device, and the reference's collectives become copies
and adds on the host's side of the card(s).  A device may appear more
than once — ``graph_mesh([cuda:0] * 4)`` shards four ways on one card,
the counterpart of the reference's forced host devices on one CPU.

Everything here is placement plumbing: it computes nothing.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class GraphMesh:
    """A 1-D mesh: the devices, in axis order.  Frozen and compared by
    value, so equal meshes key the engine's placement caches alike."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where sharded results are combined and returned."""
        return self.devices[0]


def graph_mesh(devices=None) -> GraphMesh:
    """The 1-D graph-engine mesh over every visible CUDA device, or over
    ``devices`` (names or ``torch.device``s; repeats allowed)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("graph_mesh() names the CUDA devices and "
                               "none is present; pass devices=[...]")
        devices = [torch.device("cuda", i) for i in range(n)]
    return GraphMesh(tuple(devices))


def mesh_size(mesh: GraphMesh | None) -> int:
    return 1 if mesh is None else mesh.size


def single_device(mesh: GraphMesh | None) -> bool:
    """True when there is nothing to shard over: the ordinary
    single-device path runs."""
    return mesh_size(mesh) <= 1


def batch_pad(b: int, n_dev: int) -> int:
    """Padded batch size: the per-device slice rounded up to a power of
    two, times the device count (so the batch splits evenly)."""
    per = max(1, math.ceil(b / max(n_dev, 1)))
    per = 1 << math.ceil(math.log2(per))
    return per * n_dev


def divides(length: int, n_dev: int) -> bool:
    """Whether an axis of ``length`` (node or slot capacity) splits
    evenly over ``n_dev`` devices — what row and slot sharding need."""
    return length > 0 and length % n_dev == 0


def check_mesh(mesh: GraphMesh, device) -> None:
    """Refuse a mesh whose devices are not all of ``device``'s type: a
    store on the card is served by CUDA devices only (no shard falls
    back to the CPU), a CPU store by CPU devices only."""
    kind = torch.device(device).type
    bad = [str(d) for d in mesh.devices if d.type != kind]
    if bad:
        raise ValueError(f"the state lives on {kind} but the mesh names "
                         f"{bad}: every mesh device must be a {kind} "
                         "device")


def tree_map(fn, tree):
    """``fn`` on every tensor of a snapshot / delta / index dataclass (or
    a tuple of them); every other field is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def put(tree, device):
    """A copy of ``tree`` of its own on ``device`` (a copy even where
    the tensors already live there)."""
    return tree_map(lambda x: x.to(device, copy=True), tree)


class Replicated(tuple):
    """One copy of a tree per mesh device, in mesh order."""


def replicate(tree, mesh: GraphMesh) -> Replicated:
    """A copy of ``tree`` on every mesh device."""
    return Replicated(put(tree, d) for d in mesh.devices)


def _split(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    if not divides(x.shape[0], n):
        raise ValueError(f"an axis of {x.shape[0]} does not split over "
                         f"{n} devices")
    w = x.shape[0] // n
    return x[i * w:(i + 1) * w]


def shard_rows(tree, mesh: GraphMesh) -> tuple:
    """Per device, the leading-axis block of every tensor of ``tree``
    (node mask [N] → [N/D], adjacency [N, N] → [N/D, N]); block i holds
    rows [i·N/D, (i+1)·N/D)."""
    n = mesh.size
    return tuple(tree_map(lambda x: _split(x, i, n).to(d, copy=True), tree)
                 for i, d in enumerate(mesh.devices))


def shard_slots(g, mesh: GraphMesh) -> tuple:
    """Per device, an edge-layout snapshot with its slot-sized fields
    (``eu``, ``ev``, ``emask``) cut to the device's block and the node
    mask replicated; block i holds slots [i·E/D, (i+1)·E/D).  The 1-D
    analogue of ``shard_rows`` for ``core.distributed.two_phase_slots``.
    ``n_edges_reg`` stays the global count."""
    n = mesh.size
    return tuple(dataclasses.replace(
        g, nodes=g.nodes.to(d, copy=True),
        eu=_split(g.eu, i, n).to(d, copy=True),
        ev=_split(g.ev, i, n).to(d, copy=True),
        emask=_split(g.emask, i, n).to(d, copy=True))
        for i, d in enumerate(mesh.devices))
