"""Graph snapshots (paper Definition 1) in two layouts — the PyTorch
mirror of ``repro.core.graph``.

* ``DenseGraph`` — node-validity mask ``bool[N]`` + adjacency bitmask
  ``bool[N, N]``.  Global measures become matrix products.

* ``EdgeGraph`` — persistent edge registry ``(eu, ev)[E]`` + validity
  masks.  Reconstruction scatters over 1-D edge slots; measures are
  segment reductions, O(E + N).

Both are immutable dataclasses of tensors; "applying" a delta produces
a new snapshot.  A snapshot may carry a leading batch dimension
(``nodes[Q, N]``, ``adj[Q, N, N]`` / ``emask[Q, E]``) where the engine
reconstructs several times at once — ``take(i)`` selects one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """SG_t as node mask + dense symmetric adjacency."""

    nodes: torch.Tensor  # bool[N]
    adj: torch.Tensor    # bool[N, N], symmetric, zero diagonal

    @property
    def n_cap(self) -> int:
        return self.nodes.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def take(self, i) -> "DenseGraph":
        return DenseGraph(nodes=self.nodes[i], adj=self.adj[i])

    def num_nodes(self) -> torch.Tensor:
        return self.nodes.sum(dtype=I32)

    def num_edges(self) -> torch.Tensor:
        return torch.div(self.adj.sum(dtype=I32), 2, rounding_mode="floor")

    def degrees(self) -> torch.Tensor:
        """Degree of every node (0 for invalid nodes)."""
        return self.adj.sum(dim=-1, dtype=I32)

    def degree(self, v) -> torch.Tensor:
        return self.adj[v].sum(dtype=I32)

    def induced(self, node_mask: torch.Tensor) -> "DenseGraph":
        m = node_mask & self.nodes
        return DenseGraph(nodes=m, adj=self.adj & m[:, None] & m[None, :])

    def validate(self) -> torch.Tensor:
        """True iff structurally consistent (edges only between valid
        nodes, symmetric, zero diagonal)."""
        ok_sym = torch.equal(self.adj, self.adj.T)
        ok_diag = not bool(torch.diagonal(self.adj).any())
        live = self.nodes[:, None] & self.nodes[None, :]
        ok_live = not bool((self.adj & ~live).any())
        return torch.tensor(ok_sym and ok_diag and ok_live)


@dataclasses.dataclass(frozen=True)
class EdgeGraph:
    """SG_t as a persistent edge registry + validity masks.

    ``eu/ev`` are fixed once an edge slot is registered (host side); only
    the masks evolve.  Slots past ``n_edges_reg`` are unregistered.
    ``n_edges_reg`` is a host int.
    """

    nodes: torch.Tensor   # bool[N]
    eu: torch.Tensor      # i32[E] — endpoint 1 per registered edge slot
    ev: torch.Tensor      # i32[E] — endpoint 2
    emask: torch.Tensor   # bool[E] — edge validity
    n_edges_reg: int      # number of registered slots

    @property
    def n_cap(self) -> int:
        return self.nodes.shape[-1]

    @property
    def e_cap(self) -> int:
        return self.eu.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def take(self, i) -> "EdgeGraph":
        return dataclasses.replace(self, nodes=self.nodes[i],
                                   emask=self.emask[i])

    def reg_mask(self) -> torch.Tensor:
        return torch.arange(self.e_cap, device=self.device) < self.n_edges_reg

    def live_edges(self) -> torch.Tensor:
        return self.emask & self.reg_mask()

    def num_nodes(self) -> torch.Tensor:
        return self.nodes.sum(dtype=I32)

    def num_edges(self) -> torch.Tensor:
        return self.live_edges().sum(dtype=I32)

    def degrees(self) -> torch.Tensor:
        """Degree of every node — a segment-sum over edge endpoints
        (O(E + N), the edge-layout replacement for the dense row sum)."""
        ones = self.live_edges().to(I32)
        deg = torch.zeros((self.n_cap,), dtype=I32, device=self.device)
        deg.index_add_(0, self.eu, ones)
        deg.index_add_(0, self.ev, ones)
        return deg

    def degree(self, v) -> torch.Tensor:
        touch = ((self.eu == v) | (self.ev == v)) & self.live_edges()
        return touch.sum(dtype=I32)

    def to_dense(self) -> DenseGraph:
        n = self.n_cap
        adj = torch.zeros((n, n), dtype=torch.bool, device=self.device)
        live = self.live_edges()
        adj[self.eu[live], self.ev[live]] = True
        adj[self.ev[live], self.eu[live]] = True
        return DenseGraph(nodes=self.nodes, adj=adj)

    def with_registry_of(self, other: "EdgeGraph") -> "EdgeGraph":
        """This snapshot's state re-expressed over ``other``'s (equal
        or larger, append-only-grown) slot registry.  Slots registered
        after this snapshot's time keep emask=False, which is exactly
        their state then."""
        emask = torch.zeros((other.e_cap,), dtype=torch.bool,
                            device=self.device)
        emask[:self.e_cap] = self.emask
        return EdgeGraph(nodes=self.nodes, eu=other.eu, ev=other.ev,
                         emask=emask, n_edges_reg=other.n_edges_reg)


def empty_dense(n_cap: int, device="cuda") -> DenseGraph:
    return DenseGraph(
        nodes=torch.zeros((n_cap,), dtype=torch.bool, device=device),
        adj=torch.zeros((n_cap, n_cap), dtype=torch.bool, device=device))


def empty_edge(n_cap: int, e_cap: int, device="cuda") -> EdgeGraph:
    return EdgeGraph(
        nodes=torch.zeros((n_cap,), dtype=torch.bool, device=device),
        eu=torch.zeros((e_cap,), dtype=I32, device=device),
        ev=torch.zeros((e_cap,), dtype=I32, device=device),
        emask=torch.zeros((e_cap,), dtype=torch.bool, device=device),
        n_edges_reg=0)


def dense_to_edge(g: DenseGraph, registry: EdgeGraph) -> EdgeGraph:
    """Re-express a dense snapshot in edge-slot layout over an existing
    slot ``registry``: ``emask[s] = adj[eu[s], ev[s]]`` for registered
    slots — exact for any snapshot, since slots are append-only."""
    emask = (g.adj[registry.eu.long(), registry.ev.long()]
             & registry.reg_mask())
    return EdgeGraph(nodes=g.nodes, eu=registry.eu, ev=registry.ev,
                     emask=emask, n_edges_reg=registry.n_edges_reg)


def edge_to_dense(g: EdgeGraph) -> DenseGraph:
    """Inverse of ``dense_to_edge`` (alias of ``EdgeGraph.to_dense``)."""
    return g.to_dense()


def dense_from_numpy(nodes, edges, n_cap: int | None = None,
                     device="cuda") -> DenseGraph:
    """A ``DenseGraph`` on ``device`` from a host node mask and a list of
    ``(a, b)`` edges (both directions set, no self-loops), padded to
    ``n_cap`` nodes."""
    from repro_torch import resolve_device
    nodes = np.asarray(nodes, bool)
    n = n_cap or nodes.shape[0]
    mask = np.zeros((n,), bool)
    mask[:nodes.shape[0]] = nodes
    adj = np.zeros((n, n), bool)
    for (a, b) in edges:
        adj[a, b] = adj[b, a] = True
    np.fill_diagonal(adj, False)
    dev = resolve_device(device)
    return DenseGraph(nodes=torch.from_numpy(mask).to(dev),
                      adj=torch.from_numpy(adj).to(dev))
