"""Graph measures used by historical queries (paper Table 1) — the
PyTorch mirror of ``repro.core.queries``.

Node-centric measures: degree, neighborhood, induced-subgraph stats,
k-core membership.  Global measures: diameter, connected components,
degree distribution, PageRank, triangle count, density.

On the dense layout, global measures are matrix products (BFS by
frontier expansion, components by label propagation, triangles by
trace(A³)).  Products run in full float32: they are exact on 0/1 and
small integer operands as long as counts stay below 2^24, which is why
TF32 must stay off (PyTorch's default for matmul).  Every float
finalization is the same f32 expression of the same integers as in
``repro``, so results are bit-identical to it.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import DenseGraph, EdgeGraph

I32 = torch.int32
F32 = torch.float32
INF = 0x3FFFFFFF

# ---------------------------------------------------------------------------
# Node-centric measures
# ---------------------------------------------------------------------------


def degree(g: DenseGraph, v) -> torch.Tensor:
    return g.degree(v)


def _one_hot(n: int, v, value, device) -> torch.Tensor:
    m = torch.zeros((n,), dtype=torch.bool, device=device)
    m[v] = value
    return m


def neighborhood_size(g: DenseGraph, v, hops: int = 2) -> torch.Tensor:
    """|{u : dist(v, u) ≤ hops}| − 1, via frontier matmuls."""
    reached = _one_hot(g.n_cap, v, True, g.device)
    frontier = reached
    adj_f = g.adj.to(F32)
    for _ in range(hops):
        nxt = (frontier.to(F32) @ adj_f) > 0
        frontier = nxt & ~reached
        reached = reached | nxt
    return reached.sum(dtype=I32) - 1


def induced_subgraph_mask(g: DenseGraph, v) -> torch.Tensor:
    """v plus its neighbors (the paper's induced-subgraph example)."""
    return g.adj[v] | _one_hot(g.n_cap, v, g.nodes[v], g.device)


def induced_avg_degree(g: DenseGraph, v) -> torch.Tensor:
    """Average degree of the subgraph induced by v and its neighbors —
    the paper's §3.2.3 multi-pass hybrid example."""
    sub = g.induced(induced_subgraph_mask(g, v))
    nn = torch.clamp(sub.num_nodes(), min=1)
    return (2.0 * sub.num_edges().to(F32)) / nn.to(F32)


def in_k_core(g: DenseGraph, v, k: int) -> torch.Tensor:
    """Whether v survives k-core peeling."""
    keep = g.nodes
    while True:
        deg = (g.adj & keep[None, :]).sum(dim=1)
        new = keep & (deg >= k) & g.nodes
        if not bool(torch.any(new != keep)):
            return new[v]
        keep = new


# ---------------------------------------------------------------------------
# Global measures
# ---------------------------------------------------------------------------


def num_nodes(g: DenseGraph):
    return g.num_nodes()


def num_edges(g: DenseGraph):
    return g.num_edges()


def _density(nn: torch.Tensor, ne: torch.Tensor) -> torch.Tensor:
    n = nn.to(F32)
    e = ne.to(F32)
    return torch.where(n > 1, 2.0 * e / (n * (n - 1.0)),
                       torch.zeros((), dtype=F32, device=n.device))


def _avg_degree(nn: torch.Tensor, ne: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(nn, min=1).to(F32)
    return 2.0 * ne.to(F32) / n


def density(g: DenseGraph) -> torch.Tensor:
    return _density(g.num_nodes(), g.num_edges())


def avg_degree(g: DenseGraph) -> torch.Tensor:
    return _avg_degree(g.num_nodes(), g.num_edges())


# Registered degree-distribution bin count: degrees past the last bin
# clip into it, so the histogram shape is static at any graph size.
DEGREE_DIST_BINS = 64


def _degree_histogram(deg: torch.Tensor, nodes: torch.Tensor,
                      max_deg: int) -> torch.Tensor:
    """Validity-weighted degree bincount, bins [0, max_deg] with
    overflow clipped into the last bin.  Shared by BOTH layouts (and the
    sweep), so the histogram arithmetic lives in one place.  ``deg`` and
    ``nodes`` may carry leading batch dimensions."""
    deg = torch.clamp(deg, 0, max_deg).to(torch.int64)
    w = nodes.to(I32)
    lead = deg.shape[:-1]
    out = torch.zeros(lead + (max_deg + 1,), dtype=I32, device=deg.device)
    return out.scatter_add_(-1, deg, w)


def degree_distribution(g: DenseGraph,
                        max_deg: int = DEGREE_DIST_BINS) -> torch.Tensor:
    """Histogram of degrees over valid nodes, bins [0, max_deg]."""
    return _degree_histogram(g.degrees(), g.nodes, max_deg)


def connected_components(g: DenseGraph, max_iters: int = 64) -> torch.Tensor:
    """Component labels via min-label propagation."""
    n = g.n_cap
    inf = torch.full((), INF, dtype=I32, device=g.device)
    labels = torch.where(g.nodes, torch.arange(n, dtype=I32,
                                               device=g.device), inf)
    for _ in range(max_iters):
        neigh = torch.where(g.adj, labels[None, :], inf)
        new = torch.minimum(labels, neigh.min(dim=1).values)
        new = torch.where(g.nodes, new, inf)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels


def num_components(g: DenseGraph) -> torch.Tensor:
    labels = connected_components(g)
    own = labels == torch.arange(g.n_cap, dtype=I32, device=g.device)
    return (own & g.nodes).sum(dtype=I32)


def diameter(g: DenseGraph, num_sources: int = 0,
             max_iters: int = 64) -> torch.Tensor:
    """(Estimated) diameter via multi-source BFS frontier matmuls.

    ``num_sources == 0`` → exact: BFS from every node.  Unreachable pairs
    are ignored (per-component eccentricity).
    """
    n = g.n_cap
    dev = g.device
    if num_sources and num_sources < n:
        src = torch.linspace(0, n - 1, num_sources, device=dev).to(I32)
    else:
        src = torch.arange(n, dtype=I32, device=dev)
    s = src.shape[0]
    src_l = src.to(torch.int64)
    reached = torch.zeros((s, n), dtype=torch.bool, device=dev)
    reached[torch.arange(s, device=dev), src_l] = g.nodes[src_l]
    inf = torch.full((), INF, dtype=I32, device=dev)
    dist = torch.where(reached, torch.zeros((), dtype=I32, device=dev), inf)
    adj_f = g.adj.to(F32)
    d = 0
    while d < max_iters:
        nxt = (reached.to(F32) @ adj_f) > 0
        new = nxt & ~reached
        dist = torch.where(new, torch.full((), d + 1, dtype=I32,
                                           device=dev), dist)
        reached = reached | new
        d += 1
        if not bool(torch.any(new)):
            break
    dist = torch.where(dist >= INF, torch.full((), -1, dtype=I32,
                                               device=dev), dist)
    ecc = dist.max(dim=1).values
    ecc = torch.where(g.nodes[src_l], ecc,
                      torch.full((), -1, dtype=I32, device=dev))
    return ecc.max()


def triangle_count(g: DenseGraph) -> torch.Tensor:
    a = g.adj.to(F32)
    return (torch.trace(a @ a @ a) / 6.0).to(I32)


def pagerank(g: DenseGraph, iters: int = 20, damp: float = 0.85):
    """Power iteration on the degree-normalized adjacency."""
    n_valid = torch.clamp(g.num_nodes(), min=1).to(F32)
    deg = torch.clamp(g.degrees().to(F32), min=1.0)
    a = g.adj.to(F32) / deg[:, None]
    zero = torch.zeros((), dtype=F32, device=g.device)
    r = torch.where(g.nodes, 1.0 / n_valid, zero)
    for _ in range(iters):
        r2 = damp * (r @ a) + (1.0 - damp) / n_valid
        r = torch.where(g.nodes, r2, zero)
    return r


# Registry: name -> fn. Node-centric fns take (g, v).
NODE_MEASURES = {
    "degree": degree,
    "neighborhood2": neighborhood_size,
    "induced_avg_degree": induced_avg_degree,
}
GLOBAL_MEASURES = {
    "num_nodes": num_nodes,
    "num_edges": num_edges,
    "density": density,
    "avg_degree": avg_degree,
    "num_components": num_components,
    "diameter": diameter,
    "triangles": triangle_count,
    "degree_distribution": degree_distribution,
}


# ---------------------------------------------------------------------------
# Edge-slot-layout measures (segment reductions — O(E + N), no N² state)
# ---------------------------------------------------------------------------
#
# Each mirrors the dense measure's arithmetic exactly: the integer
# counts are the same values, and the float finalizations the same f32
# expressions, so edge-layout results bit-match the dense layout.


def edge_degree(g: EdgeGraph, v) -> torch.Tensor:
    return g.degree(v)


def edge_num_nodes(g: EdgeGraph) -> torch.Tensor:
    return g.num_nodes()


def edge_num_edges(g: EdgeGraph) -> torch.Tensor:
    # slots hold each undirected edge once — the popcount equals the
    # dense sum(adj) // 2 exactly
    return g.num_edges()


def edge_density(g: EdgeGraph) -> torch.Tensor:
    return _density(g.num_nodes(), g.num_edges())


def edge_avg_degree(g: EdgeGraph) -> torch.Tensor:
    return _avg_degree(g.num_nodes(), g.num_edges())


def edge_degree_distribution(g: EdgeGraph,
                             max_deg: int = DEGREE_DIST_BINS) -> torch.Tensor:
    """Degree histogram without the N² adjacency: the shared bincount
    over the slot-registry degrees."""
    return _degree_histogram(g.degrees(), g.nodes, max_deg)


EDGE_NODE_MEASURES = {
    "degree": edge_degree,
}
EDGE_GLOBAL_MEASURES = {
    "num_nodes": edge_num_nodes,
    "num_edges": edge_num_edges,
    "density": edge_density,
    "avg_degree": edge_avg_degree,
    "degree_distribution": edge_degree_distribution,
}


def edge_supported(measure: str, scope: str) -> bool:
    """True iff the measure has an edge-slot-layout implementation."""
    table = EDGE_NODE_MEASURES if scope == "node" else EDGE_GLOBAL_MEASURES
    return measure in table
