"""Synthetic evolving scale-free graphs.

The paper's evaluation generates successive scale-free snapshots with
the method of [11] (Ren et al.), which extends Barabási–Albert [1] with
edge removals between versions.  We mirror that: preferential-attachment
node arrivals (classic endpoint-list sampling), extra preferential
edges, and random edge removals, all emitted as a time-annotated op
stream.

``paper_table3`` reproduces the dataset statistics of the paper's
Table 3 (5,063 inserted nodes / 41,067 inserted edges / 18,280 removed
edges / 64,410 ops, ±stochastic variation).  ``generate_ops`` draws
from a numpy generator, so one seed gives this package and ``repro``
the same op list.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.delta import ADD_EDGE, ADD_NODE, REM_EDGE, REM_NODE
from repro_torch.core.store import Op, TemporalGraphStore


@dataclasses.dataclass
class EvolutionParams:
    n_seed: int = 4            # seed clique size
    m_attach: int = 4          # preferential edges per new node
    lam_extra: float = 0.5     # Poisson rate: extra pref. edges / arrival
    lam_remove: float = 0.5    # Poisson rate: edge removals / arrival
    p_remove_node: float = 0.0  # node removal probability / arrival
    events_per_unit: int = 8   # events per time unit


def generate_ops(num_nodes: int, params: EvolutionParams,
                 seed: int = 0) -> list[Op]:
    rng = np.random.default_rng(seed)
    ops: list[Op] = []
    endpoints: list[int] = []          # degree-proportional sampling pool
    edge_list: list[tuple[int, int]] = []
    edge_pos: dict[tuple[int, int], int] = {}
    removed_nodes: set[int] = set()
    t = 1
    ev = 0

    def tick():
        nonlocal t, ev
        ev += 1
        if ev % params.events_per_unit == 0:
            t += 1

    def add_edge(a: int, b: int) -> bool:
        if a == b or a in removed_nodes or b in removed_nodes:
            return False
        key = (a, b) if a < b else (b, a)
        if key in edge_pos:
            return False
        edge_pos[key] = len(edge_list)
        edge_list.append(key)
        endpoints.append(a)
        endpoints.append(b)
        ops.append(Op(ADD_EDGE, key[0], key[1], t))
        return True

    def remove_edge(key: tuple[int, int]):
        pos = edge_pos.pop(key)
        last = edge_list[-1]
        edge_list[pos] = last
        edge_list.pop()
        if last != key:
            edge_pos[last] = pos
        # lazy removal from the endpoint pool: mark via counter dict
        ops.append(Op(REM_EDGE, key[0], key[1], t))

    def pick_pref(exclude: int, upper: int) -> int:
        # degree-proportional (endpoint list) with uniform smoothing
        for _ in range(8):
            if endpoints and rng.random() < 0.9:
                c = endpoints[int(rng.integers(len(endpoints)))]
            else:
                c = int(rng.integers(upper))
            if c != exclude and c not in removed_nodes:
                return c
        return exclude  # degenerate; add_edge will reject

    # seed clique
    for i in range(params.n_seed):
        ops.append(Op(ADD_NODE, i, i, t))
    for i in range(params.n_seed):
        for j in range(i + 1, params.n_seed):
            add_edge(i, j)
    tick()

    for nid in range(params.n_seed, num_nodes):
        ops.append(Op(ADD_NODE, nid, nid, t))
        for _ in range(params.m_attach):
            add_edge(nid, pick_pref(nid, nid))
        tick()
        for _ in range(rng.poisson(params.lam_extra)):
            a = pick_pref(-1, nid + 1)
            add_edge(a, pick_pref(a, nid + 1))
            tick()
        for _ in range(rng.poisson(params.lam_remove)):
            if not edge_list:
                break
            remove_edge(edge_list[int(rng.integers(len(edge_list)))])
            tick()
        if (params.p_remove_node > 0
                and rng.random() < params.p_remove_node and nid > 16):
            victim = int(rng.integers(nid))
            if victim not in removed_nodes:
                for key in [k for k in edge_list if victim in k]:
                    remove_edge(key)
                removed_nodes.add(victim)
                ops.append(Op(REM_NODE, victim, victim, t))
                tick()
    return ops


def build_store(num_nodes: int, params: EvolutionParams | None = None,
                seed: int = 0, n_cap: int | None = None,
                policy=None, layout: str = "dense",
                device="cuda") -> TemporalGraphStore:
    params = params or EvolutionParams()
    ops = generate_ops(num_nodes, params, seed)
    n_cap = n_cap or num_nodes
    store = TemporalGraphStore(n_cap=n_cap, policy=policy, layout=layout,
                               device=device)
    t_max = max(o.t for o in ops)
    store.ingest(ops)
    store.advance_to(t_max)
    return store


def paper_table3(seed: int = 7, **store_kw) -> TemporalGraphStore:
    """Dataset matching the characteristics of the paper's Table 3."""
    params = EvolutionParams(m_attach=6, lam_extra=2.2, lam_remove=3.61,
                             p_remove_node=0.0, events_per_unit=8)
    return build_store(5063, params, seed=seed, **store_kw)
