"""Carry a store's state across from ``repro`` as plain numpy arrays.

``store_from_numpy`` builds this package's ``TemporalGraphStore`` from
what a ``repro`` ``TemporalGraphStore`` holds, exported as numpy (the
export itself lives with the caller — this package imports nothing of
``repro``).  The state dict holds:

* ``n_cap``, ``layout`` ("dense" | "edge"), ``t_cur``;
* the log columns ``op``/``u``/``v``/``slot``/``t`` (int32, unpadded);
* the slot registry ``eu``/``ev`` (int32, one entry per registered
  slot, in slot order);
* the current snapshot: ``nodes`` (bool[N]) with ``adj`` (bool[N, N])
  for the dense layout or ``emask`` (bool[>= #slots]) for the edge one;
* optionally the materialized anchors ``mat_times`` (int[K]),
  ``mat_nodes`` (bool[K, N]) and ``mat_adj`` (bool[K, N, N]).

The host legality mirrors are rebuilt by replaying the log (a legal
transition log by construction), and the log up to ``t_cur`` becomes
one sealed segment — segmentation never changes an answer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delta import ADD_EDGE, REM_EDGE, pow2_capacity
from repro_torch.core.graph import DenseGraph, EdgeGraph
from repro_torch.core.segments import Segment, build_merged_nodes
from repro_torch.core.store import TemporalGraphStore

_COLS = ("op", "u", "v", "slot", "t")


def store_from_numpy(state: dict, device="cuda") -> TemporalGraphStore:
    layout = str(state.get("layout", "dense"))
    n_cap = int(state["n_cap"])
    store = TemporalGraphStore(n_cap, layout=layout, device=device)
    dev = store.device
    cols = {c: np.ascontiguousarray(state[c], np.int32) for c in _COLS}
    t_cur = int(state["t_cur"])

    eu = np.asarray(state["eu"], np.int32)
    ev = np.asarray(state["ev"], np.int32)
    n_reg = int(eu.shape[0])
    store._eu_l = eu.tolist()
    store._ev_l = ev.tolist()
    store._edge_slots = {(int(a), int(b)): i
                         for i, (a, b) in enumerate(zip(eu, ev))}
    store._next_edge_slot = n_reg
    store._emask_l = [False] * n_reg
    for op, u, v, slot in zip(cols["op"].tolist(), cols["u"].tolist(),
                              cols["v"].tolist(), cols["slot"].tolist()):
        if not store._apply_host(op, u, v):
            raise ValueError(f"log is not a legal transition log at op "
                             f"({op}, {u}, {v})")
        if op in (ADD_EDGE, REM_EDGE):
            store._emask_l[slot] = op == ADD_EDGE

    k = int(np.searchsorted(cols["t"], t_cur, side="right"))
    if k:
        store._segments.append(Segment(*(cols[c][:k] for c in _COLS),
                                       device=dev))
        store._t_sealed = t_cur
        build_merged_nodes(store._segments, store._merged)
    store._op_l, store._u_l, store._v_l, store._slot_l, store._t_l = (
        cols[c][k:].tolist() for c in _COLS)
    store.t_cur = t_cur

    nodes = torch.from_numpy(np.array(state["nodes"], bool)).to(dev)
    if layout == "dense":
        store.current = DenseGraph(
            nodes=nodes,
            adj=torch.from_numpy(np.array(state["adj"], bool)).to(dev))
    else:
        e_cap = pow2_capacity(n_reg)
        pad = np.zeros((e_cap,), np.int32)
        emask = np.zeros((e_cap,), bool)
        src = np.asarray(state["emask"], bool)[:e_cap]
        emask[:src.shape[0]] = src

        def reg(x):
            out = pad.copy()
            out[:n_reg] = x
            return torch.from_numpy(out).to(dev)

        store.current = EdgeGraph(nodes=nodes, eu=reg(eu), ev=reg(ev),
                                  emask=torch.from_numpy(emask).to(dev),
                                  n_edges_reg=n_reg)
    for t, mn, ma in zip(state.get("mat_times", ()),
                         state.get("mat_nodes", ()),
                         state.get("mat_adj", ())):
        store.materialized.add(int(t), DenseGraph(
            nodes=torch.from_numpy(np.array(mn, bool)).to(dev),
            adj=torch.from_numpy(np.array(ma, bool)).to(dev)))
        store._t_last_mat = int(t)
    store._invalidate()
    return store
