"""Carry state across from ``repro`` as plain numpy arrays.

``lm_from_numpy`` builds the port's LM from a ``repro`` LM param tree
exported as numpy (see its docstring).

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

from repro_torch import resolve_device
from repro_torch.core.delta import ADD_EDGE, REM_EDGE, pow2_capacity
from repro_torch.core.graph import DenseGraph, EdgeGraph
from repro_torch.core.segments import Segment, build_merged_nodes
from repro_torch.core.store import TemporalGraphStore
from repro_torch.models import lm

_COLS = ("op", "u", "v", "slot", "t")


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor.  bfloat16 arrays (numpy has no such
    dtype; JAX exports ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) are recognised by name and item size
    and carried across bit for bit through an int16 view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def lm_from_numpy(params: dict, cfg, device="cuda"):
    """The port's LM (``repro_torch.models.lm.LM``) holding the weights
    of a ``repro`` LM param tree given as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``).  The leading group axis that
    the JAX package stacks its group params on is unstacked into the
    ``ModuleList``; every weight keeps its JAX layout and dtype.  Raises
    when a name or shape does not match."""
    dev = resolve_device(device)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, dev)
    flat = {}
    for name, a in _flatten(params):
        if name.startswith("groups."):
            rest = name[len("groups."):]
            for g in range(np.shape(a)[0]):
                flat[f"groups.{g}.{rest}"] = a[g]
        else:
            flat[name] = a
    own = dict(model.named_parameters())
    if set(own) != set(flat):
        raise ValueError(f"param names differ: missing "
                         f"{sorted(set(own) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(own))}")
    for name, p in own.items():
        t = _tensor(flat[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        p.data = t.to(dev)
    return model


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
