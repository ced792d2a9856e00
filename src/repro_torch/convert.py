"""Carry state across from ``repro`` as plain numpy arrays.

``lm_from_numpy`` builds the port's model (an ``LM``, or an ``EncDec``
for the encdec family) from a ``repro`` param tree exported as numpy
(see its docstring); ``train_state_from_numpy`` the port's
``TrainState`` from a ``repro`` one; ``caches_from_numpy`` /
``caches_to_numpy`` carry decode caches across, both ways (the JAX
package stacks them by group, the port keeps a dict a group).  ``arrays_from_reference`` /
``arrays_to_reference`` map a checkpoint's named arrays between the
JAX package's tree-path names (an LM's groups, an encoder-decoder's
encoder and decoder layers, each stacked on one axis:
``optim.adamw.STACKED``) and the port's (``checkpoint/io.py``), both
ways.

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

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.delta import ADD_EDGE, REM_EDGE, pow2_capacity
from repro_torch.core.graph import DenseGraph, EdgeGraph
from repro_torch.core.segments import Segment, build_merged_nodes
from repro_torch.core.store import TemporalGraphStore
from repro_torch.models import api
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache
from repro_torch.optim.adamw import STACKED

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
    """The port's model (``models.lm.LM``; ``models.encdec.EncDec`` for
    the encdec family) holding the weights of a ``repro`` param tree
    given as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
    params)``).  The leading axis that the JAX package stacks its groups
    (an encoder-decoder: its encoder and decoder layers) on is unstacked
    into the ``ModuleList``; every weight keeps its JAX layout and dtype
    (a MoE layer's ``moe.{wg, w_up, w_gate, w_down}``: the router
    float32, the experts stacked on their leading axis; a vlm's
    ``patch_proj``).  Raises when a name or shape does not match."""
    dev = resolve_device(device)
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    flat = _unstack(dict(_flatten(params)))
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


def _unstack(flat: dict) -> dict:
    """``<stack>.<rest>`` stacked on a leading axis → ``<stack>.<i>.<rest>``,
    one entry per slice, for each prefix of ``STACKED``."""
    out = {}
    for name, a in flat.items():
        stack, _, rest = name.partition(".")
        if stack in STACKED:
            for g in range(np.shape(a)[0]):
                out[f"{stack}.{g}.{rest}"] = a[g]
        else:
            out[name] = a
    return out


def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def train_state_from_numpy(state, cfg, device="cuda"):
    """The port's ``TrainState`` holding a ``repro`` ``TrainState``
    exported as numpy (``jax.tree.map(np.asarray, state)``): params
    through ``lm_from_numpy``, the ``AdamWState``'s m / v (arrays, or
    ``QTensor``s of ``q`` and ``scale``) unstacked by group or layer
    under the port's parameter names, each slice's ``QTensor`` keeping
    the stacked leaf's one scale, and the step counters as ints.
    ``state`` and its parts may be objects or dicts with those field
    names."""
    from repro_torch.optim.adamw import AdamWState, QTensor
    from repro_torch.runtime.steps import TrainState
    dev = resolve_device(device)
    params = lm_from_numpy(_field(state, "params"), cfg, device=dev)
    names = [n for n, _ in params.named_parameters()]
    opt = _field(state, "opt")

    def moments(tree):
        out = {}
        for name, leaf in _flatten(tree):
            qt = hasattr(leaf, "q") and hasattr(leaf, "scale")
            arr = np.asarray(leaf.q if qt else leaf)
            for n, a in _unstack({name: arr}).items():
                out[n] = (QTensor(q=_tensor(a).to(dev),
                                  scale=_tensor(leaf.scale).to(dev))
                          if qt else _tensor(a).to(dev))
        if set(out) != set(names):
            raise ValueError("optimizer state names differ from the "
                             "params'")
        return {n: out[n] for n in names}

    return TrainState(
        params=params,
        opt=AdamWState(step=int(_field(opt, "step")),
                       m=moments(_field(opt, "m")),
                       v=moments(_field(opt, "v"))),
        step=int(_field(state, "step")))


# ---------------------------------------------------------------------------
# decode caches: the JAX package's stacked caches <-> the port's per group

def _cache_kind(entry):
    """(class, fields) of a cache entry (``KVCache``, ``SSMCache``) by
    its fields, or None for a plain array (an encdec layer's ``xk`` /
    ``xv``)."""
    for cls in (KVCache, SSMCache):
        names = tuple(f.name for f in dataclasses.fields(cls))
        if all(n in entry if isinstance(entry, dict) else hasattr(entry, n)
               for n in names):
            return cls, names
    return None


def caches_from_numpy(caches: dict, device="cuda") -> list[dict]:
    """The port's decode caches (one dict a group, or a decoder layer,
    as ``models.api.prefill`` returns them) holding the JAX package's
    stacked caches exported as numpy (``jax.tree.map(np.asarray,
    caches)``): a dict of name → ``KVCache`` (k, v, pos_map) or
    ``SSMCache`` (conv, state), as objects or dicts with those fields,
    or → an array (an encdec layer's ``xk`` / ``xv``), each stacked on a
    leading axis of groups.  dtypes are kept (bfloat16 bit for bit)."""
    dev = resolve_device(device)

    def one(a, g):
        return _tensor(np.asarray(a)[g]).to(dev)

    first = next(iter(caches.values()))
    kind = _cache_kind(first)
    n = np.shape(_field(first, kind[1][0]) if kind else first)[0]
    out = []
    for g in range(n):
        group = {}
        for name, entry in caches.items():
            kind = _cache_kind(entry)
            group[name] = (one(entry, g) if kind is None else kind[0](
                *(one(_field(entry, f), g) for f in kind[1])))
        out.append(group)
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor (a DTensor: gathered) as numpy; bfloat16 as float32,
    which holds every bfloat16 value exactly."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def caches_to_numpy(caches: list[dict]) -> dict:
    """The inverse of ``caches_from_numpy``: the port's decode caches
    (DTensors gathered) as the JAX package stacks them, name → {field:
    array} for a ``KVCache`` / ``SSMCache`` or name → array, each array
    the groups' tensors stacked on a leading axis (bfloat16 as
    float32)."""
    out = {}
    for name, entry in caches[0].items():
        kind = _cache_kind(entry)
        if kind is None:
            out[name] = np.stack([_host(c[name]) for c in caches])
        else:
            out[name] = {f: np.stack([_host(getattr(c[name], f))
                                      for c in caches]) for f in kind[1]}
    return out


# ---------------------------------------------------------------------------
# checkpoint names: the JAX package's tree paths <-> the port's


_BF16 = "::bf16"
_MOMENTS = (("params",), ("opt", "m"), ("opt", "v"))


def arrays_from_reference(raw: dict) -> dict:
    """A checkpoint's npz entries named as the JAX package names a
    ``TrainState``'s leaves (``.params/groups/l0/attn/wq``,
    ``.opt/.m/embed/tok/.q``, ``.opt/.step``, ``.step``; ``::bf16``
    kept), renamed to the port's (``params/groups.0.l0.attn.wq``,
    ``opt/m/embed.tok/q``, ``opt/step``, ``step``) with every slice of a
    stacked leaf (``STACKED``: ``groups``, ``enc``, ``dec``) its own
    entry, a stacked ``QTensor``'s scale repeated for each.  Names of
    other trees (plain dicts) pass through."""
    out = {}
    for key, a in raw.items():
        base, suf = (key[:-len(_BF16)], _BF16) if key.endswith(_BF16) \
            else (key, "")
        segs = base.split("/")
        plain = [s.lstrip(".") for s in segs]
        head = next((h for h in _MOMENTS
                     if tuple(plain[:len(h)]) == h), None)
        if head is None:
            out["/".join(plain) + suf] = a
            continue
        rest = plain[len(head):]
        field = None
        if segs[-1] in (".q", ".scale"):
            field, rest = rest[-1], rest[:-1]
        groups = [None]
        if rest[0] in STACKED:
            stacked = a
            if field == "scale":
                stacked = raw[base[:-len(".scale")] + ".q"]
            groups = range(stacked.shape[0])
        for g in groups:
            name = ".".join(rest if g is None
                            else [rest[0], str(g)] + rest[1:])
            val = a if g is None or field == "scale" else a[g]
            out["/".join([*head, name] + ([field] if field else []))
                + suf] = np.array(val)
    return out


def arrays_to_reference(raw: dict) -> dict:
    """The inverse of ``arrays_from_reference``: the port's npz entries
    of a ``TrainState`` renamed to the JAX package's tree paths, the
    slices' entries stacked in order.  A stacked ``QTensor`` has one
    scale, so its slices' scales must be equal (they are for a state
    carried over from the JAX package and after any port step: the
    optimizer quantizes a stacked leaf's slices against one absmax);
    raises otherwise."""
    out, stacks = {}, {}
    for key, a in raw.items():
        base, suf = (key[:-len(_BF16)], _BF16) if key.endswith(_BF16) \
            else (key, "")
        segs = base.split("/")
        head = next((h for h in _MOMENTS
                     if tuple(segs[:len(h)]) == h), None)
        if head is None:
            if segs in (["step"], ["opt", "step"]):
                base = "/".join("." + s for s in segs)
            out[base + suf] = a
            continue
        rest = segs[len(head):]
        field = rest[1] if len(rest) == 2 else None
        parts = rest[0].split(".")
        dotted = ["." + h for h in head]
        tail = ["." + field] if field else []
        if parts[0] in STACKED:
            ref = "/".join(dotted + parts[:1] + parts[2:] + tail) + suf
            stacks.setdefault(ref, {})[int(parts[1])] = a
        else:
            out["/".join(dotted + parts + tail) + suf] = a
    for ref, by_group in stacks.items():
        parts = [by_group[g] for g in sorted(by_group)]
        if ref.endswith("/.scale"):
            if any(not np.array_equal(p, parts[0]) for p in parts):
                raise ValueError(f"{ref}: the slices' int8 scales differ; "
                                 "the JAX package keeps one per stacked "
                                 "leaf")
            out[ref] = parts[0]
        else:
            out[ref] = np.stack(parts)
    return out


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
