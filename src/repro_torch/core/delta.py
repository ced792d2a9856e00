"""Graph deltas: time-annotated logs of graph update operations.

The paper's Definition 3 (*interval delta*) as a structure of int32
tensors with a static capacity (mirror of ``repro.core.delta``):

  op[i]   : operation code (ADD_NODE / REM_NODE / ADD_EDGE / REM_EDGE / NOP)
  u[i]    : first endpoint (== node id for node ops)
  v[i]    : second endpoint (== u for node ops)
  slot[i] : persistent identity — node id for node ops, edge-registry id
            for edge ops (assigned host-side by the store)
  t[i]    : time unit at which the op occurred (non-decreasing)

Entries past ``n_ops`` are padding: ``op == NOP`` and ``t == T_PAD``.
``n_ops`` is a host int (the store always knows it), so masks never
need a device round trip.  Inversion (Definition 5) is ``op ^ 1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Operation codes. ADD/REM pairs differ in the low bit so that the
# paper's delta inversion (Definition 5) is ``op ^ 1``.
ADD_NODE = 0
REM_NODE = 1
ADD_EDGE = 2
REM_EDGE = 3
NOP = 4

# Padding timestamp (must sort after every real timestamp).
T_PAD = int(np.iinfo(np.int32).max)

OP_NAMES = {ADD_NODE: "addNode", REM_NODE: "remNode",
            ADD_EDGE: "addEdge", REM_EDGE: "remEdge", NOP: "nop"}

I32 = torch.int32


def pow2_capacity(n: int, lo: int = 1) -> int:
    """Smallest power of two ≥ n, floored at ``lo`` — the one device-
    capacity rounding rule (engine group padding and segment window
    materialization share it)."""
    return max(lo, 1 << int(np.ceil(np.log2(max(int(n), 1)))))


@dataclasses.dataclass(frozen=True)
class Delta:
    """An interval delta Δ_{[t0, tcur]} (paper Definition 3)."""

    op: torch.Tensor    # i32[M]
    u: torch.Tensor     # i32[M]
    v: torch.Tensor     # i32[M]
    slot: torch.Tensor  # i32[M]
    t: torch.Tensor     # i32[M]
    n_ops: int          # number of valid (non-padding) entries

    @property
    def capacity(self) -> int:
        return self.op.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.op.device

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.n_ops

    def is_edge_op(self) -> torch.Tensor:
        return (self.op == ADD_EDGE) | (self.op == REM_EDGE)

    def is_node_op(self) -> torch.Tensor:
        return (self.op == ADD_NODE) | (self.op == REM_NODE)

    def invert(self) -> "Delta":
        """Inverted delta (paper Definition 5): ADD <-> REM per op."""
        inv = torch.where(self.op == NOP, self.op, self.op ^ 1)
        return dataclasses.replace(self, op=inv)

    def window_mask(self, t_lo, t_hi) -> torch.Tensor:
        """Mask of ops with t in the half-open interval (t_lo, t_hi]."""
        return (self.t > t_lo) & (self.t <= t_hi) & (self.op != NOP)


def empty_delta(capacity: int, device="cuda") -> Delta:
    return Delta(
        op=torch.full((capacity,), NOP, dtype=I32, device=device),
        u=torch.zeros((capacity,), dtype=I32, device=device),
        v=torch.zeros((capacity,), dtype=I32, device=device),
        slot=torch.zeros((capacity,), dtype=I32, device=device),
        t=torch.full((capacity,), T_PAD, dtype=I32, device=device),
        n_ops=0)


def delta_from_numpy(op, u, v, slot, t, capacity: int | None = None,
                     device="cuda") -> Delta:
    """Build a device Delta from host (numpy) op arrays, padding to
    capacity."""
    op = np.asarray(op, np.int32)
    n = op.shape[0]
    cap = capacity if capacity is not None else max(int(n), 1)
    if cap < n:
        raise ValueError(f"capacity {cap} < n_ops {n}")

    def pad(x, fill):
        out = np.full((cap,), fill, np.int32)
        out[:n] = np.asarray(x, np.int32)
        return torch.from_numpy(out).to(device)

    return Delta(op=pad(op, NOP), u=pad(u, 0), v=pad(v, 0),
                 slot=pad(slot, 0), t=pad(t, T_PAD), n_ops=int(n))


def concat_deltas(a: Delta, b: Delta, capacity: int | None = None) -> Delta:
    """Append delta ``b`` after ``a`` (paper Algorithm 3, line 8).
    Assumes a's timestamps precede b's."""
    cap = capacity if capacity is not None else a.capacity + b.capacity
    na, nb = a.n_ops, b.n_ops
    if cap < na + nb:
        raise ValueError("concat capacity too small")

    def cat(xa, xb, fill):
        out = torch.full((cap,), fill, dtype=I32, device=xa.device)
        out[:na] = xa[:na]
        out[na:na + nb] = xb[:nb]
        return out

    return Delta(op=cat(a.op, b.op, NOP), u=cat(a.u, b.u, 0),
                 v=cat(a.v, b.v, 0), slot=cat(a.slot, b.slot, 0),
                 t=cat(a.t, b.t, T_PAD), n_ops=na + nb)


def slice_delta(d: Delta, t_lo, t_hi) -> Delta:
    """Host-level restriction of a delta to ops with t in (t_lo, t_hi]."""
    keep = torch.nonzero(d.window_mask(int(t_lo), int(t_hi))).flatten()
    if keep.numel() == 0:
        return empty_delta(1, d.device)
    return Delta(op=d.op[keep], u=d.u[keep], v=d.v[keep],
                 slot=d.slot[keep], t=d.t[keep], n_ops=int(keep.numel()))


def minimal_delta_between(mask_a: np.ndarray, adj_a: np.ndarray,
                          mask_b: np.ndarray, adj_b: np.ndarray,
                          t: int) -> tuple[np.ndarray, ...]:
    """The *minimal* delta of paper Definition 2 / Lemma 1.

    Given two snapshots (host node masks + dense adjacency), emit
    exactly the operations required to turn A into B, in the order
    add-node, add-edge, rem-edge, rem-node: unique and minimal, used to
    validate Lemma 1 against logged (redundant) interval deltas.
    Returns int32 host arrays (op, u, v, t).
    """
    mask_a, mask_b = np.asarray(mask_a, bool), np.asarray(mask_b, bool)
    adj_a, adj_b = np.asarray(adj_a, bool), np.asarray(adj_b, bool)
    add_nodes = np.nonzero(~mask_a & mask_b)[0]
    rem_nodes = np.nonzero(mask_a & ~mask_b)[0]
    iu, iv = np.triu_indices(adj_a.shape[0], k=1)
    ea = adj_a[iu, iv]
    eb = adj_b[iu, iv]
    add_e = np.nonzero(~ea & eb)[0]
    # Def. 2(4): remEdge only when both endpoints survive in B; edges
    # dropped because an endpoint was removed are implied by remNode.
    both_live = mask_b[iu] & mask_b[iv]
    rem_e = np.nonzero(ea & ~eb & both_live)[0]
    op = np.concatenate([np.full(add_nodes.shape, ADD_NODE),
                         np.full(add_e.shape, ADD_EDGE),
                         np.full(rem_e.shape, REM_EDGE),
                         np.full(rem_nodes.shape, REM_NODE)])
    u = np.concatenate([add_nodes, iu[add_e], iu[rem_e], rem_nodes])
    v = np.concatenate([add_nodes, iv[add_e], iv[rem_e], rem_nodes])
    return (op.astype(np.int32), u.astype(np.int32), v.astype(np.int32),
            np.full(op.shape, t, np.int32))
