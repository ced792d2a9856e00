"""Wrapper of the edge-slot LWW kernel (``edge_delta_apply.cu``): slot
tile bucketing in plain PyTorch and the launch.  The node mask goes
through ``delta_apply.ops.node_mask_lww``, exactly like the dense
path."""
from __future__ import annotations

import torch

from repro_torch.core.delta import ADD_EDGE, Delta
from repro_torch.kernels import build
from repro_torch.kernels.delta_apply.ops import node_mask_lww
from repro_torch.kernels.edge_delta_apply.ref import edge_delta_apply_ref

TILE = 512   # slots a warp resolves (== WS in edge_delta_apply.cu)
WARPS = 8    # tiles a block (== WARPS in edge_delta_apply.cu)


def bucket_slot_ops(delta: Delta, e: int, t_lo=None, t_hi=None, *,
                    slot0: int = 0):
    """Bucket the delta's edge ops by tile of TILE slots: ONE entry per
    op, i32 ``[t, local slot·2 + (op == addEdge)]``, ordered by tile and
    within a tile by time, then rank (for the store's time-ordered log,
    rank order).  An entry's position j then orders the ops of one slot
    as their ranks do, so the kernel's key ``2·j + is_add`` decides
    last-writer-wins as ``2·rank + is_add`` would, and every window
    holds one contiguous run of a tile's entries.  No per-tile cap.
    Returns (entries i32[E', 2], tile_start i32[T + 1]).

    ``slot0`` makes the bucketing shard-safe: a device that owns only
    slots [slot0, slot0 + e) keeps exactly the ops on its block, with
    the slot made local; the next block's ops never land in this block's
    pad band (slots past ``e`` in its last tile).  The order is the same
    (tile, time) order, so positions still order one slot's ops as their
    ranks do."""
    keep = (delta.valid_mask() & delta.is_edge_op() & (delta.slot >= slot0)
            & (delta.slot < slot0 + e))
    if t_lo is not None:
        keep &= delta.t > int(t_lo)
    if t_hi is not None:
        keep &= delta.t <= int(t_hi)
    idx = torch.nonzero(keep).flatten()
    slot = delta.slot[idx].to(torch.int64) - slot0
    t = delta.t[idx].to(torch.int64)
    tiles = -(-e // TILE)
    tile_id = slot // TILE
    # (tile, time) in one int64 key; the stable sort keeps rank order
    # among equal keys
    order = torch.argsort((tile_id << 32) + (t + 2 ** 31), stable=True)
    tile_start = torch.searchsorted(
        tile_id[order], torch.arange(tiles + 1, device=slot.device))
    code = (slot % TILE) * 2 + (delta.op[idx] == ADD_EDGE).to(torch.int64)
    entries = torch.stack([t, code], 1)
    return (entries[order].to(torch.int32).contiguous(),
            tile_start.to(torch.int32))


def edge_delta_apply(anchor_emask: torch.Tensor, entries: torch.Tensor,
                     tile_start: torch.Tensor, t_anchor: torch.Tensor,
                     t_query: torch.Tensor, *,
                     block: bool = False) -> torch.Tensor:
    """bool[Q, E]: LWW reconstruction of Q edge masks.  ``anchor_emask``
    is bool[E] (shared) or bool[Q, E]; ``t_anchor``/``t_query`` i32[Q];
    ``block``: the masks are one slot block of a sharded registry (the
    launch is also counted in ``build.BLOCK_LAUNCHES``).  CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    if anchor_emask.device.type == "cpu":
        return edge_delta_apply_ref(anchor_emask, entries, tile_start,
                                    t_anchor, t_query, TILE)
    e = anchor_emask.shape[-1]
    q = t_query.numel()
    build.check_cuda("anchor_emask", anchor_emask, torch.bool)
    if anchor_emask.dim() not in (1, 2) or (
            anchor_emask.dim() == 2 and anchor_emask.shape[0] != q):
        raise ValueError(f"anchor_emask shape {tuple(anchor_emask.shape)} "
                         f"is not [E] or [{q}, E]")
    build.check_cuda("entries", entries, torch.int32, 2)
    build.check_cuda("tile_start", tile_start, torch.int32, 1)
    build.check_cuda("t_anchor", t_anchor, torch.int32, 1)
    build.check_cuda("t_query", t_query, torch.int32, 1)
    if entries.shape[1] != 2 or tile_start.numel() != -(-e // TILE) + 1:
        raise ValueError("entries/tile_start do not match the tiling")
    if t_anchor.numel() != q:
        raise ValueError("t_anchor and t_query differ in length")
    build.check_same_device(anchor_emask=anchor_emask, entries=entries,
                            tile_start=tile_start, t_anchor=t_anchor,
                            t_query=t_query)
    out = torch.empty((q, e), dtype=torch.bool, device=anchor_emask.device)
    build.ext().edge_delta_apply(
        entries, tile_start, anchor_emask,
        e if anchor_emask.dim() == 2 else 0, out, t_anchor, t_query, e,
        build.stream_handle(anchor_emask.device))
    build.LAUNCHES["edge_delta_apply"] += 1
    if block:
        build.BLOCK_LAUNCHES["edge_delta_apply"] += 1
    return out


def edge_delta_apply_slot_block(nodes: torch.Tensor | None,
                                emask_block: torch.Tensor, delta: Delta,
                                t_anchor, t_query, slot0: int,
                                buckets=None):
    """LWW reconstruction of one edge-mask *slot block* for Q windows —
    what each device of a slot-sharded mesh runs.  ``emask_block`` is
    bool[S] (or bool[Q, S]): slots [slot0, slot0 + S) of the registry;
    ``nodes`` the whole (replicated) node mask, bool[N] or bool[Q, N],
    or None where this shard resolves no node (the mask is N-sized, so
    one shard alone resolves it); ``t_anchor``/``t_query`` i32[Q];
    ``buckets`` may carry a ``bucket_slot_ops(..., slot0=slot0)``
    covering every window.  Returns (nodes bool[Q, N] or None, emask
    bool[Q, S])."""
    if buckets is None:
        # graphlint: ignore[host-sync] one host copy of the Q windows' times a call, to size the launch's buckets
        both = torch.cat([t_anchor, t_query]).cpu()
        buckets = bucket_slot_ops(delta, emask_block.shape[-1],
                                  int(both.min()), int(both.max()),
                                  slot0=slot0)
    emask = edge_delta_apply(emask_block, *buckets, t_anchor, t_query,
                             block=True)
    if nodes is None:
        return None, emask
    return node_mask_lww(nodes, delta, t_anchor, t_query), emask
