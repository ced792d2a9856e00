"""Plain-PyTorch version of the dense LWW kernel (``delta_apply.cu``),
on the same bucketed inputs: a scatter-max / scatter-min of the packed
key ``2·rank + is_add`` per cell.  What the wrapper runs for CPU
tensors and what the kernel is held against on the card."""
from __future__ import annotations

import torch

INT_MAX = 2 ** 31 - 1


def lww_resolve(cells: torch.Tensor, t: torch.Tensor, key: torch.Tensor,
                n_cells: int, anchor: torch.Tensor, t_anchor: torch.Tensor,
                t_query: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
    """Last-writer-wins over ``n_cells`` cells for Q windows at once.

    ``cells``/``t``/``key`` describe one entry each (cell index, op
    time, 2·rank + (op is ADD)); ``anchor`` is bool[n_cells] or
    bool[Q, n_cells]; ``t_anchor``/``t_query`` are i32[Q]; ``keep`` an
    optional bool[Q, entries] extra filter.  Forward windows take the
    max key (last op decides, value = ADD), backward windows the min key
    (first op decides, value = REM).  Returns bool[Q, n_cells].
    """
    q = t_query.numel()
    dev = anchor.device
    fwd = (t_query >= t_anchor).view(q, 1)
    lo = torch.minimum(t_anchor, t_query).view(q, 1)
    hi = torch.maximum(t_anchor, t_query).view(q, 1)
    win = (t.view(1, -1) > lo) & (t.view(1, -1) <= hi)
    if keep is not None:
        win = win & keep
    base = (torch.arange(q, device=dev, dtype=torch.int64).view(q, 1)
            * n_cells)
    flat = (base + cells.view(1, -1).to(torch.int64)).expand_as(win)
    keyq = key.view(1, -1).expand_as(win)
    sel_f = win & fwd
    sel_b = win & ~fwd
    last = torch.full((q * n_cells,), -1, dtype=torch.int32, device=dev)
    last.scatter_reduce_(0, flat[sel_f], keyq[sel_f], reduce="amax")
    first = torch.full((q * n_cells,), INT_MAX, dtype=torch.int32,
                       device=dev)
    first.scatter_reduce_(0, flat[sel_b], keyq[sel_b], reduce="amin")
    last = last.view(q, n_cells)
    first = first.view(q, n_cells)
    decided = torch.where(fwd, last >= 0, first < INT_MAX)
    value = torch.where(fwd, (last & 1) == 1, (first & 1) == 0)
    return torch.where(decided, value, anchor.view(-1, n_cells))


def entry_tiles(tile_start: torch.Tensor) -> torch.Tensor:
    """The tile id of every bucketed entry (inverse of ``tile_start``)."""
    counts = (tile_start[1:] - tile_start[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=tile_start.device), counts)


def delta_apply_ref(anchor_adj: torch.Tensor, entries: torch.Tensor,
                    tile_start: torch.Tensor, t_anchor: torch.Tensor,
                    t_query: torch.Tensor, row_mask: torch.Tensor | None,
                    tile: int) -> torch.Tensor:
    """bool[Q, R, N]: what ``delta_apply.cu`` writes, for an adjacency
    (R = N) or a row block of R rows with its local buckets."""
    r, n = anchor_adj.shape[-2:]
    tiles_c = -(-n // tile)
    tid = entry_tiles(tile_start)
    cell = entries[:, 0].to(torch.int64)
    gr = (tid // tiles_c) * tile + cell // tile
    gc = (tid % tiles_c) * tile + cell % tile
    keep = None
    if row_mask is not None:
        keep = row_mask[:, gr] | row_mask[:, gc]
    out = lww_resolve(gr * n + gc, entries[:, 1], entries[:, 2], r * n,
                      anchor_adj.reshape(-1, r * n), t_anchor, t_query,
                      keep)
    return out.view(-1, r, n)
