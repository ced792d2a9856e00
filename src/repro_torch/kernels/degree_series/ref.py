"""Plain-PyTorch version of the degree-series kernel
(``degree_series.cu``) on the same bucketed events."""
from __future__ import annotations

import torch

from repro_torch.kernels.delta_apply.ref import entry_tiles


def degree_series_ref(deg_cur: torch.Tensor, events: torch.Tensor,
                      tile_start: torch.Tensor, t_k: int, num_buckets: int,
                      tile: int) -> torch.Tensor:
    """i32[B, N]: deg(v, t_k + b) = deg_cur(v) − Σ_{b' > b} net[b', v],
    an event ``[t, local node·2 + is_add]`` with t > t_k counting at
    bucket b' = min(t − t_k, B)."""
    n = deg_cur.shape[0]
    code = events[:, 1]
    node = entry_tiles(tile_start) * tile + (code >> 1).to(torch.int64)
    t = events[:, 0].to(torch.int64)
    win = t > int(t_k)
    b = torch.clamp(t[win] - int(t_k), max=num_buckets)
    net = torch.zeros((num_buckets + 1, n), dtype=torch.int32,
                      device=deg_cur.device)
    net.index_put_((b, node[win]), ((code & 1) * 2 - 1)[win],
                   accumulate=True)
    after = torch.flip(torch.cumsum(torch.flip(net[1:], (0,)), 0,
                                    dtype=torch.int32), (0,))
    return deg_cur.view(1, n) - after
