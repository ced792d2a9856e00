"""Plain-PyTorch version of the edge-slot LWW kernel
(``edge_delta_apply.cu``) on the same bucketed inputs."""
from __future__ import annotations

import torch

from repro_torch.kernels.delta_apply.ref import entry_tiles, lww_resolve


def edge_delta_apply_ref(anchor_emask: torch.Tensor, entries: torch.Tensor,
                         tile_start: torch.Tensor, t_anchor: torch.Tensor,
                         t_query: torch.Tensor, tile: int) -> torch.Tensor:
    """bool[Q, E]: what ``edge_delta_apply.cu`` writes."""
    e = anchor_emask.shape[-1]
    slot = entry_tiles(tile_start) * tile + entries[:, 0].to(torch.int64)
    return lww_resolve(slot, entries[:, 1], entries[:, 2], e,
                       anchor_emask.reshape(-1, e), t_anchor, t_query)
