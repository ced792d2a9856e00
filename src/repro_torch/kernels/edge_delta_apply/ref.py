"""Plain-PyTorch version of the edge-slot LWW kernel
(``edge_delta_apply.cu``) on the same bucketed inputs."""
from __future__ import annotations

import torch

from repro_torch.kernels.delta_apply.ref import entry_tiles, lww_resolve


def edge_delta_apply_ref(anchor_emask: torch.Tensor, entries: torch.Tensor,
                         tile_start: torch.Tensor, t_anchor: torch.Tensor,
                         t_query: torch.Tensor, tile: int) -> torch.Tensor:
    """bool[Q, E]: what ``edge_delta_apply.cu`` writes, from entries
    ``[t, local slot·2 + is_add]`` keyed by position (``2·j +
    is_add``)."""
    e = anchor_emask.shape[-1]
    code = entries[:, 1]
    slot = entry_tiles(tile_start) * tile + (code >> 1).to(torch.int64)
    key = (torch.arange(code.numel(), dtype=torch.int32,
                        device=code.device) * 2 + (code & 1))
    return lww_resolve(slot, entries[:, 0], key, e,
                       anchor_emask.reshape(-1, e), t_anchor, t_query)
