from repro_torch.kernels.edge_delta_apply.ops import (
    TILE, WARPS, bucket_slot_ops, edge_delta_apply,
    edge_delta_apply_slot_block)
from repro_torch.kernels.edge_delta_apply.ref import edge_delta_apply_ref

__all__ = ["TILE", "WARPS", "bucket_slot_ops", "edge_delta_apply",
           "edge_delta_apply_ref", "edge_delta_apply_slot_block"]
