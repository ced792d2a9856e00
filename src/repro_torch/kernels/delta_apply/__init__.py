from repro_torch.kernels.delta_apply.ops import (TILE, bucket_ops,
                                                 delta_apply,
                                                 delta_apply_row_block,
                                                 node_mask_lww)
from repro_torch.kernels.delta_apply.ref import delta_apply_ref, lww_resolve

__all__ = ["TILE", "bucket_ops", "delta_apply", "delta_apply_ref",
           "delta_apply_row_block", "lww_resolve", "node_mask_lww"]
