from repro_torch.kernels.delta_apply.ops import (TILE, bucket_ops,
                                                 delta_apply, node_mask_lww)
from repro_torch.kernels.delta_apply.ref import delta_apply_ref, lww_resolve

__all__ = ["TILE", "bucket_ops", "delta_apply", "delta_apply_ref",
           "lww_resolve", "node_mask_lww"]
