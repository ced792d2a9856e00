from repro_torch.kernels.degree_series.ops import (TILE, bucket_node_events,
                                                   degree_series_kernel)
from repro_torch.kernels.degree_series.ref import degree_series_ref

__all__ = ["TILE", "bucket_node_events", "degree_series_kernel",
           "degree_series_ref"]
