from repro_torch.kernels.degree_series.ops import (TILE, degree_series_kernel,
                                                  degree_series_rows)
from repro_torch.kernels.degree_series.ref import degree_series_ref

__all__ = ["TILE", "degree_series_kernel", "degree_series_ref",
           "degree_series_rows"]
