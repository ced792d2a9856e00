from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_sequential

__all__ = ["ssd_chunked", "ssd_scan", "ssd_sequential"]
