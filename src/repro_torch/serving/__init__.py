# Live serving: double-buffered ingest (epoch swap + watermark),
# workload-driven materialization, and the micro-batching frontend —
# the PyTorch mirror of ``repro.serving``.
from repro_torch.serving.frontend import (FrontendStats, MicroBatchFrontend,
                                          OverloadError, query_cache_key)
from repro_torch.serving.ingest import (LiveGraphStore, SwapRecord,
                                        WatermarkError)
from repro_torch.serving.policy import (PeriodicMaterializationPolicy,
                                        RebalanceResult, WorkloadStats,
                                        WorkloadMaterializationPolicy)

__all__ = [
    "FrontendStats", "LiveGraphStore", "MicroBatchFrontend",
    "OverloadError",
    "PeriodicMaterializationPolicy", "RebalanceResult", "SwapRecord",
    "WatermarkError", "WorkloadMaterializationPolicy", "WorkloadStats",
    "query_cache_key",
]
