from repro_torch.kernels.evolve_sweep.ops import (SWEEP_MEASURES,
                                                  batch_evolve,
                                                  measure_from_state,
                                                  sweep_nets)
from repro_torch.kernels.evolve_sweep.ref import (evolve_ref,
                                                  sweep_series_ref,
                                                  sweep_work_ref)
from repro_torch.kernels.evolve_sweep.sweep import (CHUNK, TILE,
                                                    bucket_sweep_events,
                                                    sweep_degree_series,
                                                    sweep_series, sweep_work)

__all__ = ["CHUNK", "SWEEP_MEASURES", "TILE", "batch_evolve",
           "bucket_sweep_events", "evolve_ref", "measure_from_state",
           "sweep_degree_series", "sweep_nets", "sweep_series",
           "sweep_series_ref", "sweep_work", "sweep_work_ref"]
