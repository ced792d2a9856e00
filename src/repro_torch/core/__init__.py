# The paper's storage model, reconstruction, plans, engine — the
# PyTorch mirror of ``repro.core``: snapshots + interval deltas,
# reconstruction (sequential and last-writer-wins), query plans,
# indexes, materialization; ``core.distributed`` is the multi-device
# engine.
from repro_torch.core.delta import (ADD_EDGE, ADD_NODE, NOP, REM_EDGE,
                                    REM_NODE, Delta, concat_deltas,
                                    delta_from_numpy, empty_delta,
                                    minimal_delta_between, slice_delta)
from repro_torch.core.engine import (AnchorCandidate, AnchorSelector,
                                     HistoricalQueryEngine, PlanChoice,
                                     Planner, WatermarkError)
from repro_torch.core.graph import (DenseGraph, EdgeGraph, dense_from_numpy,
                                    dense_to_edge, edge_to_dense,
                                    empty_dense, empty_edge)
from repro_torch.core.index import (NodeIndex, build_node_index,
                                    build_node_index_host, count_window_ops,
                                    gather_node_ops, gather_window,
                                    temporal_range)
from repro_torch.core.materialize import (MaterializationPolicy,
                                          MaterializedStore, edge_jaccard)
from repro_torch.core.partial import (closure_mask, partial_reconstruct,
                                      seed_mask)
from repro_torch.core.plans import (Query, applicable_plans, evaluate,
                                    two_phase)
from repro_torch.core.reconstruct import (degree_series, node_degree_series,
                                          reconstruct_at, reconstruct_dense,
                                          reconstruct_edge,
                                          reconstruct_sequential)
from repro_torch.core.store import Op, TemporalGraphStore

__all__ = [k for k in dir() if not k.startswith("_")]
