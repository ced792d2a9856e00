from repro_torch.checkpoint.deltastore import (DeltaCheckpointStore,
                                               DeltaPolicy)
from repro_torch.checkpoint.history import HistoryLog, tensor_measures
from repro_torch.checkpoint.io import load_arrays, load_into, save_pytree

__all__ = ["DeltaCheckpointStore", "DeltaPolicy", "HistoryLog",
           "tensor_measures", "load_arrays", "load_into", "save_pytree"]
