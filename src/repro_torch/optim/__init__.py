from repro_torch.optim.adamw import (AdamWState, QTensor, adamw_init,
                                     adamw_update, global_norm)
from repro_torch.optim.compress import (compress_with_feedback,
                                       compressed_psum, int8_compress,
                                       int8_decompress)
from repro_torch.optim.schedule import lr_schedule

__all__ = ["AdamWState", "QTensor", "adamw_init", "adamw_update",
           "global_norm", "lr_schedule", "int8_compress", "int8_decompress",
           "compress_with_feedback", "compressed_psum"]
