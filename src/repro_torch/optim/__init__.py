from repro_torch.optim.adamw import (AdamWState, QTensor, adamw_init,
                                     adamw_update, global_norm)
from repro_torch.optim.schedule import lr_schedule

__all__ = ["AdamWState", "QTensor", "adamw_init", "adamw_update",
           "global_norm", "lr_schedule"]
