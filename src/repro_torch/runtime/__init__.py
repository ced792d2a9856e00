from repro_torch.runtime.elastic import (reshard_from_checkpoint,
                                         reshard_state)
from repro_torch.runtime.failures import (FailureInjector, InjectedFailure,
                                          run_with_recovery)
from repro_torch.runtime.steps import (TrainState, init_train_state,
                                       make_decode_step, make_grad_fn,
                                       make_prefill_step, make_train_step)
from repro_torch.runtime.stragglers import StragglerPolicy

__all__ = ["TrainState", "init_train_state", "make_grad_fn",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "FailureInjector", "InjectedFailure", "run_with_recovery",
           "reshard_state", "reshard_from_checkpoint", "StragglerPolicy"]
