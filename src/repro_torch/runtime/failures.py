"""Failure injection + recovery harness for the training loop —
``repro/runtime/failures.py`` on the port's ``replica/faults.py``.

On a real cluster, node failure surfaces as a raised exception from the
collective runtime (or a coordinator timeout).  The training loop's
contract is: any step may raise; recovery = reconstruct the last logged
state from the DeltaCheckpointStore (paper Theorem 1 — nearest
materialized snapshot + delta chain) and resume from its step counter.
The synthetic-data pipeline is stateless, so the token stream continues
exactly.

``FailureInjector`` makes that path testable on one host.  It is the
training-loop face of the shared fault-injection layer
(``repro_torch.replica.faults``) — the replication chaos tests use the same
``FaultInjector`` core for torn writes, bit flips, dropped/delayed
transfers, and EIO, so one seeded schedule drives every failure mode
in the repo.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.replica.faults import FaultInjector, FaultRule, InjectedFault


class InjectedFailure(InjectedFault):
    pass


class FailureInjector(FaultInjector):
    """Raises InjectedFailure at the given steps (once each)."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = tuple(fail_at)
        super().__init__([FaultRule(point="step", kind="raise",
                                    at=self.fail_at, exc=InjectedFailure)])

    def check(self, step: int) -> None:   # noqa: D401 — legacy signature
        super().check("step", value=step)

    @property
    def _pending(self) -> set:
        """Steps scheduled but not yet fired (legacy test surface)."""
        return set().union(set(), *(r._at_pending for r in self.rules
                                    if r.point == "step"))


def run_with_recovery(train_loop: Callable[[int], int], store,
                      template, max_restarts: int = 10) -> int:
    """Drive ``train_loop(start_step) -> final state`` with restart-on-
    failure semantics.  ``train_loop`` must checkpoint into ``store``;
    on failure we restore the latest logged state and re-enter."""
    restarts = 0
    start = 0
    while True:
        try:
            return train_loop(start)
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            latest = store.latest_step()
            if latest is None:
                start = 0
            else:
                start = latest
