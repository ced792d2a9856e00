"""graphlint: repo-native static analysis + runtime sanitizers — the
port's copy of ``repro.analysis``, with its own host-sync pass for
PyTorch (``passes/torch_hotpath.py``).

The stack's correctness invariants — WAL-before-ack, frozen-epoch
immutability, lock-guarded shared state, device values staying on
device — hold by convention; this package checks them mechanically.

* ``repro_torch.analysis.driver.analyze_paths`` — run every registered pass
  over a file tree (what ``python -m repro_torch.analysis`` calls).
* ``repro_torch.analysis.registry`` — the pass registry (``@register``).
* ``repro_torch.analysis.lockdep`` — the opt-in runtime lock-order sanitizer
  (enable with ``pytest --lockdep`` or ``GRAPHLINT_LOCKDEP=1``).
"""
from repro_torch.analysis.base import Finding, LintPass, ParsedFile
from repro_torch.analysis.driver import Report, analyze_files, analyze_paths
from repro_torch.analysis.registry import all_passes, create_passes, register

__all__ = [
    "Finding", "LintPass", "ParsedFile", "Report",
    "analyze_files", "analyze_paths",
    "all_passes", "create_passes", "register",
]
