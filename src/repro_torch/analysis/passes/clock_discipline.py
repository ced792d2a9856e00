"""clock: library code times through ``repro_torch.obs.clock``, nothing else.

One sanctioned timer (``repro_torch.obs.clock.now`` — swappable in tests, one
place to change) keeps every histogram, trace span and swap-phase
measurement on the same clock.  Bare ``time.perf_counter()`` was
ci_lint's original grep rule; this pass is its AST-accurate port, also
covering ``time.time()`` (wall clock drifts under NTP — wrong for
durations and unorderable across hosts) and ``datetime.now()``/
``utcnow()``.  Scope: ``src/repro_torch`` outside ``obs/`` (the module that
defines the clock is the one place allowed to touch the primitives);
scripts and benchmarks are standalone tools and stay free.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.base import (Finding, LintPass, ParsedFile,
                                 attr_chain)
from repro_torch.analysis.registry import register

_TIME_FUNCS = frozenset({"perf_counter", "perf_counter_ns", "time"})
_DT_CHAINS = (
    ("datetime", "now"), ("datetime", "utcnow"),
    ("datetime", "datetime", "now"), ("datetime", "datetime", "utcnow"),
    ("date", "today"), ("datetime", "date", "today"),
)


@register
class ClockDisciplinePass(LintPass):
    name = "clock-discipline"
    description = ("bare time.perf_counter()/time.time()/datetime.now() "
                   "in src/repro_torch outside obs/ — use "
                   "repro_torch.obs.clock.now()")
    rules = ("clock",)

    def applies(self, pf: ParsedFile) -> bool:
        parts = pf.relparts
        if "repro_torch" not in parts:
            return False
        after = parts[parts.index("repro_torch") + 1:]
        return "obs" not in after

    def check_file(self, pf: ParsedFile) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if chain[:1] == ("time",) and len(chain) == 2 \
                        and chain[1] in _TIME_FUNCS:
                    out.append(self.finding(
                        "clock", pf, node.lineno,
                        f"bare {'.'.join(chain)}() — time through "
                        "repro_torch.obs.clock.now() (one clock, swappable "
                        "in tests)"))
                elif chain in _DT_CHAINS:
                    out.append(self.finding(
                        "clock", pf, node.lineno,
                        f"{'.'.join(chain)}() — wall-clock reads in "
                        "library code; use repro_torch.obs.clock.now() for "
                        "durations (stamp wall time at the edges only)"))
            elif isinstance(node, ast.ImportFrom) \
                    and node.module == "time":
                bad = [a.name for a in node.names
                       if a.name in _TIME_FUNCS]
                if bad:
                    out.append(self.finding(
                        "clock", pf, node.lineno,
                        f"from time import {', '.join(bad)} — aliased "
                        "timers dodge the clock rule; use "
                        "repro_torch.obs.clock.now()"))
        return out
