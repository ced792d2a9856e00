"""wal-order: no ack-visible mutation may precede its WAL append.

The durability contract is WAL-before-ack: an op the serving
layer buffers (and will acknowledge) must already be in the write-ahead
log, and a sealed-segment artifact may only be written once the WAL
record that pins its cut is durable.  A refactor that swaps the two
lines compiles, passes every non-crash test, and silently breaks the
bit-exact recovery guarantee — exactly the class of bug a kill -9 test
eventually catches and this pass catches immediately.

Rule: in ``serving/ingest.py`` and ``persist/`` (minus ``wal.py``, the
log's own implementation), any function that performs a WAL append must
perform it before — in execution-order AST walk — every ack-visible
mutation in that function:

* buffer growth: ``*pending*.append/extend/insert`` or ``+=``
* durable artifact writes: ``save_segment_file(...)``

Pure drains (rebinding the buffer, slicing it down) are not acks and
are not flagged.  Functions with no WAL call are out of scope — the
in-memory configuration buffers without logging by design.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.base import (Finding, LintPass, ParsedFile,
                                 attr_chain)
from repro_torch.analysis.registry import register

_WAL_METHODS = frozenset({
    "log_pending", "log_drain", "log_ops", "log_advance", "log_seal",
})
_GROW = frozenset({"append", "extend", "insert"})
_ARTIFACT_WRITES = frozenset({"save_segment_file"})


def _is_wal_call(chain: tuple[str, ...]) -> bool:
    if not chain:
        return False
    if chain[-1] in _WAL_METHODS:
        return True
    return (chain[-1] == "append"
            and any(("wal" in part and "pending" not in part)
                    for part in chain[:-1]))


def _is_ack_event(node: ast.AST) -> str | None:
    """A human-readable description when ``node`` makes state ack-visible."""
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if not chain:
            return None
        if chain[-1] in _ARTIFACT_WRITES:
            return f"artifact write {chain[-1]}()"
        if chain[-1] in _GROW and len(chain) >= 2 \
                and "pending" in chain[-2].lower():
            return f"buffer growth {'.'.join(chain)}()"
    if isinstance(node, ast.AugAssign):
        chain = attr_chain(node.target)
        if chain and "pending" in chain[-1].lower():
            return f"buffer growth {'.'.join(chain)} +="
    return None


class _OrderWalker(ast.NodeVisitor):
    """Execution-ordered event collection for one function body."""

    def __init__(self) -> None:
        self.events: list[tuple[str, str, int]] = []  # (kind, desc, line)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass                            # stay out of nested defs

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        desc = _is_ack_event(node)
        if desc:
            self.events.append(("ack", desc, node.lineno))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        chain = attr_chain(node.func)
        if _is_wal_call(chain):
            self.events.append(("wal", ".".join(chain), node.lineno))
        else:
            desc = _is_ack_event(node)
            if desc:
                self.events.append(("ack", desc, node.lineno))
        self.generic_visit(node)


@register
class WalOrderingPass(LintPass):
    name = "wal-ordering"
    description = ("WAL-before-ack: in serving/ingest.py and persist/, "
                   "buffer growth and artifact writes must follow the "
                   "function's WAL append")
    rules = ("wal-order",)

    def applies(self, pf: ParsedFile) -> bool:
        if pf.endswith("serving/ingest.py"):
            return True
        return pf.in_dir("persist") and not pf.endswith("persist/wal.py")

    def check_file(self, pf: ParsedFile) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(pf.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            walker = _OrderWalker()
            for st in node.body:
                walker.visit(st)
            events = walker.events
            first_wal = next((i for i, (k, _, _) in enumerate(events)
                              if k == "wal"), None)
            if first_wal is None:
                continue                # no WAL in this function
            for kind, desc, line in events[:first_wal]:
                if kind == "ack":
                    out.append(self.finding(
                        "wal-order", pf, line,
                        f"{desc} in {node.name}() is reachable before "
                        f"the WAL append at line "
                        f"{events[first_wal][2]} — log first, then "
                        "make the state ack-visible"))
        return out
