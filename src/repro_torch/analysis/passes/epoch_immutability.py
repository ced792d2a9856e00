"""epoch-freeze: frozen-epoch state is written only by its owners.

Sealed ``Segment``s, merged tree nodes, and each epoch's
``SegmentedDeltaView`` are immutable by contract — a frozen engine
serves from them while the next swap builds the successor, and the
bit-exact watermark guarantee assumes nothing it reads ever changes.
The owners of that state are ``core/segments.py`` (seal, spill/reload,
residency) and ``core/store.py`` (tail building, freeze): only they may
write it.  Any other module assigning or mutating through a
segment/view receiver is either a correctness bug (mutating state an
in-flight epoch serves from) or a layering violation that will become
one.

Heuristic receiver matching (static Python has no types): an
expression mutates frozen-epoch state when the receiver *looks like* a
segment/view (variable or attribute named ``seg``/``segment``/
``view``/``node``/``merged``, or a ``.segments[...]`` element) and the
attribute written is one of the view/segment internals.  Precision
over recall — the runtime contract tests remain the backstop.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.base import (Finding, LintPass, ParsedFile,
                                 attr_chain)
from repro_torch.analysis.registry import register

#: who may write frozen-epoch state
OWNER_SUFFIXES = ("core/segments.py", "core/store.py")

#: receiver names that read as a segment / view / tree node
RECEIVER_HINTS = frozenset({"seg", "segment", "view", "node", "merged",
                            "segments"})

#: segment/view fields that define the frozen state
WATCHED_ATTRS = frozenset({
    "segments", "merged", "ops", "op", "u", "v", "t", "slot",
    "t_min", "t_max", "n_ops", "span",
    "_cache", "_full", "_delta", "_host", "_node_ops_sum",
    "_tmin", "_tmax", "_cum",
})

_MUTATORS = frozenset({
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "add", "remove", "discard", "setdefault", "fill", "sort",
})


def _receiver_is_epoch_state(recv: ast.AST) -> bool:
    """True when ``recv`` syntactically reads as segment/view state."""
    chain = attr_chain(recv)
    if chain:
        tail = [p for p in chain if p != "self"]
        if tail and tail[-1] in RECEIVER_HINTS:
            return True
        return False
    # segments[i].attr — a Subscript receiver over a hinted name
    if isinstance(recv, ast.Subscript):
        inner = attr_chain(recv.value)
        return bool(inner) and inner[-1] in RECEIVER_HINTS
    return False


@register
class EpochImmutabilityPass(LintPass):
    name = "epoch-immutability"
    description = ("writes to frozen-epoch state (Segment fields, "
                   "SegmentedDeltaView internals) outside the seal/"
                   "swap owners core/segments.py and core/store.py")
    rules = ("epoch-freeze",)

    def applies(self, pf: ParsedFile) -> bool:
        return not any(pf.endswith(sfx) for sfx in OWNER_SUFFIXES)

    def check_file(self, pf: ParsedFile) -> list[Finding]:
        out: list[Finding] = []

        def _flag(attr: str, recv: ast.AST, line: int,
                  how: str) -> None:
            if attr in WATCHED_ATTRS and _receiver_is_epoch_state(recv):
                out.append(self.finding(
                    "epoch-freeze", pf, line,
                    f"{how} of frozen-epoch state .{attr} — sealed "
                    "segments and epoch views are immutable; only "
                    "core/segments.py and core/store.py (seal/swap "
                    "owners) may write them"))

        def _check_target(t: ast.AST, how: str) -> None:
            if isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    _check_target(el, how)
                return
            if isinstance(t, ast.Starred):
                _check_target(t.value, how)
                return
            if isinstance(t, ast.Subscript):
                # seg.u[...] = x  — element store into a watched field
                if isinstance(t.value, ast.Attribute):
                    _flag(t.value.attr, t.value.value, t.lineno,
                          "element store into")
                return
            if isinstance(t, ast.Attribute):
                _flag(t.attr, t.value, t.lineno, "assignment")

        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    _check_target(t, "assignment")
            elif isinstance(node, ast.AugAssign):
                _check_target(node.target, "assignment")
            elif isinstance(node, ast.AnnAssign) \
                    and node.value is not None:
                _check_target(node.target, "assignment")
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    _check_target(t, "deletion")
            elif isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _MUTATORS \
                        and isinstance(node.func.value, ast.Attribute):
                    _flag(node.func.value.attr, node.func.value.value,
                          node.lineno, f"in-place {node.func.attr}()")
        return out
