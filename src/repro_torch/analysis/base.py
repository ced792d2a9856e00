"""graphlint core: findings, parsed files, suppressions, the pass base.

The repo's correctness story rests on conventions no type checker sees:
WAL-before-ack, drain-logged swaps, frozen-epoch immutability, lock-
guarded registries, device values staying on device through the hot
path.  ``graphlint`` makes those conventions mechanical — each pass is
a small AST analysis that understands ONE invariant and flags code that
can break it.  Zero dependencies: everything here is ``ast`` + stdlib.

Suppression: a finding is silenced by a comment on the flagged line
(or on a comment-only line directly above it)::

    self.t_host = np.asarray(delta.t)  # graphlint: ignore[host-sync] one-time planning copy

The bracket names the RULE id (or the pass name, or ``*``); text after
the bracket is the required justification.  Suppressed findings are
still counted and reported by the CLI — a suppression is a documented
exception, not a deletion.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
import tokenize

__all__ = [
    "Finding", "ParsedFile", "LintPass", "Suppression",
    "attr_chain", "call_name", "parse_file", "parse_source",
]

_SUPPRESS_RE = re.compile(
    r"#\s*graphlint:\s*ignore\[([^\]]*)\]\s*(.*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str           # rule id, e.g. "lock-order" (suppression key)
    path: str           # path as given to the driver
    line: int           # 1-based
    message: str
    severity: str = "error"      # "error" | "warning"
    pass_name: str = ""          # owning pass (alternate suppression key)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}"
                f"[{self.rule}] {self.message}")


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    rules: tuple[str, ...]       # rule ids / pass names / "*"
    reason: str

    def matches(self, finding: Finding) -> bool:
        return any(r in ("*", finding.rule, finding.pass_name)
                   for r in self.rules)


class ParsedFile:
    """One source file: text, AST, and the suppression map.

    ``relparts`` is the normalized path split on separators — what
    passes scope on (suffix / component matching, so fixture trees in
    temp dirs scope exactly like the real repo layout).
    """

    def __init__(self, path: str, text: str, tree: ast.AST):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = tree
        self.relparts = tuple(
            p for p in re.split(r"[\\/]+", os.path.normpath(path)) if p)
        self.suppressions = _collect_suppressions(text)

    # ------------------------------------------------------------ helpers

    def suppression_for(self, finding: Finding) -> Suppression | None:
        sup = self.suppressions.get(finding.line)
        if sup is not None and sup.matches(finding):
            return sup
        return None

    def in_dir(self, *names: str) -> bool:
        """True when any of ``names`` appears as a path component."""
        return any(n in self.relparts for n in names)

    def endswith(self, suffix: str) -> bool:
        """Suffix match on path components: ``endswith("serving/ingest.py")``."""
        want = tuple(p for p in suffix.split("/") if p)
        return self.relparts[-len(want):] == want

    def module_key(self) -> str:
        """Last two components — 'serving/ingest.py' — for messages."""
        return "/".join(self.relparts[-2:])


def _collect_suppressions(text: str) -> dict[int, Suppression]:
    """Map line -> Suppression.  A comment-only line's suppression also
    covers the next non-blank line (for statements too long to carry an
    end-of-line comment)."""
    out: dict[int, Suppression] = {}
    pending: Suppression | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        stripped = raw.strip()
        m = _SUPPRESS_RE.search(raw)
        if m:
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            sup = Suppression(lineno, rules, m.group(2).strip())
            out[lineno] = sup
            if stripped.startswith("#"):
                pending = sup          # standalone: covers next stmt line
            continue
        if pending is not None and stripped:
            out.setdefault(lineno, dataclasses.replace(pending,
                                                       line=lineno))
            pending = None
    return out


def parse_source(path: str, text: str) -> ParsedFile:
    return ParsedFile(path, text, ast.parse(text, filename=path))


def parse_file(path: str) -> ParsedFile:
    with tokenize.open(path) as fh:    # honors coding declarations
        return parse_source(path, fh.read())


# --------------------------------------------------------------- AST utils

def attr_chain(node: ast.AST) -> tuple[str, ...]:
    """('self', '_wal', 'append') for ``self._wal.append`` — empty tuple
    when the expression isn't a pure Name/Attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def call_name(node: ast.Call) -> tuple[str, ...]:
    """The callee's attribute chain (may be empty for computed calls)."""
    return attr_chain(node.func)


class LintPass:
    """Base pass: subclass, set ``name``/``description``, implement
    ``check_file`` (or override ``run`` for cross-file analyses) and
    register with ``repro_torch.analysis.registry.register``.  ``rules``
    names every rule id the pass can emit (the CLI catalog)."""

    name: str = ""
    description: str = ""
    rules: tuple[str, ...] = ()

    def applies(self, pf: ParsedFile) -> bool:
        return True

    def check_file(self, pf: ParsedFile) -> list[Finding]:
        return []

    def run(self, files: list[ParsedFile]) -> list[Finding]:
        out: list[Finding] = []
        for pf in files:
            if self.applies(pf):
                out.extend(self.check_file(pf))
        return out

    # helper so passes stamp their own name consistently
    def finding(self, rule: str, pf: ParsedFile, line: int,
                message: str, severity: str = "error") -> Finding:
        return Finding(rule=rule, path=pf.path, line=line,
                       message=message, severity=severity,
                       pass_name=self.name)
