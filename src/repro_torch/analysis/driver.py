"""graphlint driver: collect files, run passes, apply suppressions.

The CLI (``python -m repro_torch.analysis``) and the tests come through
``analyze_paths``; tests drive ``analyze_files`` with in-memory
sources.  A file that fails to parse yields a single ``parse-error``
finding instead of aborting the run — the syntax gate proper stays
ruff/compileall's job (``scripts/ci_lint.py``).
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.analysis.base import Finding, ParsedFile, parse_file
from repro_torch.analysis.registry import create_passes

__all__ = ["Report", "analyze_paths", "analyze_files", "collect_files"]

_SKIP_DIRS = {".git", "__pycache__", ".ruff_cache", ".pytest_cache",
              "node_modules", ".venv"}


@dataclasses.dataclass
class Report:
    """Outcome of one analysis run."""

    findings: list[Finding]              # active (unsuppressed)
    suppressed: list[tuple[Finding, str]]  # (finding, reason)
    files: int

    @property
    def ok(self) -> bool:
        return not self.findings

    def counts_by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def suppressed_by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f, _reason in self.suppressed:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def render_text(self, *, verbose_suppressed: bool = False) -> str:
        lines = [f.render() for f in
                 sorted(self.findings, key=lambda f: (f.path, f.line))]
        if verbose_suppressed:
            for f, reason in sorted(self.suppressed,
                                    key=lambda fr: (fr[0].path,
                                                    fr[0].line)):
                lines.append(f"{f.path}:{f.line}: suppressed[{f.rule}]"
                             f" {reason or '(no reason given)'}")
        n_sup = len(self.suppressed)
        sup_counts = self.suppressed_by_rule()
        sup_txt = ("" if not n_sup else " (" + ", ".join(
            f"{r}: {n}" for r, n in sorted(sup_counts.items())) + ")")
        lines.append(
            f"graphlint: {len(self.findings)} finding"
            f"{'s' if len(self.findings) != 1 else ''}, "
            f"{n_sup} suppressed{sup_txt}, {self.files} files")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "suppressed": [dict(dataclasses.asdict(f), reason=r)
                           for f, r in self.suppressed],
            "files": self.files,
            "ok": self.ok,
        }


def collect_files(paths: list[str]) -> list[str]:
    """Expand files/directories into a sorted .py file list."""
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            out.extend(os.path.join(dirpath, f) for f in sorted(files)
                       if f.endswith(".py"))
    # stable order, duplicates dropped
    seen: set[str] = set()
    uniq = []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def analyze_files(files: list[ParsedFile],
                  select: list[str] | None = None,
                  parse_errors: list[Finding] | None = None) -> Report:
    passes = create_passes(select)
    raw: list[Finding] = list(parse_errors or [])
    for ps in passes:
        raw.extend(ps.run(files))
    by_path = {pf.path: pf for pf in files}
    active: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    for f in raw:
        pf = by_path.get(f.path)
        sup = pf.suppression_for(f) if pf is not None else None
        if sup is not None:
            suppressed.append((f, sup.reason))
        else:
            active.append(f)
    return Report(findings=active, suppressed=suppressed,
                  files=len(files))


def analyze_paths(paths: list[str],
                  select: list[str] | None = None) -> Report:
    files: list[ParsedFile] = []
    parse_errors: list[Finding] = []
    for path in collect_files(paths):
        try:
            files.append(parse_file(path))
        except SyntaxError as exc:
            parse_errors.append(Finding(
                rule="parse-error", path=path, line=exc.lineno or 1,
                message=f"file does not parse: {exc.msg}",
                pass_name="driver"))
    return analyze_files(files, select, parse_errors)
