"""graphlint CLI for the port: run the repo-native invariant checkers.

Usage:
  python -m repro_torch.analysis [PATHS...]        # default: src/repro_torch
  python -m repro_torch.analysis --list            # rule catalog
  python -m repro_torch.analysis --select host-sync src/repro_torch
  python -m repro_torch.analysis --format json src/repro_torch

Exit codes: 0 = clean (suppressed findings allowed), 1 = unsuppressed
findings, 2 = usage / internal error.  Suppress a justified false
positive on its line with ``# graphlint: ignore[rule] <reason>`` —
suppressions are counted and reported, not hidden.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.driver import analyze_paths
from repro_torch.analysis.registry import rule_catalog

#: the port's own tree
DEFAULT_TARGET = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze "
                         f"(default: {DEFAULT_TARGET})")
    ap.add_argument("--select", default=None,
                    help="comma-separated pass names or rule ids")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print each suppressed finding + reason")
    ap.add_argument("--list", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list:
        rows = rule_catalog()
        width = max(len(r[1]) for r in rows)
        pw = max(len(r[0]) for r in rows)
        for pass_name, rule, desc in rows:
            print(f"{pass_name:<{pw}}  {rule:<{width}}  {desc}")
        return 0

    paths = args.paths or [DEFAULT_TARGET]
    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)
    try:
        report = analyze_paths(paths, select)
    except KeyError as exc:
        print(f"graphlint: {exc.args[0]}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(report.render_text(
            verbose_suppressed=args.show_suppressed))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
