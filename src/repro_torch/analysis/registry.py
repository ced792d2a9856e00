"""Pass registry: passes self-register at import, the driver resolves
names (``--select``) against it.  Importing ``repro_torch.analysis.passes``
pulls in every built-in pass exactly once."""
from __future__ import annotations

from repro_torch.analysis.base import LintPass

__all__ = ["register", "all_passes", "create_passes", "rule_catalog"]

_PASSES: dict[str, type[LintPass]] = {}


def register(cls: type[LintPass]) -> type[LintPass]:
    if not cls.name:
        raise ValueError(f"pass {cls.__name__} has no name")
    if _PASSES.get(cls.name) not in (None, cls):
        raise ValueError(f"duplicate pass name {cls.name!r}")
    _PASSES[cls.name] = cls
    return cls


def _load_builtin() -> None:
    # registration side effect; idempotent
    import repro_torch.analysis.passes  # noqa: F401


def all_passes() -> dict[str, type[LintPass]]:
    _load_builtin()
    return dict(_PASSES)


def create_passes(select: list[str] | None = None) -> list[LintPass]:
    """Instantiate passes — all of them, or the ``select`` subset (by
    pass name or by a rule id a pass owns)."""
    avail = all_passes()
    if not select:
        return [cls() for cls in avail.values()]
    out: list[LintPass] = []
    for name in select:
        cls = avail.get(name)
        if cls is None:
            cls = next((c for c in avail.values() if name in c.rules),
                       None)
        if cls is None:
            known = sorted(avail)
            raise KeyError(f"unknown pass/rule {name!r} (known passes: "
                           f"{', '.join(known)})")
        if cls not in [type(p) for p in out]:
            out.append(cls())
    return out


def rule_catalog() -> list[tuple[str, str, str]]:
    """(pass name, rule id, description) rows for --list / docs."""
    rows = []
    for name, cls in sorted(all_passes().items()):
        for rule in cls.rules:
            rows.append((name, rule, cls.description))
    return rows
