"""Historical queries over training dynamics — counterpart of
``repro/checkpoint/history.py`` (``HistoryLog`` copied: it needs
nothing but numpy and json).

The paper's query taxonomy (Table 1) applied to the training-state
history: *node-centric* = per-tensor measures (a tensor is a node of the
state graph), *global* = whole-model measures.

  point  — "what was layer-3's grad-norm at step 12000?"
  diff   — "how much did the embedding norm change over [a, b]?"
  agg    — "mean loss over [a, b]"

The metric log is the delta here: an append-only, step-annotated record
(exactly an interval delta over scalar measures), so point/diff/agg
queries are delta-only plans — no state reconstruction.  Queries that
need the actual tensors (e.g. "full spectrum of W at step k") fall back
to the two-phase plan: DeltaCheckpointStore.restore + measure.
"""
from __future__ import annotations

import json
import os
from typing import Literal

import numpy as np


class HistoryLog:
    """Append-only (step, {measure: value}) log with window queries."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.steps: list[int] = []
        self.rows: dict[str, list[float]] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            self.steps = d["steps"]
            self.rows = d["rows"]

    def record(self, step: int, metrics: dict[str, float]) -> None:
        self.steps.append(int(step))
        for k, v in metrics.items():
            self.rows.setdefault(k, [float("nan")] * (len(self.steps) - 1))
            self.rows[k].append(float(v))
        for k in self.rows:
            while len(self.rows[k]) < len(self.steps):
                self.rows[k].append(float("nan"))
        if self.path:
            with open(self.path, "w") as f:
                json.dump({"steps": self.steps, "rows": self.rows}, f)

    def _window(self, measure: str, a: int, b: int) -> np.ndarray:
        s = np.asarray(self.steps)
        v = np.asarray(self.rows[measure])
        m = (s >= a) & (s <= b)
        return v[m]

    def point(self, measure: str, step: int) -> float:
        i = self.steps.index(step)
        return self.rows[measure][i]

    def diff(self, measure: str, a: int, b: int) -> float:
        w = self._window(measure, a, b)
        return float(abs(w[-1] - w[0]))

    def agg(self, measure: str, a: int, b: int,
            fn: Literal["mean", "min", "max"] = "mean") -> float:
        w = self._window(measure, a, b)
        return float(getattr(np, fn)(w))


def tensor_measures(params, prefix: str = "") -> dict[str, float]:
    """Per-tensor (node-centric) + whole-model (global) norms, in
    float32, by parameter name; the norms are taken on the parameters'
    device and read back once."""
    import torch

    from repro_torch.checkpoint.io import leaves
    named = list(leaves(params))
    with torch.no_grad():
        norms = torch.stack([torch.linalg.vector_norm(t.float())
                             for _, t in named]).tolist() if named else []
    out = {}
    total = 0.0
    for (key, _), n in zip(named, norms):
        out[f"{prefix}norm/{key}"] = n
        total += n * n
    out[f"{prefix}norm/__global__"] = total ** 0.5
    return out
