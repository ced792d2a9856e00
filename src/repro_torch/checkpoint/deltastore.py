"""Delta-based checkpointing: the paper's storage model on training
state — counterpart of ``repro/checkpoint/deltastore.py``, writing and
reading the same files.

Mapping onto the paper:

  graph G            →  training state (params + optimizer state)
  time unit t        →  training step
  update op (op, t)  →  per-tensor state *transition*, encoded as the
                        mod-2^w difference of raw bit patterns — exactly
                        invertible both directions (Definition 5), and
                        the delta chain is complete (Definition 4): any
                        logged step is reconstructable bit-exactly
  SG_tcur + Δ        →  latest state + chain of interval deltas
  materialized SG_t  →  full checkpoints chosen by the paper's policies
                        (periodic / op-count / similarity)
  Theorem 1          →  restore = nearest materialized snapshot (time-
                        or operation-based selection) + forward/backward
                        chain application

The deltas are taken on the host, on integer views of the arrays as the
npz holds them (bfloat16 as its uint16 bits), so a delta file is
byte-equal to the JAX package's for the same leaf.  A root written by
the JAX package (its tree-path leaf names, groups stacked) restores
into the port's state through ``repro_torch.convert``.  The policies
count a stacked int8 leaf's one scale once (``io.stacked_copy``), so
both packages' stores materialize at the same steps.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Literal

import numpy as np

from repro_torch.checkpoint import io

_BITS = {2: np.uint16, 4: np.uint32, 8: np.uint64, 1: np.uint8}


def _bit_delta(new: np.ndarray, old: np.ndarray) -> np.ndarray:
    """Invertible transition encoding: (bits(new) − bits(old)) mod 2^w."""
    u = _BITS[new.dtype.itemsize]
    return (new.view(u) - old.view(u)).view(u)


def _apply_bits(base: np.ndarray, delta: np.ndarray,
                forward: bool) -> np.ndarray:
    u = delta.dtype
    b = base.view(u)
    out = (b + delta) if forward else (b - delta)
    return out.view(base.dtype)


def _as_f32(key: str, a: np.ndarray) -> np.ndarray:
    """An npz entry's values in float32 (``::bf16`` bits widened)."""
    if key.endswith(io.BF16):
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _plain(key: str) -> str:
    return key[:-len(io.BF16)] if key.endswith(io.BF16) else key


@dataclasses.dataclass
class DeltaPolicy:
    """When to materialize a full snapshot (paper §2.2 Discussion)."""
    kind: Literal["periodic", "opcount", "similarity"] = "periodic"
    period: int = 10            # periodic: every N deltas
    op_budget: float = 1e9     # opcount: Σ|changed elements| threshold
    drift: float = 0.05         # similarity: rel. L2 drift threshold


class DeltaCheckpointStore:
    """Current state + invertible delta chain + materialized snapshots.

    Layout under ``root``:
      manifest.json                — steps, anchors, chain metadata
      current.npz                  — SG_tcur (latest state)
      snapshots/step_<n>.npz       — materialized snapshots
      deltas/d_<a>_<b>.npz         — Δ between logged steps a < b
    """

    def __init__(self, root: str, policy: DeltaPolicy | None = None):
        self.root = root
        self.policy = policy or DeltaPolicy()
        os.makedirs(os.path.join(root, "snapshots"), exist_ok=True)
        os.makedirs(os.path.join(root, "deltas"), exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)
        else:
            self.manifest = {"steps": [], "snapshots": [],
                             "deltas": [], "ops_since_snap": 0.0,
                             "current_step": None}

    # ------------------------------------------------------------- save

    def save(self, step: int, state) -> None:
        """Log ``state`` at ``step`` (paper Algorithm 3: apply the new
        interval delta, append it, maybe materialize)."""
        cur_path = os.path.join(self.root, "current.npz")
        prev_step = self.manifest["current_step"]
        flat_new = io.raw_arrays(state)

        if prev_step is None:
            np.savez(cur_path, **flat_new)
            self._materialize(step, cur_path)
        else:
            flat_old = io.load_raw(cur_path)
            deltas = {}
            changed = 0.0
            drift_num = 0.0
            drift_den = 0.0
            for k, new in flat_new.items():
                old = flat_old[k]
                d = _bit_delta(new, old)
                deltas[_plain(k)] = d
                if io.stacked_copy(k):
                    continue
                changed += float(np.count_nonzero(d))
                nf = _as_f32(k, new)
                of = _as_f32(k, old)
                drift_num += float(np.sum((nf - of) ** 2))
                drift_den += float(np.sum(of ** 2))
            dpath = os.path.join(self.root, "deltas",
                                 f"d_{prev_step}_{step}.npz")
            np.savez(dpath, **deltas)
            self.manifest["deltas"].append([prev_step, step])
            np.savez(cur_path, **flat_new)
            self.manifest["ops_since_snap"] += changed
            if self._should_materialize(drift_num, drift_den):
                self._materialize(step, cur_path)
        self.manifest["current_step"] = step
        self.manifest["steps"].append(step)
        self._write_manifest()

    def _should_materialize(self, drift_num, drift_den) -> bool:
        p = self.policy
        n_since = len(self.manifest["steps"]) - self._last_snap_index()
        if p.kind == "periodic":
            return n_since >= p.period
        if p.kind == "opcount":
            return self.manifest["ops_since_snap"] >= p.op_budget
        rel = (drift_num / drift_den) ** 0.5 if drift_den > 0 else 1.0
        return rel >= p.drift

    def _last_snap_index(self) -> int:
        if not self.manifest["snapshots"]:
            return 0
        last = self.manifest["snapshots"][-1]
        return self.manifest["steps"].index(last) + 1

    def _materialize(self, step: int, cur_path: str) -> None:
        shutil.copy(cur_path,
                    os.path.join(self.root, "snapshots",
                                 f"step_{step}.npz"))
        self.manifest["snapshots"].append(step)
        self.manifest["ops_since_snap"] = 0.0

    def _write_manifest(self) -> None:
        with open(self._manifest_path, "w") as f:
            json.dump(self.manifest, f)

    # ---------------------------------------------------------- restore

    def _chain(self, a: int, b: int) -> list[tuple[int, int, bool]]:
        """Delta files linking logged steps a → b.
        Returns [(lo, hi, forward)]."""
        steps = self.manifest["steps"]
        ia, ib = steps.index(a), steps.index(b)
        if ia <= ib:
            return [(steps[i], steps[i + 1], True)
                    for i in range(ia, ib)]
        return [(steps[i - 1], steps[i], False)
                for i in range(ia, ib, -1)]

    def select_anchor(self, step: int,
                      method: Literal["time", "ops"] = "ops") -> int:
        """Paper §2.2: time-based vs operation-based selection among
        materialized snapshots ∪ {current}."""
        steps = self.manifest["steps"]
        anchors = list(self.manifest["snapshots"])
        if self.manifest["current_step"] is not None:
            anchors.append(self.manifest["current_step"])
        if method == "time":
            costs = [abs(step - a) for a in anchors]
        else:
            costs = [abs(steps.index(step) - steps.index(a))
                     for a in anchors]
        return anchors[int(np.argmin(costs))]

    def restore_raw(self, step: int,
                    method: Literal["time", "ops"] = "ops"
                    ) -> dict[str, np.ndarray]:
        """The arrays logged at ``step`` (a logged step), named as the
        root's npz names them."""
        anchor = self.select_anchor(step, method)
        if anchor == self.manifest["current_step"]:
            path = os.path.join(self.root, "current.npz")
        else:
            path = os.path.join(self.root, "snapshots",
                                f"step_{anchor}.npz")
        flat = io.load_raw(path)
        stored = {_plain(k): k for k in flat}
        for (lo, hi, forward) in self._chain(anchor, step):
            dpath = os.path.join(self.root, "deltas",
                                 f"d_{lo}_{hi}.npz")
            with np.load(dpath) as z:
                for k in z.files:
                    flat[stored[k]] = _apply_bits(flat[stored[k]], z[k],
                                                  forward)
        return flat

    def restore(self, step: int, template,
                method: Literal["time", "ops"] = "ops"):
        """Reconstruct the state at ``step`` (must be a logged step) in
        the structure of ``template`` (``checkpoint.io.fill``: a module's
        parameters are overwritten in place)."""
        flat = self.restore_raw(step, method)
        want = {name for name, _ in io.leaves(template)}
        if not want <= {_plain(k) for k in flat}:
            from repro_torch.convert import arrays_from_reference
            flat = arrays_from_reference(flat)
        return io.fill(template, {_plain(k): io.to_tensor(k, a)
                                  for k, a in flat.items()})

    def latest_step(self) -> int | None:
        return self.manifest["current_step"]

    def storage_bytes(self) -> dict:
        def du(d):
            t = 0
            for f in os.listdir(os.path.join(self.root, d)):
                t += os.path.getsize(os.path.join(self.root, d, f))
            return t
        return {"snapshots": du("snapshots"), "deltas": du("deltas")}
