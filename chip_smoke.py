#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build the kernels, hold each
against its plain PyTorch version, and run the in-memory GraphSession
end to end on both layouts.

    python3 chip_smoke.py                 # full size, one card
    python3 chip_smoke.py --dense-nodes 1024 --edge-nodes 4096   # quick

Phases, in order (any failure exits non-zero):

1. build — compile the four kernels (``repro_torch.kernels.build``) and
   print the card's name and power limit as nvidia-smi reports them;
2. kernels — call each kernel's wrapper at the shapes the sessions
   launch, on the sessions' own data, and require bit-equality with the
   plain version; time both (CUDA events) beside the HBM byte bound;
3. dense session — ``GraphSession(n_cap=8192, layout="dense")`` ingests
   the paper's Table 3 evolution parameters in several flushed batches,
   then a mixed ``query_many`` (point / diff / agg, node and global,
   degree_distribution and triangles), sweeps and a snapshot;
4. edge session — the same at ``n_cap=131072``, ``layout="edge"``.

Phases 3 and 4 zero the launch counters before driving the session and
read them after: each kernel the layout should use must have launched.
A sample of the answers must equal, bit for bit, those of the same
session built with ``device="cpu"`` from the same ops; triangle counts
are checked against a sparse count of the snapshot.

The second-to-last line is ``{"kernels": [...], "phases": {...}}``; the
last is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# NVIDIA's data-sheet rate for float32 outside the tensor cores, the
# nearest published rate for 32-bit scalar work; the kernels do int32
# compares, atomics and adds, one per in-window entry per query and one
# per output element.
SCALAR_OPS_PER_S = 67e12
PAPER_PARAMS = dict(m_attach=6, lam_extra=2.2, lam_remove=3.61,
                    events_per_unit=8)      # paper Table 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> int:
    log(f"chip_smoke: FAILED: {msg}")
    return 1


# ---------------------------------------------------------------------------
# Workload: one op stream and one query mix per session
# ---------------------------------------------------------------------------


def make_ops(n_nodes: int, seed: int):
    from repro_torch.core.generate import EvolutionParams, generate_ops
    return generate_ops(n_nodes, EvolutionParams(**PAPER_PARAMS), seed)


def batches(ops, n_batches: int):
    """Split the stream at time-unit boundaries into ``n_batches``."""
    t_max = ops[-1].t
    cuts = [t_max * (i + 1) // n_batches for i in range(n_batches)]
    out, lo = [], 0
    for hi in cuts:
        out.append([(o.op, o.u, o.v, o.t) for o in ops if lo < o.t <= hi])
        lo = hi
    return [b for b in out if b]


def query_mix(t_cur: int, n_nodes: int, dense: bool, seed: int):
    """The mixed batch: (Query kwargs, include in the CPU sample)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vs = [int(x) for x in rng.integers(0, n_nodes // 4, size=12)]
    ts = [max(1, int(t_cur * f)) for f in (0.2, 0.35, 0.5, 0.65, 0.8, 0.95)]
    ta = max(1, int(t_cur * 0.6))        # clustered agg windows
    qs = []
    for i, t in enumerate(ts):
        qs.append((dict(kind="point", scope="node", measure="degree",
                        t_k=t, v=vs[i]), True))
    for i in range(3):
        qs.append((dict(kind="diff", scope="node", measure="degree",
                        t_k=ts[i], t_l=ts[i + 3], v=vs[6 + i]), True))
    for i, agg in enumerate(("mean", "min", "max", "mean")):
        qs.append((dict(kind="agg", scope="node", measure="degree",
                        t_k=ta + i, t_l=ta + i + 7, v=vs[i + 8], agg=agg),
                   True))
    for m, t in (("num_edges", ts[2]), ("num_nodes", ts[3]),
                 ("density", ts[4]), ("avg_degree", ts[1])):
        qs.append((dict(kind="point", scope="global", measure=m, t_k=t),
                   True))
    qs.append((dict(kind="point", scope="global",
                    measure="degree_distribution", t_k=ts[3]), True))
    qs.append((dict(kind="diff", scope="global", measure="num_edges",
                    t_k=ts[0], t_l=ts[5]), True))
    qs.append((dict(kind="agg", scope="global", measure="avg_degree",
                    t_k=ta, t_l=ta + 5, agg="mean"), True))
    qs.append((dict(kind="evolve", scope="global", measure="num_edges",
                    t_k=ts[0], t_l=ts[4], stride=max(1, t_cur // 40)),
               True))
    if dense:
        # dense-only measures: the N² kernel path (not in the CPU sample
        # — O(N³) products on the host; triangles are checked sparsely)
        qs.append((dict(kind="point", scope="global", measure="triangles",
                        t_k=ts[2]), False))
        qs.append((dict(kind="point", scope="global", measure="triangles",
                        t_k=ts[5]), False))
        qs.append((dict(kind="point", scope="global",
                        measure="num_components", t_k=ts[4]), False))
        qs.append((dict(kind="point", scope="node", measure="neighborhood2",
                        t_k=ts[3], v=vs[0]), False))
    return qs


def sweeps(t_cur: int, v: int):
    lo = max(1, t_cur // 5)
    stride = max(1, t_cur // 48)
    return [dict(measure="avg_degree", t_lo=lo, t_hi=t_cur, stride=stride),
            dict(measure="degree", t_lo=lo, t_hi=t_cur, stride=stride, v=v),
            dict(measure="degree_distribution", t_lo=lo, t_hi=t_cur,
                 stride=stride * 4)]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()                                   # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def in_window(t_col, lo, hi) -> int:
    """Σ over queries of the entries whose time falls in (lo_q, hi_q]
    — the atomics this run's data needs."""
    t = t_col.view(1, -1)
    return int(((t > lo.view(-1, 1)) & (t <= hi.view(-1, 1))).sum())


def kernel_cases(dense_store, edge_store, dense_q, edge_q):
    """The four kernels' inputs as the sessions' groups build them."""
    import torch

    from repro_torch.core.reconstruct import window_of
    from repro_torch.kernels.degree_series import (TILE as DS_TILE,
                                                   bucket_node_events,
                                                   degree_series_kernel,
                                                   degree_series_ref)
    from repro_torch.kernels.delta_apply import (TILE as DA_TILE,
                                                 bucket_ops, delta_apply,
                                                 delta_apply_ref)
    from repro_torch.kernels.edge_delta_apply import (
        TILE as EA_TILE, bucket_slot_ops, edge_delta_apply,
        edge_delta_apply_ref)
    from repro_torch.kernels.evolve_sweep import (TILE as SW_TILE,
                                                  bucket_sweep_events,
                                                  sweep_series,
                                                  sweep_series_ref)
    from repro_torch.kernels.evolve_sweep.ops import _start_state
    from repro_torch.core.reconstruct import reconstruct_edge_many

    dev = dense_store.device
    cases = []

    # B1: a dense two-phase point group (the dense-only global measures)
    ts = sorted({q["t_k"] for q, _ in dense_q
                 if q["measure"] in ("triangles", "num_components")})
    t_cur = dense_store.t_cur
    tq = torch.tensor(ts, dtype=torch.int32, device=dev)
    ta = torch.full_like(tq, t_cur)
    d = dense_store.delta_view().window_delta(min(ts), t_cur)
    n = dense_store.n_cap
    ent, tst = bucket_ops(d, n, *window_of(ta, tq))
    adj = dense_store.current.adj
    cases.append(dict(
        name="delta_apply", route="cuda",
        source="src/repro_torch/kernels/delta_apply/delta_apply.cu",
        replaces="src/repro/kernels/delta_apply/delta_apply.py:52",
        kernel=lambda: delta_apply(adj, ent, tst, ta, tq),
        plain=lambda: delta_apply_ref(adj, ent, tst, ta, tq, None, DA_TILE),
        bytes=nbytes(adj, ent, tst, ta, tq) + len(ts) * n * n,
        ops=in_window(ent[:, 1], torch.minimum(ta, tq),
                      torch.maximum(ta, tq)) + len(ts) * n * n,
        shape=f"Q={len(ts)} N={n} entries={ent.shape[0]}"))

    # B2: an edge two-phase point group (node degree at six times)
    ts = sorted({q["t_k"] for q, _ in edge_q if q["kind"] == "point"})
    t_cur = edge_store.t_cur
    tq = torch.tensor(ts, dtype=torch.int32, device=dev)
    ta = torch.full_like(tq, t_cur)
    d = edge_store.delta_view().window_delta(min(ts), t_cur)
    cur = edge_store.current_edge_snapshot()
    e = cur.e_cap
    ent2, tst2 = bucket_slot_ops(d, e, *window_of(ta, tq))
    cases.append(dict(
        name="edge_delta_apply", route="cuda",
        source="src/repro_torch/kernels/edge_delta_apply/"
               "edge_delta_apply.cu",
        replaces="src/repro/kernels/edge_delta_apply/"
                 "edge_delta_apply.py:53",
        kernel=lambda: edge_delta_apply(cur.emask, ent2, tst2, ta, tq),
        plain=lambda: edge_delta_apply_ref(cur.emask, ent2, tst2, ta, tq,
                                           EA_TILE),
        bytes=nbytes(cur.emask, ent2, tst2, ta, tq) + len(ts) * e,
        ops=in_window(ent2[:, 1], torch.minimum(ta, tq),
                      torch.maximum(ta, tq)) + len(ts) * e,
        shape=f"Q={len(ts)} E={e} entries={ent2.shape[0]}"))

    # B3: the hybrid agg group's shared degree series
    aggs = [q for q, _ in edge_q if q["kind"] == "agg"
            and q["scope"] == "node"]
    t0 = min(q["t_k"] for q in aggs)
    w_total = 1 << (max(q["t_l"] for q in aggs) - t0).bit_length()
    d3 = edge_store.delta_view().window_delta(t0, None)
    nn = cur.n_cap
    ev3, ts3 = bucket_node_events(d3, nn, t0, w_total)
    deg = cur.degrees()
    cases.append(dict(
        name="degree_series", route="cuda",
        source="src/repro_torch/kernels/degree_series/degree_series.cu",
        replaces="src/repro/kernels/degree_series/degree_series.py:57",
        kernel=lambda: degree_series_kernel(deg, ev3, ts3, w_total),
        plain=lambda: degree_series_ref(deg, ev3, ts3, w_total, DS_TILE),
        bytes=nbytes(deg, ev3, ts3) + w_total * nn * 4,
        ops=ev3.shape[0] + w_total * nn,
        shape=f"B={w_total} N={nn} events={ev3.shape[0]}"))

    # B4: a sweep group's degree series (the session's degree sweep)
    sw = sweeps(t_cur, 0)[1]
    lo, hi, stride = sw["t_lo"], sw["t_hi"], sw["stride"]
    width = (hi - lo) // stride + 1
    nb = 1 << (width - 1).bit_length()
    t_lo = torch.tensor([lo], dtype=torch.int32, device=dev)
    t_last = t_lo + (width - 1) * stride
    g = reconstruct_edge_many(cur, edge_store.delta_view().window_delta(
        lo, t_cur, merged=True), t_cur, t_lo)
    deg0 = _start_state(g, dense=False)[0]
    d4 = edge_store.delta_view().window_delta(lo, int(t_last))
    ev4, ts4 = bucket_sweep_events(d4, nn, lo, int(t_last))
    cases.append(dict(
        name="sweep_series", route="cuda",
        source="src/repro_torch/kernels/evolve_sweep/sweep.cu",
        replaces="src/repro/kernels/evolve_sweep/sweep.py:100",
        kernel=lambda: sweep_series(deg0, ev4, ts4, t_lo, t_last, stride,
                                    nb),
        plain=lambda: sweep_series_ref(deg0, ev4, ts4, t_lo, t_last, stride,
                                       nb, SW_TILE),
        bytes=nbytes(deg0, ev4, ts4, t_lo, t_last) + nb * nn * 4,
        ops=in_window(ev4[:, 1], t_lo, t_last) + nb * nn,
        shape=f"Q=1 B={nb} N={nn} events={ev4.shape[0]}"))
    return cases


def phase_kernels(cases) -> list[dict]:
    import torch
    rows = []
    for c in cases:
        out_k = c["kernel"]()
        torch.cuda.synchronize()
        out_p = c["plain"]()
        torch.cuda.synchronize()
        if out_k.shape != out_p.shape or out_k.dtype != out_p.dtype:
            raise AssertionError(f"{c['name']}: kernel {tuple(out_k.shape)}"
                                 f" {out_k.dtype} vs plain "
                                 f"{tuple(out_p.shape)} {out_p.dtype}")
        err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs()
                  .max()) if out_k.numel() else 0
        ms = cuda_ms(c["kernel"], 20)
        plain_ms = cuda_ms(c["plain"], 3)
        bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = c["ops"] / SCALAR_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows.append(dict(name=c["name"], route=c["route"],
                         source=c["source"], replaces=c["replaces"],
                         launches=0, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations", library_ms=None,
                         bytes=c["bytes"], ops=c["ops"],
                         shape=c["shape"]))
        print(f"kernel {c['name']}: {c['shape']}  {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms  "
              f"max_abs_err {err} (tolerance: bit-exact)", flush=True)
        if err:
            raise AssertionError(f"{c['name']} disagrees with its plain "
                                 f"version (max abs err {err})")
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4: the sessions
# ---------------------------------------------------------------------------


def run_session(ops, n_cap: int, layout: str, device: str, qmix, sw,
                e_cap=None, sample_only: bool = False):
    """Ingest in flushed batches, then the mixed batch, sweeps and a
    snapshot.  Returns (answers, sweep answers, snapshot, stats,
    session, seconds per step)."""
    from repro_torch.api import GraphSession
    from repro_torch.core.plans import Query
    import torch
    steps = {}

    def step(name, t0):
        if device == "cuda":
            torch.cuda.synchronize()
        steps[name] = steps.get(name, 0.0) + time.perf_counter() - t0

    s = GraphSession(n_cap=n_cap, e_cap=e_cap, layout=layout, device=device,
                     slow_query_ms=None)
    for b in batches(ops, 4):
        t0 = time.perf_counter()
        s.ingest(b)
        step("ingest_s", t0)
        t0 = time.perf_counter()
        s.flush()
        step("flush_s", t0)
    qs = [Query(**q) for q, in_sample in qmix if in_sample or not sample_only]
    t0 = time.perf_counter()
    answers = s.query_many(qs)
    step("query_many_s", t0)
    t0 = time.perf_counter()
    sweep_out = [s.sweep(**w) for w in sw]
    step("sweeps_s", t0)
    t0 = time.perf_counter()
    snap = s.snapshot_at(qmix[0][0]["t_k"])
    step("snapshot_s", t0)
    return answers, sweep_out, snap, s.stats(), s, steps


def same(a, b) -> bool:
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def sparse_triangles(adj) -> int:
    import numpy as np
    import scipy.sparse as sp
    a = sp.csr_matrix(adj.cpu().numpy().astype(np.int64))
    return int((a @ a).multiply(a).sum() // 6)


def phase_session(name: str, ops, n_cap: int, layout: str, seed: int,
                  expect: dict, e_cap=None) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import build
    t_cur = ops[-1].t
    qmix = query_mix(t_cur, n_cap, layout == "dense", seed)
    sw = sweeps(t_cur, qmix[0][0]["v"])
    build.reset_launches()
    t0 = time.perf_counter()
    answers, sweep_out, snap, stats, s, steps = run_session(
        ops, n_cap, layout, "cuda", qmix, sw, e_cap=e_cap)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    print(f"{name} session: {len(ops)} ops, t_cur {stats['t_cur']}, "
          f"{len(answers)} queries + {len(sw)} sweeps + snapshot in "
          f"{seconds:.2f} s ({', '.join(f'{k} {v:.3f}' for k, v in steps.items())})"
          f"; launches {launches}", flush=True)
    for k, want in expect.items():
        if want and launches[k] == 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
        if not want and launches[k] != 0:
            raise AssertionError(f"{name}: kernel {k} launched "
                                 f"{launches[k]} times on a path that "
                                 "must not use it")
    for (q, _), a in zip(qmix, answers):
        arr = np.asarray(a)
        if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
            raise AssertionError(f"{name}: non-finite answer for {q}")
        if q["measure"] == "degree_distribution" and arr.shape != (65,):
            raise AssertionError(f"{name}: histogram shape {arr.shape}")
    for q, a in zip([q for q, _ in qmix], answers):
        if q["measure"] == "triangles":
            g = s.snapshot_at(q["t_k"])
            want = sparse_triangles(g.adj)
            if int(a) != want:
                raise AssertionError(f"{name}: triangles {int(a)} != "
                                     f"sparse count {want} at {q}")
    # the same session on the CPU, sampled answers only
    t1 = time.perf_counter()
    c_ans, c_sw, c_snap, c_stats, _, _ = run_session(
        ops, n_cap, layout, "cpu", qmix, sw, e_cap=e_cap, sample_only=True)
    cpu_seconds = time.perf_counter() - t1
    gpu_sample = [a for (q, keep), a in zip(qmix, answers) if keep]
    n_cmp = len(gpu_sample) + len(sw) + 2
    bad = [q for (q, _), x, y in zip([m for m in qmix if m[1]], gpu_sample,
                                      c_ans) if not same(x, y)]
    bad += [w for w, x, y in zip(sw, sweep_out, c_sw) if not same(x, y)]
    if not same(snap.nodes.cpu(), c_snap.nodes):
        bad.append("snapshot nodes")
    served = {k: v for k, v in stats.items() if not k.startswith("cache_")}
    if served != {k: c_stats[k] for k in served}:
        bad.append(("stats", stats, c_stats))
    if bad:
        raise AssertionError(f"{name}: GPU and CPU answers differ: {bad}")
    print(f"{name} session: {n_cmp} sampled answers equal the CPU port "
          f"bit for bit (CPU side {cpu_seconds:.2f} s)", flush=True)
    return dict(seconds=seconds, cpu_seconds=cpu_seconds, steps=steps,
                launches=launches, n_ops=len(ops), t_cur=stats["t_cur"],
                queries=len(answers), compared=n_cmp, stats=stats)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dense-nodes", type=int, default=8192)
    ap.add_argument("--edge-nodes", type=int, default=131072)
    ap.add_argument("--edge-e-cap", type=int, default=1 << 21)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "chip_smoke.json"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.core.store import TemporalGraphStore
    except ImportError as exc:
        return fail(f"the repository's port is not beside this script "
                    f"({exc})")
    if torch.backends.cuda.matmul.allow_tf32:
        return fail("TF32 matmul is on; the f32 measures need it off")
    phases = {}

    t0 = time.perf_counter()
    build.ext()
    phases["build_s"] = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"build: {phases['build_s']:.1f} s", flush=True)
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    dense_ops = make_ops(args.dense_nodes, args.seed)
    edge_ops = make_ops(args.edge_nodes, args.seed)
    phases["generate_s"] = time.perf_counter() - t0

    # phase 2 — stores built from the sessions' op streams
    t0 = time.perf_counter()
    stores = []
    for ops, n, layout, e_cap in ((dense_ops, args.dense_nodes, "dense",
                                   None),
                                  (edge_ops, args.edge_nodes, "edge",
                                   args.edge_e_cap)):
        st = TemporalGraphStore(n, e_cap=e_cap, layout=layout,
                                device="cuda")
        st.ingest([(o.op, o.u, o.v, o.t) for o in ops])
        st.advance_to(ops[-1].t)
        stores.append(st)
    dense_q = query_mix(dense_ops[-1].t, args.dense_nodes, True, args.seed)
    edge_q = query_mix(edge_ops[-1].t, args.edge_nodes, False, args.seed)
    cases = kernel_cases(stores[0], stores[1], dense_q, edge_q)
    kernels = phase_kernels(cases)
    del cases, stores
    torch.cuda.empty_cache()
    phases["kernels_s"] = time.perf_counter() - t0

    # phases 3 and 4 — the main path, counters zeroed just before each
    dense = phase_session(
        "dense", dense_ops, args.dense_nodes, "dense", args.seed,
        expect={"delta_apply": True, "edge_delta_apply": True,
                "degree_series": True,
                "sweep_series": True})
    edge = phase_session(
        "edge", edge_ops, args.edge_nodes, "edge", args.seed,
        expect={"delta_apply": False, "edge_delta_apply": True,
                "degree_series": True, "sweep_series": True},
        e_cap=args.edge_e_cap)
    phases["dense_session_s"] = dense["seconds"]
    phases["dense_cpu_s"] = dense["cpu_seconds"]
    phases["edge_session_s"] = edge["seconds"]
    phases["edge_cpu_s"] = edge["cpu_seconds"]
    for k in kernels:
        k["launches"] = dense["launches"][k["name"]] + \
            edge["launches"][k["name"]]
        k["launches_dense"] = dense["launches"][k["name"]]
        k["launches_edge"] = edge["launches"][k["name"]]
        print(f"kernel {k['name']}: {k['ms']:.4f} ms  plain "
              f"{k['plain_ms']:.4f} ms  bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})  launches {k['launches']} (dense "
              f"{k['launches_dense']}, edge {k['launches_edge']})",
              flush=True)

    report = dict(card=smi, torch=torch.__version__,
                  cuda=torch.version.cuda, kernels=kernels, phases=phases,
                  dense=dense, edge=edge, args=vars(args))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels, "phases": phases}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
