"""``chip_smoke.py``'s host side, read on CPU tensors: the kernel
comparison, the design counts, phases 7 and 8 rehearsed at a small
size (root layout, answer comparison, acknowledgements, the crash
child and its arguments), phase 9's replica child, its verdict and
a rehearsal, phase 13's depth, routing readout, verdict, printed
lines and a rehearsal on the reduced mixtral, and phase 14's (whisper
and internvl2: ``phase_family``, ``family_failures``, ``family_lines``,
the generalised ``greedy`` / ``phase_lm`` of phases 5 and 6),
phase 15's (the training launch counts and mixtral's training depth
fixed in advance, phase 11's trainer on the three families, the step-1
route flips, the mesh phase in one gloo process, its serving of the
four families bit-equal to the plain path at world 1, the verdicts), and
phase 16's (jamba-1.5-large's MoE layers with experts of their own
reckoned from the free memory, the shared experts, the launch counts,
routing readout and verdicts rehearsed on the reduced jamba, and
kimi-k2's head dim 112 in phase 2's attention case), and phase 19's
(kimi-k2's depth and float32 check reckoned at published width, the
shared-expert layers, the verdict and lines, a rehearsal on a narrow
kimi-k2 with its 384 experts) with phase 15's training reckonings.

Every kernel case of ``chip_smoke.py`` passes through ``_compare``: a
kernel output that is NaN or infinite where the plain value is finite
must read as an infinite difference, never as none (Python's ``max``
and ``float(t.max())`` let a NaN through as a pass)."""
import importlib.util
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The rehearsals' reduced models are too small to gain from
    intra-op threads, and under ``pytest -n`` a worker's threads spin
    against the other workers' (phase 15 (c)'s rehearsal took 14.2 s on
    one thread and 18.4 s on eight, alone): the port runs this file on
    one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_rule(out):
    """B5's bf16 per-element rule, as ``chip_smoke.attention_case``."""
    return 2.0 ** -7 * out.float().abs() + 2.0 ** -12


PLAIN = torch.tensor([[0.5, -1.25], [0.0, 3.0]], dtype=torch.bfloat16)


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("tol", [bf16_rule, None],
                         ids=["per-element", "bit-exact"])
def test_compare_fails_non_finite_kernel_output(bad, tol):
    kernel = PLAIN.clone()
    kernel[1, 0] = bad
    err, share = chip_smoke._compare(kernel, PLAIN, tol)
    assert err == math.inf and share == math.inf


def test_compare_reads_equal_outputs_as_zero():
    """Equal outputs read 0 even where the allowed difference is 0, and
    one bf16 ulp of the plain value reads at most the whole rule."""
    assert chip_smoke._compare(PLAIN, PLAIN.clone(),
                               lambda out: torch.zeros_like(out.float())
                               ) == (0.0, 0.0)
    ulp = PLAIN.clone()
    ulp[0, 0] = 0.5 + 2.0 ** -8           # the next bf16 above 0.5
    err, share = chip_smoke._compare(ulp, PLAIN, bf16_rule)
    assert err == 2.0 ** -8 and 0 < share <= 1


# ---------------------------------------------------------------------------
# The design counts printed on B1's and B4's kernel lines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_store():
    from repro_torch.core.store import TemporalGraphStore
    ops = chip_smoke.make_ops(300, 7)
    st = TemporalGraphStore(320, layout="dense", device="cpu")
    st.ingest([(o.op, o.u, o.v, o.t) for o in ops])
    st.advance_to(ops[-1].t)
    return st


def test_delta_apply_design_counts_match_bucket_ops(small_store):
    """Tiles without an in-window entry, per query, are the tiles that a
    bucketing of that query's window alone leaves empty."""
    from repro_torch.core.reconstruct import window_of
    from repro_torch.kernels.delta_apply import bucket_ops
    st = small_store
    tc = st.t_cur
    tq = torch.tensor([tc // 5, tc // 2, tc - 1, tc], dtype=torch.int32)
    ta = torch.tensor([tc, tc, tc // 3, tc], dtype=torch.int32)
    d = st.delta_view().window_delta(1, tc)
    ent, tst = bucket_ops(d, st.n_cap, *window_of(ta, tq))
    got = chip_smoke.delta_apply_design(ent, tst, ta, tq)
    counts = (tst[1:] - tst[:-1])
    assert got["tiles"] == counts.numel() == 25
    assert got["entries_per_tile_max"] == int(counts.max())
    assert got["entries_per_tile_mean"] == float(counts.double().mean())
    want = []
    for a, q in zip(ta.tolist(), tq.tolist()):
        _, one = bucket_ops(d, st.n_cap, min(a, q), max(a, q))
        want.append(int(((one[1:] - one[:-1]) == 0).sum()))
    assert got["tiles_without_window_entry"] == want
    assert want[3] == 25 and got["tile_queries_without_window_entry"] \
        == sum(want)


def test_sweep_design_counts_match_work_list(small_store, monkeypatch):
    from repro_torch.kernels.evolve_sweep import (bucket_sweep_events,
                                                  sweep, sweep_work)
    st = small_store
    ev, tst = bucket_sweep_events(st.delta_view().window_delta(1, st.t_cur),
                                  st.n_cap, 1, st.t_cur)
    monkeypatch.setattr(sweep, "CHUNK", 64)
    rows = sweep_work(tst, ev.shape[0])
    got = chip_smoke.sweep_design(tst, ev.shape[0])
    real = rows[rows[:, 0] >= 0]
    sizes = real[:, 2] - real[:, 1]
    assert got["tiles"] == 2 and got["chunk"] == 64
    assert got["events_per_tile_max"] == int((tst[1:] - tst[:-1]).max())
    assert got["blocks_per_query"] == real.shape[0] > 2
    assert got["rows_per_query"] == rows.shape[0] >= real.shape[0]
    assert got["heaviest_block_events"] == int(sizes.max()) <= 64
    split = real[real[:, 3] >= 0]
    assert torch.equal(split[:, 3], split[:, 0])      # a split tile's slot
    assert got["split_tiles"] == int(torch.unique(split[:, 0]).numel()) == 2


def test_edge_delta_apply_design_counts_match_bucket_slot_ops(small_store):
    """B2's counts: tiles, entries per tile and per block (two tiles of
    four warps at four queries) from the bucketing, and per query the
    tiles that a bucketing of that query's window alone leaves empty.
    The slot space is twice the registry, as an edge store's e_cap
    outgrows its registered slots: the second half's blocks hold no
    entry."""
    from repro_torch.core.reconstruct import window_of
    from repro_torch.kernels.edge_delta_apply import (TILE, WARPS,
                                                      bucket_slot_ops)
    st = small_store
    tc = st.t_cur
    e = 2 * st.current_edge_snapshot().e_cap
    tq = torch.tensor([tc // 5, tc // 2, tc - 1, tc], dtype=torch.int32)
    ta = torch.tensor([tc, tc, tc // 3, tc], dtype=torch.int32)
    d = st.delta_view().window_delta(1, tc)
    ent, tst = bucket_slot_ops(d, e, *window_of(ta, tq))
    got = chip_smoke.edge_delta_apply_design(ent, tst, ta, tq)
    counts = (tst[1:] - tst[:-1]).tolist()
    assert got["tiles"] == len(counts) == -(-e // TILE) > WARPS
    assert got["entries_per_tile_max"] == max(counts)
    assert got["entries_per_tile_mean"] == sum(counts) / len(counts)
    # four queries: four warps a tile, two tiles a block
    assert got["warps_per_tile"] == 4
    per_block = [sum(counts[b:b + WARPS // 4])
                 for b in range(0, len(counts), WARPS // 4)]
    assert got["blocks"] == len(per_block) == -(-len(counts) // 2)
    assert got["heaviest_block_entries"] == max(per_block)
    assert got["blocks_without_entry"] == per_block.count(0) >= 4
    want = []
    for a, q in zip(ta.tolist(), tq.tolist()):
        _, one = bucket_slot_ops(d, e, min(a, q), max(a, q))
        want.append(int(((one[1:] - one[:-1]) == 0).sum()))
    assert got["tiles_without_window_entry"] == want
    assert want[3] == len(counts) and got[
        "tile_queries_without_window_entry"] == sum(want)


def test_degree_series_design_counts_match_work_list(small_store,
                                                     monkeypatch):
    """B3's counts come from the sweep's work list over the series'
    events (no upper time bound): a tile past CHUNK is split, and no
    block walks more than CHUNK events."""
    from repro_torch.kernels.evolve_sweep import (bucket_sweep_events,
                                                  sweep, sweep_work)
    st = small_store
    t_k = st.t_cur // 4
    ev, tst = bucket_sweep_events(st.delta_view().window_delta(t_k, None),
                                  st.n_cap, t_k)
    counts = (tst[1:] - tst[:-1]).to(torch.int64)
    assert int((ev[:, 0] > t_k).sum()) == ev.shape[0] == int(counts.sum())
    monkeypatch.setattr(sweep, "CHUNK", 100)
    rows = sweep_work(tst, ev.shape[0])
    got = chip_smoke.sweep_design(tst, ev.shape[0])
    real = rows[rows[:, 0] >= 0]
    sizes = real[:, 2] - real[:, 1]
    assert got["tiles"] == counts.numel() == 2
    assert got["events_per_tile_max"] == int(counts.max()) > 100
    assert got["blocks_per_query"] == real.shape[0] == int(
        torch.clamp((counts + 99) // 100, min=1).sum())
    assert got["heaviest_block_events"] == int(sizes.max()) <= 100
    assert got["split_tiles"] == int((counts > 100).sum())


# ---------------------------------------------------------------------------
# Phases 7 and 8's host side: root layout, answers, acks, the crash child
# ---------------------------------------------------------------------------


N_DURABLE = 256


def _memory(layout, n, ops, qmix, sw):
    """What phase 3 / 4 hands phase 7: the in-memory session's answers,
    snapshot and current (here on the CPU)."""
    run = chip_smoke.run_session(ops, n, layout, "cpu", qmix, sw,
                                 e_cap=8 * n if layout == "edge" else None)
    return dict(answers=run["answers"], sweeps=run["sweeps"],
                snapshot=chip_smoke._to_cpu(run["snapshot"]),
                current=chip_smoke._to_cpu(run["session"].store.current))


def test_root_bytes_counts_a_durable_root(tmp_path):
    from repro_torch.api import GraphSession
    from repro_torch.persist import read_manifest
    root = str(tmp_path / "g")
    s = GraphSession(path=root, n_cap=N_DURABLE, device="cpu",
                     segment_min_ops=8)
    for b in chip_smoke.batches(chip_smoke.make_ops(200, 7), 3):
        s.ingest(b)
        s.flush()
    s.close()
    got = chip_smoke.root_bytes(root)
    man = read_manifest(root)
    assert got["manifest"] == os.path.getsize(os.path.join(root,
                                                           "MANIFEST.json"))
    assert got["wal_files"] == 1
    assert got["segment_files"] == len(man["segments"]) == 3
    assert got["total"] == got["manifest"] + got["wal"] + got["segments"]
    assert got["total"] == sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, fs in os.walk(root) for f in fs)


def test_reopen_split_reads_the_recovery_spans(tmp_path):
    """``reopen`` reads its split from ``open_store``'s trace spans: a
    root with sealed segments and unflushed WAL records splits into
    steps that are each non-negative and add up to the whole open, and
    a tracer installed before the reopen is installed again after."""
    from repro_torch.api import GraphSession
    from repro_torch.obs.trace import Tracer, active_tracer, \
        install_tracer, uninstall_tracer
    root = str(tmp_path / "g")
    s = GraphSession(path=root, n_cap=N_DURABLE, device="cpu",
                     segment_min_ops=8)
    parts = chip_smoke.batches(chip_smoke.make_ops(200, 7), 3)
    for b in parts[:2]:
        s.ingest(b)
        s.flush()
    s.ingest(parts[2])                     # left in the WAL: replayed
    del s
    outer = install_tracer(Tracer())
    try:
        steps = {}
        got = chip_smoke.reopen(root, "cpu", steps)
        assert active_tracer() is outer
    finally:
        uninstall_tracer(outer)
    got.close()
    keys = {"segments_s", "tree_s", "wal_read_s", "host_rebuild_s",
            "card_rebuild_s", "replay_s", "load_s", "serve_s", "open_s"}
    assert set(steps) == keys
    assert all(v >= 0 for v in steps.values()), steps
    assert steps["load_s"] >= (steps["segments_s"] + steps["tree_s"]
                               + steps["wal_read_s"])
    whole = sum(steps[k] for k in ("load_s", "host_rebuild_s",
                                   "card_rebuild_s", "replay_s",
                                   "serve_s"))
    assert whole == pytest.approx(steps["open_s"])
    assert steps["segments_s"] > 0 and steps["replay_s"] > 0


def test_crash_child_arguments():
    args = chip_smoke.parse_args(["--crash-child", "/data/graph",
                                  "--dense-nodes", "64", "--seed", "3"])
    assert (args.crash_child, args.dense_nodes, args.seed) == (
        "/data/graph", 64, 3)
    default = chip_smoke.parse_args([])
    assert default.crash_child is None and default.dense_nodes == 8192


def test_read_acks(tmp_path):
    path = tmp_path / "acks.log"
    path.write_text("batch 12\nswap 12\nbatch 30\n")
    assert chip_smoke.read_acks(str(path)) == ([12, 30], [12])


def test_answer_comparison_is_bit_for_bit():
    import numpy as np
    names = ["a", "b", "c"]
    got = [np.int32(3), np.float32(0.0), np.arange(3)]
    assert chip_smoke.differing(names, got, list(got)) == []
    # -0.0 == 0.0 numerically, not in bits; a dtype or a length differs
    assert chip_smoke.differing(
        names, got, [np.int32(3), np.float32(-0.0), np.arange(3)]) == ["b"]
    assert chip_smoke.differing(
        names, got, [np.int64(3), got[1], got[2]]) == ["a"]
    assert chip_smoke.differing(names, got, got[:2]) == ["count"]


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_phase_durable_on_the_cpu(tmp_path, layout):
    """Phase 7 rehearsed at a small size on the CPU: every check of the
    answers, snapshot, current and index holds; only the launch check
    fails, since no kernel runs on the CPU."""
    n = N_DURABLE if layout == "dense" else 4 * N_DURABLE
    ops = chip_smoke.make_ops(n, 7)
    qmix = chip_smoke.query_mix(ops[-1].t, n, layout == "dense", 7)
    sw = chip_smoke.sweeps(ops[-1].t, qmix[0][0]["v"])
    mem = _memory(layout, n, ops, qmix, sw)
    kernel = "delta_apply" if layout == "dense" else "edge_delta_apply"
    with pytest.raises(AssertionError) as exc:
        chip_smoke.phase_durable(
            layout, ops, n, layout, 7, mem, {}, kernel,
            str(tmp_path / layout), device="cpu",
            e_cap=8 * n if layout == "edge" else None)
    assert str(exc.value) == f"{layout}: the reopen did not launch {kernel}"
    # one changed answer is caught, and named
    answers = list(mem["answers"])
    mem["answers"][0] = mem["answers"][0] + 1
    assert chip_smoke.held_to("x", mem, qmix, answers, mem["sweeps"],
                              mem["snapshot"]) == [f"x: {qmix[0][0]}"]


def test_phase_crash_on_the_cpu(tmp_path):
    """Phase 8 rehearsed on the CPU: the child dies by SIGKILL after the
    second swap's drain record, with two batches and one swap
    acknowledged; the reopened store passes every check but the launch
    check."""
    import sys
    n, root = N_DURABLE, str(tmp_path / "crash")
    os.makedirs(root)
    cmd = [sys.executable, "-c",
           "import sys; sys.path[:0] = [%r, %r]; import chip_smoke; "
           "sys.exit(chip_smoke.crash_child(%r, %d, 7, 'cpu'))"
           % (ROOT, os.path.join(ROOT, "src"), root, n)]
    with pytest.raises(AssertionError) as exc:
        chip_smoke.phase_crash(chip_smoke.make_ops(n, 7), n, 7, root,
                               device="cpu", child_cmd=cmd)
    assert str(exc.value) == "crash: the reopen did not launch delta_apply"
    batch_ts, swap_ws = chip_smoke.read_acks(os.path.join(root, "acks.log"))
    assert len(batch_ts) == 2 and swap_ws == batch_ts[:1]


# ---------------------------------------------------------------------------
# Phase 9's host side: the replica child, the verdict, a CPU rehearsal
# ---------------------------------------------------------------------------


def test_replica_child_arguments():
    args = chip_smoke.parse_args(["--replica-child", "/data/pub",
                                  "/data/mirror"])
    assert args.replica_child == ["/data/pub", "/data/mirror"]
    assert args.crash_child is None
    assert chip_smoke.parse_args([]).replica_child is None
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--replica-child", "/data/pub"])


def _passing(layout):
    """Phase 9's results on one layout as a passing run leaves them."""
    res = dict(
        bad=[], sync=[dict(mode="initial", seconds=0.0, records=0)]
        + [dict(mode="rotate", seconds=0.5, records=10)] * 4,
        writer_watermark=40, a_watermark=40,
        a_stats=dict(full_rebuilds=0), b_stats=dict(full_rebuilds=0),
        b_open_launches={"delta_apply" if layout == "dense"
                         else "edge_delta_apply": 1},
        launches={"edge_delta_apply": 9, "degree_series": 3},
        routed_to=["A", "B"], failovers=1, watermark_error=True)
    if layout == "dense":
        res["launches"]["delta_apply"] = 7
        res["anchor_launches"] = {"delta_apply": 4}
        res["fault"] = dict(quarantined=1, files=1)
        res["threaded"] = dict(checked=30, watermarks=[0, 20, 40], bad=[],
                               stopped=True, watermark=40,
                               stats=dict(syncs=50, full_rebuilds=0))
        res["kill"] = dict(bad=[], w_old=20, segments_beyond_manifest=2,
                           fetches_before_serving=0, watermark_restart=20,
                           watermark=40, restart_launches={
                               "delta_apply": 1},
                           stats=dict(segments_reused=3, full_rebuilds=0))
    return res


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_replication_verdict_passes_a_passing_run(layout):
    assert chip_smoke.replication_failures(_passing(layout), layout) == []


@pytest.mark.parametrize("change,message", [
    (lambda r: r["bad"].append("routed: q"), "routed: q"),
    (lambda r: [x.update(mode="rebuild") for x in r["sync"][1:]],
     "replica A never caught up by diff"),
    (lambda r: r["a_stats"].update(full_rebuilds=1),
     "replica A fell back to 1 full rebuilds"),
    (lambda r: r.update(a_watermark=39), "replica A at 39, the writer at 40"),
    (lambda r: r.update(b_open_launches={}),
     "replica B's open did not launch delta_apply"),
    (lambda r: r["launches"].pop("degree_series"),
     "kernel degree_series never launched"),
    (lambda r: r.update(anchor_launches={}),
     "replica B's refresh_anchors did not launch delta_apply"),
    (lambda r: r.update(routed_to=["A", "A"]),
     "the two routes went to ['A', 'A'], not A and B"),
    (lambda r: r.update(failovers=0), "0 failovers, not 1"),
    (lambda r: r.update(watermark_error=False),
     "a batch past every watermark was answered"),
    (lambda r: r["fault"].update(quarantined=2, files=2),
     "the bit flip quarantined 2 payloads, not 1"),
    (lambda r: r["kill"].update(segments_beyond_manifest=0),
     "the child died before a new segment file reached its mirror"),
    (lambda r: r["kill"].update(fetches_before_serving=1),
     "the restart served watermark 20 after 1 fetches"),
    (lambda r: r["kill"]["stats"].update(segments_reused=0),
     "the restart did not rejoin by diff"),
    (lambda r: r["kill"].update(watermark=30), "the restart rejoined at 30"),
    (lambda r: r["kill"]["bad"].append("rejoined: current"),
     "kill -9: rejoined: current"),
    (lambda r: r["kill"].update(restart_launches={}),
     "the restart from the mirror did not launch delta_apply"),
    (lambda r: r["threaded"]["bad"].append("at 20: q"),
     "threaded replica: at 20: q"),
    (lambda r: r["threaded"].update(stopped=False),
     "threaded replica: the poll thread did not stop"),
    (lambda r: r["threaded"].update(watermark=20),
     "threaded replica at 20 after 0 full rebuilds"),
], ids=["answers", "modes", "rebuilds", "lag", "open-launch", "launch",
        "anchors", "spread", "failover", "watermark", "quarantine",
        "mirror", "restart", "diff", "rejoin", "kill-answers",
        "restart-launch", "threaded-answers", "threaded-stop",
        "threaded-lag"])
def test_replication_verdict_names_each_failed_check(change, message):
    res = _passing("dense")
    change(res)
    bad = chip_smoke.replication_failures(res, "dense")
    assert len(bad) == 1 and bad[0].startswith("dense replication: ")
    assert message in bad[0]


def test_replication_verdict_refuses_b1_on_the_edge_layout():
    res = _passing("edge")
    res["launches"]["delta_apply"] = 2
    assert chip_smoke.replication_failures(res, "edge") == [
        "edge replication: kernel delta_apply launched 2 times on a path "
        "that must not use it"]


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_phase_replication_on_the_cpu(tmp_path, layout):
    """Phase 9 rehearsed at a small size on the CPU (the dense kill -9
    child too): every check holds but the launch checks, since no kernel
    runs on the CPU."""
    import sys
    n = N_DURABLE if layout == "dense" else 4 * N_DURABLE
    e_cap = 8 * n if layout == "edge" else None
    ops = chip_smoke.make_ops(n, 7)
    qmix = chip_smoke.query_mix(ops[-1].t, n, layout == "dense", 7)
    sw = chip_smoke.sweeps(ops[-1].t, qmix[0][0]["v"])
    mem = _memory(layout, n, ops, qmix, sw)

    def child_cmd(pub, mirror):
        return [sys.executable, "-c",
                "import sys; sys.path[:0] = [%r, %r]; import chip_smoke; "
                "sys.exit(chip_smoke.replica_child(%r, %r, 'cpu'))"
                % (ROOT, os.path.join(ROOT, "src"), pub, mirror)]

    with pytest.raises(AssertionError) as exc:
        chip_smoke.phase_replication(layout, ops, n, layout, 7, mem,
                                     str(tmp_path), e_cap=e_cap,
                                     device="cpu", child_cmd=child_cmd)
    kernel = "delta_apply" if layout == "dense" else "edge_delta_apply"
    want = [f"replica B's open did not launch {kernel}",
            "kernel edge_delta_apply never launched",
            "kernel degree_series never launched"]
    if layout == "dense":
        want += ["kernel delta_apply never launched",
                 "replica B's refresh_anchors did not launch delta_apply",
                 "the restart from the mirror did not launch delta_apply"]
    assert str(exc.value) == "; ".join(f"{layout} replication: {w}"
                                       for w in want)


# ---------------------------------------------------------------------------
# Phase 10's host side: the verdict and a CPU rehearsal
# ---------------------------------------------------------------------------


def _sharded_passing(layout):
    """Phase 10's results on one layout as a passing run leaves them."""
    dense = layout == "dense"
    modes = {"auto": [None, None],
             "force": ["batch", "slots", "batch"],
             "never": [None, None, None]}
    if dense:
        modes["force_dense"] = ["rows", "batch", "rows"]
    return dict(bad=[], modes=modes, evolve_slots=not dense,
                launches={"delta_apply": 6 if dense else 0,
                          "edge_delta_apply": 9},
                block_launches={"delta_apply": 4 if dense else 0,
                                "edge_delta_apply": 8})


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_sharded_verdict_passes_a_passing_run(layout):
    assert chip_smoke.sharded_failures(_sharded_passing(layout),
                                       layout) == []


@pytest.mark.parametrize("layout,change,message", [
    ("dense", lambda r: r["modes"]["force_dense"].append(None),
     "a forced group ran unsharded"),
    ("edge", lambda r: r["modes"]["force"].append(None),
     "a forced group ran unsharded"),
    ("dense", lambda r: r["modes"].update(force_dense=["batch"]),
     "lack ['rows']"),
    ("edge", lambda r: r["launches"].update(delta_apply=2),
     "kernel delta_apply launched 2 times on a path that must not use it"),
    ("edge", lambda r: r.update(evolve_slots=False),
     "no evolve group ran through evolve_slots"),
    ("dense", lambda r: r["block_launches"].update(delta_apply=0),
     "delta_apply never launched on a row block"),
    ("edge", lambda r: r["modes"].update(never=[None, "batch"]),
     "shard='never' sharded"),
    ("dense", lambda r: r["modes"].update(auto=[None, "rows"]),
     "shard='auto' sharded"),
    ("dense", lambda r: r["bad"].append("force: q"), "force: q"),
], ids=["dense-none", "edge-none", "no-rows", "b1-on-edge", "no-evolve",
        "no-row-block", "never", "auto", "answers"])
def test_sharded_verdict_names_each_failed_check(layout, change, message):
    res = _sharded_passing(layout)
    change(res)
    bad = chip_smoke.sharded_failures(res, layout)
    assert len(bad) == 1 and bad[0].startswith(f"{layout} sharded: ")
    assert message in bad[0]


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_phase_sharded_on_the_cpu(layout):
    """Phase 10 rehearsed at a small size on a mesh of four CPU shards:
    every answer, sweep, snapshot, mode and primitive check holds; only
    the block-launch check fails, since no kernel runs on the CPU."""
    n = N_DURABLE if layout == "dense" else 4 * N_DURABLE
    e_cap = 8 * n if layout == "edge" else None
    ops = chip_smoke.make_ops(n, 7)
    qmix = chip_smoke.query_mix(ops[-1].t, n, layout == "dense", 7)
    sw = chip_smoke.sweeps(ops[-1].t, qmix[0][0]["v"])
    run = chip_smoke.run_session(ops, n, layout, "cpu", qmix, sw,
                                 e_cap=e_cap)
    mem = dict(answers=run["answers"], sweeps=run["sweeps"],
               snapshot=chip_smoke._to_cpu(run["snapshot"]))
    with pytest.raises(AssertionError) as exc:
        chip_smoke.phase_sharded(layout, ops, n, layout, 7, mem,
                                 store=run["session"].store, device="cpu")
    kernel, blk = (("delta_apply", "row") if layout == "dense"
                   else ("edge_delta_apply", "slot"))
    assert str(exc.value) == (f"{layout} sharded: {kernel} never launched "
                              f"on a {blk} block")
    # one changed answer is caught, and named
    mem["answers"][0] = mem["answers"][0] + 1
    with pytest.raises(AssertionError, match=r"auto: \{'kind': 'point'"):
        chip_smoke.phase_sharded(layout, ops, n, layout, 7, mem,
                                 store=run["session"].store, device="cpu")


# ---------------------------------------------------------------------------
# Phase 11's host side: training, delta checkpoints and recovery, the
# card-versus-CPU check, rehearsed on reduced configs on the CPU
# ---------------------------------------------------------------------------


def _reduced(arch):
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    return reduced(get_config(arch))


@pytest.mark.parametrize("arch,kernel", [("smollm-360m", "flash_attention"),
                                         ("mamba2-130m", "ssd_scan")])
def test_phase_train_on_the_cpu(arch, kernel):
    """Phase 11 (a) / (b) rehearsed on the CPU: every parameter gets a
    finite nonzero gradient, loss and grad norm are finite at every
    step; only the launch checks fail (no kernel runs on the CPU) and,
    for attention, the count of plain-version calls (on the CPU the
    forward is the plain version too: twice a call a step)."""
    cfg = _reduced(arch)
    res = chip_smoke.phase_train(cfg, kernel, 7, device="cpu", batch=2,
                                 seq=32, steps=2)
    per = 2 * cfg.n_layers            # forward + remat recompute
    assert res["per_step"] == per and res["n_params"] > 0
    want = [f"the first step launched {kernel} 0 times, want {per}",
            f"2 steps launched {kernel} 0 times, want {2 * per}"]
    if kernel == "flash_attention":
        assert res["plain_forward"] == 0
        want.append(f"the plain version ran {2 * per} times, want {per} "
                    "(one a forward call's backward)")
    assert chip_smoke.train_failures(res) == want


# ---------------------------------------------------------------------------
# Phase 15: every family trains; the dense LM on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,calls", [
    ("smollm-360m", 32), ("mamba2-130m", 24), ("whisper-small", 36),
    ("internvl2-1b", 24), ("mixtral-8x7b", 32)])
def test_launches_per_step_count_every_attention_call(arch, calls):
    """B5's launches a training step, fixed before the run: twice a
    forward call under remat (its recompute), once without; whisper's
    calls are 12 encoder + 12 decoder self + 12 cross."""
    from repro_torch.config import ShardingConfig
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    assert chip_smoke.launches_per_step(cfg, ShardingConfig()) == 2 * calls
    assert chip_smoke.launches_per_step(
        cfg, ShardingConfig(remat="none")) == calls
    if cfg.family == "encdec":
        enc, self_, cross = chip_smoke.attention_calls(cfg, 448)
        assert (enc["sq"], enc["skv"], enc["f32"]) == (1500, 1500, True)
        assert (self_["sq"], self_["causal"], self_["f32"]) == (448, True,
                                                              False)
        assert (cross["sq"], cross["skv"], cross["f32"]) == (448, 1500, True)
    if cfg.family == "vlm":
        assert chip_smoke.attention_calls(cfg, 2048)[0]["sq"] == 2304


def test_moe_train_depth_reckons_two_layers_on_an_h100():
    """mixtral's training depth from the card's free memory: 1.451 B
    params a layer + 0.262 B of embeddings at 12 B a param, 3 GB kept
    a layer, 24 GiB transient: 2 layers on an 80 GB card's ~79 GiB free,
    more on a larger one; never below 1; the override wins."""
    from repro_torch.configs import get_config
    cfg = get_config("mixtral-8x7b")
    zero = chip_smoke.moe_train_params(
        __import__("dataclasses").replace(cfg, n_layers=0))
    one = chip_smoke.moe_train_params(
        __import__("dataclasses").replace(cfg, n_layers=1))
    assert round((one - zero) / 1e9, 3) == 1.451
    assert round(zero / 1e9, 3) == 0.262
    n, why = chip_smoke.moe_train_depth(cfg, int(79.1 * 2 ** 30))
    assert n == 2 and why.startswith("2 of 32 layers (a layer ")
    assert "3 need" in why
    assert chip_smoke.moe_train_depth(cfg, 200 * 2 ** 30)[0] == 9
    assert chip_smoke.moe_train_depth(cfg, 10 * 2 ** 30)[0] == 1
    assert chip_smoke.moe_train_depth(cfg, 10 * 2 ** 30, 3) == (
        3, "3 of 32 layers (--lm-layers)")


def test_family_check_config_cuts_both_stacks():
    cfg = chip_smoke.family_check_config("whisper-small")
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.d_model) == (1, 1, 768)
    cfg = chip_smoke.family_check_config("whisper-small", 2)
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.d_model) == (2, 2, 768)
    # phases 5, 6 and 14's float32 and promotion checks: at most
    # F32_CHECK_LAYERS deep, both stacks, published width
    n = chip_smoke.F32_CHECK_LAYERS
    cfg = chip_smoke.f32_check_config(chip_smoke.lm_config("whisper-small", 0))
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.d_model) == (n, n, 768)
    assert chip_smoke.f32_check_config(
        chip_smoke.lm_config("smollm-360m", 0)).n_layers == n
    small = _reduced("whisper-small")
    assert chip_smoke.f32_check_config(small) == small
    assert chip_smoke.family_check_config("mixtral-8x7b").n_layers == 1
    assert chip_smoke.family_check_config("internvl2-1b").d_model == 896


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b",
                                  "mixtral-8x7b"])
def test_phase_15_train_on_the_cpu(arch):
    """Phase 15 (a) rehearsed on the CPU in bf16 params (whisper's
    frames float32): gradients finite and nonzero, no plain attention
    forward; only the launch checks and the plain-version count fail."""
    cfg = _reduced(arch)
    res = chip_smoke.phase_train(cfg, "flash_attention", 7, device="cpu",
                                 batch=2, seq=32, steps=2,
                                 param_dtype="bfloat16")
    per = chip_smoke.launches_per_step(cfg, __import__(
        "repro_torch.config", fromlist=["ShardingConfig"]).ShardingConfig())
    assert res["param_dtype"] == "bfloat16" and res["plain_forward"] == 0
    assert chip_smoke.train_failures(res) == [
        f"the first step launched flash_attention 0 times, want {per}",
        f"2 steps launched flash_attention 0 times, want {2 * per}",
        f"the plain version ran {2 * per} times, want {per} (one a "
        "forward call's backward)"]


def test_phase_train_card_cpu_routes_on_the_cpu():
    """Phase 15 (b) for the MoE family with the CPU in the card's place:
    the same initial parameters, no step-1 route flip, equal losses."""
    res = chip_smoke.phase_train_card_cpu(_mixtral(capacity_factor=1.25), 7,
                                          device="cpu", batch=2, seq=32,
                                          steps=2)
    assert res["route_flips"] == [] and res["max_rel"] == 0.0
    assert chip_smoke.card_cpu_failures(res) == []
    line = chip_smoke.card_cpu_line(res)
    assert "2x32, 2 steps" in line and "step-1 route flips 0" in line
    assert len(res["step_s_card"]) == len(res["step_s_cpu"]) == 2
    assert "; step s card " in line


def test_step1_route_flips_are_judged_as_near_ties():
    cpu = {0: torch.tensor([[3.0, 2.0, 1.99, 0.0], [1.0, 0.5, 0.0, -1.0]])}
    card = {0: torch.tensor([[3.0, 1.99, 2.0, 0.0], [1.0, 0.5, 0.0, -1.0]])}
    flips = chip_smoke.step1_route_flips(card, cpu, 2)
    assert len(flips) == 1 and flips[0]["token"] == 0 and flips[0]["near_tie"]
    # the CPU's 2nd and 3rd logits 1.0 apart, each moved by at most 0.6
    cpu2 = {0: torch.tensor([[3.0, 2.0, 1.0, 0.0]])}
    far = {0: torch.tensor([[3.0, 1.5, 1.6, 0.0]])}
    [f] = chip_smoke.step1_route_flips(far, cpu2, 2)
    assert (f["gap"], round(f["delta"], 6)) == (1.0, 0.6)
    assert not f["near_tie"]
    ok = dict(init_differing=[], max_rel=1e-6, rel={}, route_flips=flips)
    assert chip_smoke.card_cpu_failures(ok) == []
    assert "no near-tie" in chip_smoke.card_cpu_failures(
        dict(ok, route_flips=[f]))[0]
    assert "initial parameters differ" in chip_smoke.card_cpu_failures(
        dict(ok, init_differing=["params/embed.tok"]))[0]
    assert "disagree" in chip_smoke.card_cpu_failures(
        dict(ok, max_rel=1e-3))[0]


def test_psum_differing_is_the_numpy_form():
    import numpy as np
    g = {"a": np.array([0.5, -127.0, 3.25], np.float32),
         "z": np.zeros(3, np.float32)}
    for world in (1, 4):
        from repro_torch.optim import compress_with_feedback
        out, err = {}, {}
        for n, x in g.items():
            q, a, e = compress_with_feedback(torch.from_numpy(x),
                                             torch.zeros(3))
            out[n] = (q.to(torch.int32) * world).float().numpy() * a.numpy()
            err[n] = e.numpy()
        assert chip_smoke.psum_differing(g, out, err, world) == []
        assert chip_smoke.psum_differing(
            g, dict(out, a=out["a"] + 1), err, world) == ["a"]


def test_phase_15_mesh_on_the_cpu(tmp_path):
    """Phase 15 (c) rehearsed on the CPU: one gloo process, a reduced
    smollm in place of the published one: the float32 mesh and plain
    steps within the bound, compressed_psum and the checkpoint round
    trip bit-exact, and last the int8 step (world 1), its mesh and plain
    states bit-equal; only the launch checks fail."""
    cfg = chip_smoke.lm_config("smollm-360m", 0)
    from repro_torch.config import reduced
    res = chip_smoke.mesh_checks(
        0, 1, f"file://{tmp_path}/rendezvous", 7, device_type="cpu",
        batch=2, seq=32, steps=2, check_seq=32, check_steps=2,
        root=str(tmp_path / "ckpt"), cfg=reduced(cfg))
    assert res["mesh"] == {"data": 1, "model": 1}
    assert res["check"]["param_diff"] <= chip_smoke.MESH_ATOL
    assert res["int8"]["differing"] == [] and res["int8"]["q_arrays"] > 0
    assert chip_smoke.mesh_failures(res) == [
        f"the mesh run launched flash_attention 0 times, want "
        f"{2 * res['per_step']}"] + [
        f"the int8 {what} step launched {{}}, want "
        f"{{'flash_attention': {res['int8']['per_step']}}}"
        for what in ("mesh", "plain")]
    line = chip_smoke.mesh_line(res, 1.0, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "700.00 W" in line and "reshard_from_checkpoint" in line


def test_phase_15_mesh_models_on_the_cpu(tmp_path):
    """Phase 15 (c)'s mixtral-8x7b, mamba2-130m, whisper-small and
    internvl2-1b mesh runs rehearsed on the CPU at reduced size (one
    gloo process; whisper's batch with its float32 frames, internvl2's
    with its patches): the float32 mesh and plain steps within each
    model's bound, the first forward of both routing alike (at world 1
    the local tokens are the whole batch); only the launch checks
    fail."""
    from repro_torch.config import reduced
    models = {a: reduced(chip_smoke.lm_config(a, 0))
              for a in chip_smoke.MESH_MODELS}
    res = chip_smoke.mesh_checks(
        0, 1, f"file://{tmp_path}/rendezvous", 7, device_type="cpu",
        batch=2, seq=32, steps=2, check_seq=32, check_steps=2,
        root=str(tmp_path / "ckpt"),
        cfg=reduced(chip_smoke.lm_config("smollm-360m", 0)), models=models)
    assert set(res["models"]) == {"mixtral-8x7b", "mamba2-130m",
                                  "whisper-small", "internvl2-1b"}
    want = []
    for arch, r in res["models"].items():
        c, knobs = r["check"], chip_smoke.MESH_MODELS[arch]
        assert (r["steps"], c["layers"], c["steps"], c["atol"]) == (
            knobs["steps"], knobs["check_layers"], knobs["check_steps"],
            knobs["atol"])
        assert c["loss_diff"] <= c["atol"] and c["param_diff"] <= c["atol"]
        assert all(math.isfinite(x) for x in r["loss"])
        k = r["kernel"]
        want += [f"{arch}: the bf16 mesh run launched {k} 0 times, want "
                 f"{r['per_step'] * r['steps']}",
                 f"{arch}: the float32 mesh run launched {k} 0 times, want "
                 f"{c['per_step'] * c['steps']}"]
    moe, ssm = res["models"]["mixtral-8x7b"], res["models"]["mamba2-130m"]
    assert (moe["kernel"], ssm["kernel"]) == ("flash_attention", "ssd_scan")
    assert moe["check"]["routes_differing"] == 0
    assert moe["check"]["moe_calls"] == 1
    assert ssm["check"]["routes_differing"] is None
    bad = chip_smoke.mesh_failures(res)
    assert bad[3:] == want, bad
    line = chip_smoke.mesh_model_line(moe, ("plain", 1.0),
                                      "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "routed differently 0 over 1 MoE calls" in line
    assert "700.00 W" in line


def test_phase_15_lets_each_model_state_go(tmp_path, monkeypatch):
    """Each float32 mesh state ``mesh_model_run`` returns is let go
    before the next model trains and before the int8 step (a state kept
    alive held internvl2-1b's 1.86 GiB on the card through phase 15
    (c)'s serving and the int8 step)."""
    import gc
    import weakref

    from repro_torch.config import reduced
    states = []
    run, int8 = chip_smoke.mesh_model_run, chip_smoke.int8_mesh_step

    def live():
        gc.collect()
        return [r for r in states if r() is not None]

    def recording_run(*args, **kw):
        assert live() == []
        res, state = run(*args, **kw)
        states.append(weakref.ref(state.params))
        return res, state

    def checked_int8(*args, **kw):
        assert len(states) == 3 and live() == []
        return int8(*args, **kw)
    monkeypatch.setattr(chip_smoke, "mesh_model_run", recording_run)
    monkeypatch.setattr(chip_smoke, "int8_mesh_step", checked_int8)
    models = {a: reduced(chip_smoke.lm_config(a, 0))
              for a in ("mamba2-130m", "whisper-small")}
    res = chip_smoke.mesh_checks(
        0, 1, f"file://{tmp_path}/rendezvous", 7, device_type="cpu",
        batch=2, seq=32, steps=1, check_seq=32, check_steps=1,
        root=str(tmp_path / "ckpt"),
        cfg=reduced(chip_smoke.lm_config("smollm-360m", 0)), models=models)
    assert set(res["models"]) == set(models) and "int8" in res
    assert res["memory"] == []          # read on the card only


def test_memory_readout_counts_blocks_made_since(monkeypatch):
    """``memory_readout`` walks each segment's blocks by address: an
    active block at an address not active at the earlier readout is new
    (here no CUDA tensor reaches it, so it counts as not reached); an
    inactive one, or one on another card, is not counted."""
    def segment(device, address, *blocks):
        return dict(device=device, address=address, blocks=[
            dict(size=n, state=st) for n, st in blocks])
    snaps = [[segment(0, 0, (512, "active_allocated"), (512, "inactive"))],
             [segment(0, 0, (512, "active_allocated"),
                      (256, "active_allocated"), (256, "inactive")),
              segment(1, 0, (4096, "active_allocated"))]]
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: snaps.pop(0))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 768)
    dev = torch.device("cuda", 0)
    start = chip_smoke.memory_readout(dev)
    assert start["blocks"] == {0: 512} and "new" not in start
    new = chip_smoke.memory_readout(dev, start)["new"]
    assert new == dict(bytes=256, reached=0, not_reached=256,
                       reached_by_shape=[])
    line = chip_smoke.memory_line(dict(part="before serving x",
                                       allocated=768, **new), 512)
    assert line.startswith("15 (c) memory before serving x: 0.000 GiB")


def test_mesh_model_verdict_names_each_failed_check():
    ok = dict(kernel="ssd_scan", per_step=48, steps=3,
              launches={"ssd_scan": 144}, loss=[6.0, 5.9, 5.8],
              grad_norm=[1.0, 1.0, 1.0],
              check=dict(per_step=4, steps=2, launches={"ssd_scan": 8},
                         loss_diff=1e-6, param_diff=1e-6, atol=1e-4))
    assert chip_smoke.mesh_model_failures(ok) == []
    for change, message in (
            (dict(launches={"ssd_scan": 143}), "bf16 mesh run launched"),
            (dict(launches={"ssd_scan": 144, "flash_attention": 1}),
             "'flash_attention'"),
            (dict(check=dict(ok["check"], launches={})),
             "float32 mesh run launched ssd_scan 0"),
            (dict(loss=[float("nan")]), "non-finite"),
            (dict(check=dict(ok["check"], param_diff=2e-4)),
             "parameters 0.0002")):
        bad = chip_smoke.mesh_model_failures(dict(ok, **change))
        assert any(message in b for b in bad), (change, bad)


def test_pairs_routed_differently_counts_pairs_not_order():
    a = [torch.tensor([[0, 1], [2, 3]]), torch.tensor([[1, 0]])]
    assert chip_smoke.pairs_routed_differently(
        a, [torch.tensor([[1, 0], [2, 3]]), torch.tensor([[1, 0]])]) == 0
    assert chip_smoke.pairs_routed_differently(
        a, [torch.tensor([[0, 2], [3, 1]]), torch.tensor([[2, 3]])]) == 4


def _mesh_passing():
    return dict(per_step=64, steps=6, launches={"flash_attention": 384},
                loss=[10.0, 9.0], grad_norm=[1.0, 1.0],
                check=dict(loss_diff=1e-6, param_diff=1e-6),
                psum_differing=[], restore_differing=[],
                restore_on_mesh=True)


@pytest.mark.parametrize("change,message", [
    (dict(launches={"flash_attention": 383}), "launched flash_attention 383"),
    (dict(launches={"flash_attention": 384, "ssd_scan": 1}), "'ssd_scan'"),
    (dict(loss=[float("nan")]), "non-finite"),
    (dict(check=dict(loss_diff=1e-6, param_diff=2e-4)), "parameters 0.0002"),
    (dict(psum_differing=["embed.tok"]), "compressed_psum differs"),
    (dict(restore_differing=["params/embed.tok"]), "reshard_from_check"),
    (dict(restore_on_mesh=False), "on the mesh: False")])
def test_mesh_verdict_names_each_failed_check(change, message):
    assert chip_smoke.mesh_failures(_mesh_passing()) == []
    bad = chip_smoke.mesh_failures(dict(_mesh_passing(), **change))
    assert any(message in b for b in bad), bad


def _passing_train():
    return dict(kernel="ssd_scan", per_step=4, steps=2, bad_grads=[],
                grad_launches={"ssd_scan": 4, "flash_attention": 0},
                launches={"ssd_scan": 8, "flash_attention": 0},
                loss=[6.0, 5.9], grad_norm=[3.0, 2.9])


@pytest.mark.parametrize("change,message", [
    (dict(bad_grads=["groups.0.l0.ssm.A_log"]), "no finite nonzero gradient"),
    (dict(grad_launches={"ssd_scan": 2}), "the first step launched ssd_scan 2"),
    (dict(launches={"ssd_scan": 8, "delta_apply": 1}), "launched {'delta_"),
    (dict(loss=[6.0, float("nan")]), "non-finite loss"),
    (dict(grad_norm=[3.0, float("inf")]), "non-finite loss"),
    (dict(loss=[6.0]), "1 steps logged of 2")])
def test_train_verdict_names_each_failed_check(change, message):
    assert chip_smoke.train_failures(_passing_train()) == []
    bad = chip_smoke.train_failures(dict(_passing_train(), **change))
    assert any(message in b for b in bad), bad


def test_phase_train_recovery_on_the_cpu(tmp_path):
    """Phase 11 (c) rehearsed on the CPU: the failure fires once at step
    3, the state restored from the delta chain equals the state saved
    at step 2 bit for bit, and the recovered run ends bit-equal to the
    uninterrupted one; only the launch checks fail."""
    cfg = _reduced("mamba2-130m")
    res = chip_smoke.phase_train_recovery(cfg, "ssd_scan", str(tmp_path),
                                          device="cpu", batch=2, seq=32)
    assert chip_smoke.recovery_failures(res) == [
        "clean_launches: ssd_scan never launched",
        "launches: ssd_scan never launched"]
    assert [(r["step"], r["saved_step"], r["differing"])
            for r in res["restores"]] == [(2, 2, [])]
    assert res["manifest"]["steps"] == [0, 2, 4, 5]
    assert res["storage_bytes"]["deltas"] > 0
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("change,message", [
    (dict(fired=[]), "the injected failure fired []"),
    (dict(restores=[]), "recovery restored nothing"),
    (dict(restores=[dict(step=2, saved_step=2, seconds=0.1,
                         differing=["params/embed.tok"])]),
     "differs from the state saved at step 2"),
    (dict(final_differing=["opt/m/embed.tok"]),
     "final state differs from the uninterrupted run's in 1"),
    (dict(final_step=5), "ended at step 5"),
    (dict(launches={"ssd_scan": 0}), "launches: ssd_scan never launched")])
def test_recovery_verdict_names_each_failed_check(change, message):
    ok = dict(kernel="ssd_scan", steps=6, fired=[("step", "raise", 4)],
              restores=[dict(step=2, saved_step=2, seconds=0.1,
                             differing=[])],
              final_differing=[], final_step=6,
              clean_launches={"ssd_scan": 288}, launches={"ssd_scan": 288})
    assert chip_smoke.recovery_failures(ok) == []
    bad = chip_smoke.recovery_failures(dict(ok, **change))
    assert any(message in b for b in bad), bad


def test_phase_train_card_cpu_on_the_cpu():
    """Phase 11 (d) with the CPU in the card's place: the same initial
    state on both, and equal losses and grad norms at every step."""
    res = chip_smoke.phase_train_card_cpu(_reduced("smollm-360m"), 7,
                                          device="cpu", batch=2, seq=32,
                                          steps=2)
    assert res["init_differing"] == [] and res["max_rel"] == 0.0
    assert len(res["loss_card"]) == 2


def test_differing_arrays_reads_bytes_dtype_and_names():
    import numpy as np
    a = {"x": np.zeros(3, np.float32), "y": np.ones(2, np.int32)}
    assert chip_smoke.differing_arrays(a, dict(a)) == []
    neg = dict(a, x=np.array([0.0, -0.0, 0.0], np.float32))
    assert chip_smoke.differing_arrays(a, neg) == ["x"]    # -0.0 != 0.0
    assert chip_smoke.differing_arrays(
        a, dict(a, y=np.ones(2, np.int64))) == ["y"]
    assert chip_smoke.differing_arrays(a, {"x": a["x"]}) == ["y"]


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint16", "bool",
                                   "int8", "complex128"])
def test_same_bytes_compares_every_bit(dtype):
    """``same_bytes`` by item size: equal bits (NaN with NaN, a 0-d
    array, a strided view) agree, one flipped bit does not."""
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, 64 * np.dtype(dtype).itemsize,
                     dtype=np.uint8).view(dtype).reshape(8, -1)
    if x.dtype.kind in "fc":
        x[0, 0] = np.nan
    y = x.copy()
    assert chip_smoke.same_bytes(x, y)
    assert chip_smoke.same_bytes(x[:, ::2], y[:, ::2])
    assert chip_smoke.same_bytes(x[0, 1], y[0, 1])
    z = y.view(np.uint8).copy()
    z[-1] ^= 1
    assert not chip_smoke.same_bytes(x, z.view(dtype).reshape(x.shape))


# ---------------------------------------------------------------------------
# Phase 12: the serving driver, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_serve_degree_oracle_is_the_brute_force_degree():
    """The phase's host oracle (prefix sums over the op list) gives
    ``tests/reference.py``'s degree at every node and time sampled."""
    import numpy as np
    from reference import BruteForce

    from repro_torch.core.generate import EvolutionParams, generate_ops
    ops = generate_ops(60, EvolutionParams(m_attach=4, lam_extra=1.0,
                                           lam_remove=1.0), 3)
    t_max = max(o.t for o in ops)
    bf = BruteForce(ops, 60, t_max)
    vs, ts = np.meshgrid(np.arange(60), np.arange(0, t_max + 1, 3))
    got = chip_smoke.serve_degree_oracle(ops, vs.ravel(), ts.ravel())
    want = [bf.degree(int(v), int(t)) for v, t in zip(vs.ravel(),
                                                       ts.ravel())]
    assert got.dtype == np.int32 and got.tolist() == want
    assert any(want)


def test_phase_serve_on_the_cpu():
    """Phase 12 rehearsed at a small size on a mesh of one CPU shard and
    of four: degrees and mixed answers agree across the meshes, with the
    oracle and with ``evaluate_many``; only the launch checks fail,
    since no kernel runs on the CPU."""
    from repro_torch.sharding import graph_mesh
    res = chip_smoke.phase_serve(200, 256, 7, device="cpu", meshes={
        "one": graph_mesh(["cpu"]), "x4": graph_mesh(["cpu"] * 4)})
    assert res["bad"] == []
    assert chip_smoke.serve_failures(res) == [
        "serve: the driver launched no kernel on one",
        "serve: the driver launched no kernel on x4"]
    assert res["runs"]["x4"]["mesh"] == ["cpu"] * 4
    assert "serve (card): 200 nodes, 256 point-degree queries" in \
        chip_smoke.serve_line(res, "card")
    # a passing run's verdict is empty
    for r in res["runs"].values():
        r["launches"] = {"delta_apply": 2}
    assert chip_smoke.serve_failures(res) == []


def test_phase_serve_names_a_wrong_degree(monkeypatch):
    """An oracle that disagrees at one query is caught, and named."""
    import numpy as np

    from repro_torch.sharding import graph_mesh
    real = chip_smoke.serve_degree_oracle

    def off_by_one(ops, vs, ts):
        out = real(ops, vs, ts)
        out[5] += 1
        return out
    monkeypatch.setattr(chip_smoke, "serve_degree_oracle", off_by_one)
    res = chip_smoke.phase_serve(60, 32, 7, device="cpu",
                                 meshes={"one": graph_mesh(["cpu"])})
    assert res["bad"] == ["point degrees differ from the op list's at 1 "
                          "of 32 queries (first [5])"]
    assert np.asarray(res["runs"]["one"]["answers"][3]).ndim == 0


# ---------------------------------------------------------------------------
# Phase 13's host side: mixtral-8x7b's depth, its verdict, the routing
# readout and a CPU rehearsal on the reduced config
# ---------------------------------------------------------------------------


def _mixtral(**over):
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    return reduced(get_config("mixtral-8x7b"), **over)


def test_moe_depth_steps_down_by_four_layers():
    from repro_torch.configs import get_config
    cfg = get_config("mixtral-8x7b")
    assert round(chip_smoke.moe_weight_bytes(cfg) / 1e9, 1) == 93.4
    n, why = chip_smoke.moe_depth(cfg, int(78.5 * 2 ** 30))
    assert n == 24 and why.startswith("24 of 32 layers: 32 layers are "
                                      "93.4 GB") and "stepped" not in why
    n, why = chip_smoke.moe_depth(cfg, 70 * 2 ** 30)
    assert n == 20 and "stepped down from 24" in why
    assert chip_smoke.moe_depth(cfg, 70 * 2 ** 30, 8) == (
        8, "8 of 32 layers (--lm-layers)")


def test_routing_readout_counts_drops_and_the_fullest_expert():
    """One prefill's readout against a count made here from the MoE
    inputs: per layer, the pairs each expert got from a top-k of the
    router logits (numpy), those past the capacity dropped."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.models.moe import MoE, capacity
    cfg = _mixtral(capacity_factor=1.25)
    model = api.init_params(cfg, torch.Generator().manual_seed(3),
                            torch.float32, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64)))
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(
            (args[0].reshape(-1, cfg.d_model) @ mod.wg).detach().numpy()))
        for m in model.modules() if isinstance(m, MoE)]
    try:
        ro = chip_smoke.routing_readout(model, cfg, toks, 64)
    finally:
        for h in hooks:
            h.remove()
    cap = capacity(cfg, 128)
    assert len(ro["per_layer"]) == len(seen) == cfg.n_layers
    for row, logits in zip(ro["per_layer"], seen):
        top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
        load = np.bincount(top.ravel(), minlength=cfg.n_experts)
        assert row == dict(layer=row["layer"], pairs=128 * cfg.top_k,
                           dropped=int(np.maximum(load - cap, 0).sum()),
                           fullest=int(load.max()), cap=cap)
    assert ro["dropped"] > 0 and ro["fullest"] > cap
    assert ro["dropped_share"] == ro["dropped"] / ro["pairs"]


def test_phase_moe_on_the_cpu():
    """Phase 13 rehearsed on the reduced mixtral at its published
    capacity factor: pairs drop in the readout, decode equals the fresh
    forward at the check-only capacity (E / k), the float32 'card' (the
    CPU here) equals the CPU with every route alike; only the launch
    check fails, since no kernel runs on the CPU."""
    cfg = _mixtral(capacity_factor=1.25)
    res = chip_smoke.phase_moe(cfg, 7, device="cpu", batch=2, prompt=64,
                               decode=4, check_prompt=32, check_decode=4)
    assert chip_smoke.moe_failures(res) == [
        "mixtral-8x7b: a prefill launched flash_attention 0 times, want 2"]
    assert res["routing"]["dropped"] > 0
    assert res["bf16_decode"]["capacity_factor"] == cfg.n_experts / 2
    assert len(res["bf16_decode"]["step_rel"]) == 4
    assert res["card_cpu"]["calls"] == chip_smoke.MOE_F32_LAYERS * (1 + 4)
    assert res["card_cpu"]["route_differs"] == []


def _moe_passing():
    """Phase 13's results as a passing run leaves them."""
    launches = {"flash_attention": 24, "ssd_scan": 0, "delta_apply": 0}
    return dict(
        arch="mixtral-8x7b", n_layers=24, kernel="flash_attention",
        capacity_factor=1.25, allocated_before=2 ** 20,
        prefill_launches=launches,
        decode_launches={k: 0 for k in launches}, finite=True,
        routing=dict(dropped=4000, cap=5120, fullest=7000),
        bf16_decode=dict(step_rel=[0.01] * 32, flips=[], judged=[],
                         finite=True, batch=8),
        f32_decode=dict(step_rel=[1e-6] * 32, flips=[], finite=True),
        card_cpu=dict(rel=1e-6, same_tokens=True, route_differs=[]))


def _flip(step, gap, delta, rel, pinned_rel=0.01, reproduces=True):
    """A route flip at ``step``, layer 5, as the served step and its
    re-runs read it."""
    def change(res):
        flip = dict(gap=gap, delta=delta, near_tie=gap <= delta, layer=5)
        res["bf16_decode"]["flips"].append(dict(step=step, after=None,
                                                **flip))
        res["bf16_decode"]["judged"].append(dict(
            step=step, rounds=[flip], pinned=[5] if flip["near_tie"] else [],
            pinned_rel=pinned_rel if flip["near_tie"] else None, follows=[],
            reproduces=reproduces))
        res["bf16_decode"]["step_rel"][step] = rel
    return change


def _cascade(second_near_tie=None, pinned_rel=0.02):
    """Step 8: a near-tie flip at layer 2 and, in the served step, one at
    layer 18 that is not; re-run with layer 2 pinned, layer 18 flips
    again only if ``second_near_tie`` is not None (then judged so)."""
    def change(res):
        b = res["bf16_decode"]
        first = dict(layer=2, gap=0.00185, delta=0.0115, near_tie=True)
        b["flips"] += [dict(step=8, after=None, **first),
                       dict(step=8, layer=18, gap=0.634, delta=0.456,
                            near_tie=False, after=2)]
        rounds, follows = [first], [18]
        if second_near_tie is not None:
            rounds.append(dict(layer=18, gap=0.05, near_tie=second_near_tie,
                               delta=0.06 if second_near_tie else 0.01))
            follows = []
        b["judged"].append(dict(
            step=8, rounds=rounds,
            pinned=[2, 18] if second_near_tie else [2],
            pinned_rel=pinned_rel, follows=follows, reproduces=True))
        b["step_rel"][8] = 0.352
    return change


def test_moe_verdict_passes_a_passing_run_and_near_ties():
    assert chip_smoke.moe_failures(_moe_passing()) == []
    # a route flip that is a near-tie passes, whatever the served step
    # reads, when the step with it pinned is within the step's tolerance
    for step in (0, 4):
        res = _moe_passing()
        _flip(step, 0.002, 0.003, 0.36)(res)
        assert chip_smoke.moe_failures(res) == []
    # a flip that is gone once the step's earlier near-tie is pinned
    # follows from it and is not judged; one that stays is, and passes
    # as a near-tie
    for second in (None, True):
        res = _moe_passing()
        _cascade(second)(res)
        assert chip_smoke.moe_failures(res) == []


@pytest.mark.parametrize("change,message", [
    (lambda r: r.update(allocated_before=3 * 2 ** 30),
     "3.00 GiB still allocated when the phase began"),
    (lambda r: r["prefill_launches"].update(flash_attention=23),
     "a prefill launched flash_attention 23 times, want 24"),
    (lambda r: r["prefill_launches"].update(ssd_scan=1),
     "a prefill launched {'ssd_scan': 1}"),
    (lambda r: r["decode_launches"].update(flash_attention=1),
     "decode launched"),
    (lambda r: r.update(finite=False), "non-finite logits"),
    (lambda r: r["routing"].update(dropped=0),
     "no pair dropped at capacity_factor 1.25"),
    (_flip(4, 0.05, 0.003, 0.36),
     "the route flip at step 4, layer 5 is not a near-tie"),
    (_cascade(False),
     "the route flip at step 8, layer 18 is not a near-tie (gap 0.05 > "
     "|Δ router logit| 0.01) with layers [2] pinned to the forward's "
     "experts"),
    (_flip(4, 0.002, 0.003, 0.36, pinned_rel=0.3),
     "bf16 decode with step 4's near-tie flips (layers [5]) pinned to the "
     "forward's experts disagrees with a fresh forward: rel err 0.3 "
     "(tolerance 0.25)"),
    (_flip(0, 0.002, 0.003, 0.36, pinned_rel=0.07),
     "step 0's near-tie flips (layers [5]) pinned to the forward's "
     "experts disagrees with a fresh forward: rel err 0.07 (tolerance "
     "0.0625)"),
    (_flip(4, 0.002, 0.003, 0.36, reproduces=False),
     "a re-run of step 4 does not give the step's logits bit for bit"),
    (lambda r: r["bf16_decode"]["step_rel"].__setitem__(0, 0.07),
     "bf16 decode disagrees with a fresh forward at steps without a "
     "route flip: (step, rel err) [(0, 0.07)]"),
    (lambda r: r["bf16_decode"]["step_rel"].__setitem__(9, 0.3),
     "(step, rel err) [(9, 0.3)]"),
    (lambda r: r["bf16_decode"]["step_rel"].__setitem__(9, float("nan")),
     "(step, rel err) [(9, nan)]"),
    (lambda r: r["f32_decode"]["flips"].append(dict(
        step=2, layer=0, gap=1e-7, delta=1e-6, near_tie=True)),
     "float32 decode routes differently from the forward at (step, "
     "layer) [(2, 0)]"),
    (lambda r: r["f32_decode"]["step_rel"].__setitem__(3, 2e-4),
     "float32 decode disagrees with a fresh forward"),
    (lambda r: r["card_cpu"].update(rel=2e-4),
     "float32 card and CPU logits differ"),
    (lambda r: r["card_cpu"].update(same_tokens=False),
     "greedy tokens differ"),
    (lambda r: r["card_cpu"].update(route_differs=[(3, 1, "slot")]),
     "route differently: (call, layer, field) [(3, 1, 'slot')]"),
], ids=["memory", "launches", "other-kernel", "decode-launch", "finite",
        "no-drop", "flip-not-near-tie", "flip-after-a-pin",
        "pinned-step", "pinned-first-step", "rerun-differs",
        "first-step", "later-step",
        "nan-step", "f32-flip", "f32-step", "card-cpu", "tokens", "routes"])
def test_moe_verdict_names_each_failed_check(change, message):
    res = _moe_passing()
    change(res)
    bad = chip_smoke.moe_failures(res)
    assert len(bad) == 1 and bad[0].startswith("mixtral-8x7b: "), bad
    assert message in bad[0], bad


def test_moe_lines_name_each_flip_and_the_card():
    """Phase 13's printed lines: the card beside the times, and each
    route flip with its gap, Δ and whether an earlier layer of the same
    step flipped first."""
    res = _moe_passing()
    res["bf16_decode"].update(capacity_factor=4.0, greedy_agreement=0.94)
    res["f32_decode"].update(capacity_factor=4.0)
    res["card_cpu"].update(capacity_factor=1.25, layers=2, calls=66,
                           dropped=196, prompt=256, decode=32)
    res["routing"].update(dropped_share=0.06, pairs=786432,
                          layers_dropping=22, per_layer=[{}] * 24)
    res.update(cut="24 of 32 layers", d_model=4096, params=35.09e9,
               batch=8, prompt=2048, prefill_s=0.74, prefill_cold_s=1.1,
               prefill_tokens_per_s=22164.0, decode_ms_per_step=118.2,
               peak_gib=71.17, init_s=0.8, f32_check_s=41.9)
    _cascade(pinned_rel=0.0193)(res)
    lines = chip_smoke.moe_lines(res, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "on NVIDIA H100 80GB HBM3, 700.00 W: 24 layers" in lines[0]
    assert "route flips 2; step 8 layer 2: gap 0.00185, |Δ router logit| " \
        "0.0115, near-tie True, the step's first flip" in lines[2]
    assert "step 8 layer 18: gap 0.634, |Δ router logit| 0.456, near-tie " \
        "False, after the flip at layer 2" in lines[2]
    assert "; step 8 re-run: flips judged layer 2 (gap 0.00185, |Δ| " \
        "0.0115, near-tie True), pinned [2], following from them [18], " \
        "rel err with them pinned 0.0193, unpinned re-run bit-equal " \
        "True" in lines[2]


def test_judge_flips_pins_each_near_tie_in_layer_order():
    """``judge_flips`` on router logits made here: the lowest flipped
    layer is judged first and, as a near-tie, pinned to the forward's
    experts for the re-run; a flip the re-run no longer shows is not
    judged; it stops at a flip that is not a near-tie."""
    fwd = {n: torch.tensor([3.0, 2.0, 1.0, 0.0]) for n in range(4)}
    near = torch.tensor([3.0, 1.99, 2.01, 0.0])    # expert 2 for 1: gap 1
    far = torch.tensor([3.0, 0.5, 2.5, 0.0])       # gap 1, |Δ| 1.5
    bad = torch.tensor([3.0, 1.5, 1.7, 0.0])       # gap 1, |Δ| 0.7
    calls = []

    def rerun(answers):
        def run(pins):
            calls.append(sorted(pins))
            return torch.zeros(1, 3), answers[len(calls) - 1]
        return run
    # served: layer 1 (near-tie) and layer 3 flip; with layer 1 pinned the
    # re-run reads no flip
    served = {0: fwd[0], 1: near, 2: fwd[2], 3: bad}
    j = chip_smoke.judge_flips(fwd, served, 2, rerun([dict(fwd)]))
    assert calls == [[1]] and j["pinned"] == [1]
    assert [f["layer"] for f in j["rounds"]] == [1]
    assert j["rounds"][0]["near_tie"] and j["logits"] is not None
    # with layer 1 pinned, layer 3 still flips: judged, not a near-tie
    calls.clear()
    j = chip_smoke.judge_flips(fwd, served, 2, rerun([served]))
    assert calls == [[1]] and j["pinned"] == [1]
    assert [(f["layer"], f["near_tie"]) for f in j["rounds"]] == [
        (1, True), (3, False)]
    assert j["rounds"][1]["gap"] == 1.0
    assert abs(j["rounds"][1]["delta"] - 0.7) < 1e-6
    # a near-tie that stays is pinned too
    calls.clear()
    two = {0: fwd[0], 1: near, 2: fwd[2], 3: far}
    j = chip_smoke.judge_flips(fwd, served, 2, rerun([two, dict(fwd)]))
    assert calls == [[1], [1, 3]] and j["pinned"] == [1, 3]
    # no flip: nothing re-run
    calls.clear()
    j = chip_smoke.judge_flips(fwd, dict(fwd), 2, rerun([]))
    assert calls == [] and j == dict(rounds=[], pinned=[], logits=None)


def test_decode_vs_forward_rejudges_each_flipped_step():
    """``decode_vs_forward`` with a forward that routes otherwise: a hook
    negates layer 0's MoE input in the one-sequence forward only, so
    every step flips there (a near-tie by the rule, since |Δ router
    logit| is twice the largest logit).  Each flipped step is re-run:
    layer 0 judged first and pinned, the unpinned re-run bit-equal to
    the served step, the flips that follow named apart from those
    judged."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.models.moe import MoE
    cfg = _mixtral(capacity_factor=2.0)
    model = api.init_params(cfg, torch.Generator().manual_seed(9),
                            torch.float32, "cpu")
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 16)))
    first = [m for m in model.modules() if isinstance(m, MoE)][0]
    hook = first.register_forward_pre_hook(
        lambda mod, args: ((-args[0],) + args[1:]
                           if args[0].shape[0] == 1 else None))
    try:
        d = chip_smoke.decode_vs_forward(model, cfg, prompts, 3)
    finally:
        hook.remove()
    assert {f["step"] for f in d["flips"]} == {0, 1, 2}
    assert [j["step"] for j in d["judged"]] == [0, 1, 2]
    for j in d["judged"]:
        served = {f["layer"] for f in d["flips"] if f["step"] == j["step"]}
        judged = [f["layer"] for f in j["rounds"]]
        assert judged[0] == 0 and j["rounds"][0]["near_tie"]
        assert j["pinned"][0] == 0 and j["reproduces"]
        assert isinstance(j["pinned_rel"], float)
        assert set(j["follows"]) == served - set(judged)


def test_decode_vs_forward_reruns_hybrid_steps_from_their_ssm_states():
    """The same forced flips on the reduced jamba, whose SSM layers carry
    a recurrent state that each decode step replaces: a re-run of step i
    starts from the states step i started from (kept on the host), so
    the unpinned re-run of every flipped step gives its logits bit for
    bit, not those of a step taken from the last step's state."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.models.moe import MoE
    cfg = _jamba(capacity_factor=2.0)
    model = api.init_params(cfg, torch.Generator().manual_seed(9),
                            torch.float32, "cpu")
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 16)))
    first = [m for m in model.modules() if isinstance(m, MoE)][0]
    hook = first.register_forward_pre_hook(
        lambda mod, args: ((-args[0],) + args[1:]
                           if args[0].shape[0] == 1 else None))
    try:
        d = chip_smoke.decode_vs_forward(model, cfg, prompts, 3)
    finally:
        hook.remove()
    assert [j["step"] for j in d["judged"]] == [0, 1, 2]
    assert all(j["reproduces"] for j in d["judged"])


def test_pinned_step_routes_sequence_zero_as_told():
    """``pinned_step`` on the reduced mixtral in float32 on the CPU: with
    no pin, or sequence 0 pinned to the experts it chooses, the step
    equals ``api.decode_step`` bit for bit; pinned to other experts at
    layer 0, its logits move while layer 0's router logits do not; a
    re-run after later steps gives the step again (the causal mask hides
    their cache rows)."""
    import numpy as np

    from repro_torch.models import api
    cfg = _mixtral(capacity_factor=2.0)
    model = api.init_params(cfg, torch.Generator().manual_seed(5),
                            torch.float32, "cpu")
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 16)))
    tok = prompts[:, -1:]
    with torch.no_grad():
        _, caches = api.prefill(model, {"tokens": prompts}, cfg,
                                cache_cap=20)
        want, _ = api.decode_step(model, tok, 16, caches, cfg)
        got, seen = chip_smoke.pinned_step(model, cfg, tok, 16, caches, {})
        assert torch.equal(got, want) and sorted(seen) == [0, 1]
        own = torch.sort(seen[0], descending=True,
                         stable=True).indices[:cfg.top_k]
        same, _ = chip_smoke.pinned_step(model, cfg, tok, 16, caches,
                                         {0: own})
        assert torch.equal(same, want)
        other = torch.sort(seen[0], descending=False,
                           stable=True).indices[:cfg.top_k]
        moved, seen_o = chip_smoke.pinned_step(model, cfg, tok, 16, caches,
                                               {0: other})
        assert not torch.equal(moved[0], want[0])
        assert torch.equal(seen_o[0], seen[0])
        assert not torch.equal(seen_o[1], seen[1])
        chip_smoke.pinned_step(model, cfg, tok, 16, caches, {})
        for i in range(3):
            api.decode_step(model, tok, 17 + i, caches, cfg)
        again, _ = chip_smoke.pinned_step(model, cfg, tok, 16, caches, {})
        assert torch.equal(again, want)



# ---------------------------------------------------------------------------
# Phases 5, 6 and 14: the serving path of the LMs, the encoder-decoder
# and the vlm, rehearsed on reduced configs on the CPU
# ---------------------------------------------------------------------------


class _RecordingApi:
    """``models.api``'s prefill / decode_step as ``greedy`` calls them:
    the batches and positions it passes, fixed logits back."""

    def __init__(self, vocab=8):
        self.prefills, self.positions, self.vocab = [], [], vocab

    def prefill(self, model, batch, cfg, cache_cap=None):
        self.prefills.append((dict(batch), cache_cap))
        return torch.zeros((batch["tokens"].shape[0], self.vocab)), "caches"

    def decode_step(self, model, token, pos, caches, cfg):
        self.positions.append(pos)
        return torch.zeros((token.shape[0], self.vocab)), caches


def test_greedy_keeps_phase_5_6_batches_and_positions():
    """Without stub inputs and offset (phases 5, 6 and 13) the prefill
    batch holds the tokens alone and decode runs at len + i; with them
    (phase 14) the batch carries the frames / patches and the positions
    start past the patches."""
    tokens = torch.zeros((2, 5), dtype=torch.long)
    api = _RecordingApi()
    gen, steps, caches = chip_smoke.greedy(api, None, None, tokens, 3, 8)
    (batch, cap), = api.prefills
    assert set(batch) == {"tokens"} and batch["tokens"] is tokens
    assert cap == 8 and api.positions == [5, 6, 7]
    assert gen.shape == (2, 4) and len(steps) == 4 and caches == "caches"
    patches = torch.ones((2, 3, 4))
    api = _RecordingApi()
    chip_smoke.greedy(api, None, None, tokens, 3, 11,
                      extra={"patches": patches}, offset=3)
    (batch, cap), = api.prefills
    assert set(batch) == {"tokens", "patches"} and batch["patches"] is patches
    assert cap == 11 and api.positions == [8, 9, 10]


def test_stub_inputs_are_seeded_and_sequence_zero_is_shared():
    whisper, vlm = _reduced("whisper-small"), _reduced("internvl2-1b")
    assert chip_smoke.stub_inputs(_reduced("smollm-360m"), 7) is None
    make = chip_smoke.stub_inputs(whisper, 7)
    eight = make(8, torch.bfloat16, "cpu")["frames"]
    one = make(1, torch.float32, "cpu")["frames"]
    assert eight.shape == (8, whisper.enc_seq, whisper.d_model)
    assert eight.dtype == torch.bfloat16 and one.dtype == torch.float32
    assert torch.equal(eight[:1], one.to(torch.bfloat16))
    assert torch.equal(one, make(1, torch.float32, "cpu")["frames"])
    p = chip_smoke.stub_inputs(vlm, 7)(2, torch.float32, "cpu")["patches"]
    assert p.shape == (2, vlm.n_patches, vlm.d_model)
    assert chip_smoke.prefill_launches_want(whisper, "flash_attention") == \
        {"flash_attention": 6}
    assert chip_smoke.prefill_launches_want(vlm, "flash_attention") == \
        {"flash_attention": 2}


def test_phase_lm_on_the_cpu():
    """Phase 5's path (no stub input, no offset) on the reduced
    smollm-360m: decode equals the fresh forward, the float32 'card'
    (the CPU here) equals the CPU; only the launch checks fail."""
    cfg = _reduced("smollm-360m")
    res = chip_smoke.phase_lm(cfg, "flash_attention", 7, device="cpu",
                              batch=2, prompt=16, decode=4, check_prompt=16,
                              check_decode=4)
    assert res["offset"] == 0 and res["stub"] == {}
    assert len(res["generated"]) == 5
    assert chip_smoke.family_failures(res) == [
        "smollm-360m: a prefill launched flash_attention 0 times, want 2",
        "smollm-360m: float32 prefill launched flash_attention 0 times, "
        "want 2"]


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_phase_family_on_the_cpu(arch):
    """Phase 14 rehearsed on the reduced whisper / internvl2: decode
    equals the fresh forward over sequence 0 with its frames / patches,
    the float32 'card' (the CPU here) equals the CPU, whisper's
    mixed-dtype prefill runs B5 (its plain version here) as the card
    must — float32 encoder and cross, bf16 decoder self — with JAX's
    output dtypes; only the launch checks fail."""
    cfg = _reduced(arch)
    res = chip_smoke.phase_family(cfg, 7, 16, device="cpu", batch=2,
                                  decode=4, check_prompt=16, check_decode=4)
    want = 6 if cfg.family == "encdec" else 2
    bad = [f"{arch}: a prefill launched flash_attention 0 times, want "
           f"{want}",
           f"{arch}: float32 prefill launched flash_attention 0 times, "
           f"want {want}"]
    if cfg.family == "encdec":
        pr = res["promotion"]
        assert pr["by_dtype"] == pr["want_by_dtype"] == [
            ["bfloat16", True, 16, 16, 2], ["float32", False, 16, 64, 2],
            ["float32", False, 64, 64, 2]]
        assert pr["dtypes"] == pr["want_dtypes"]
        bad.append(f"{arch}: the mixed-dtype prefill launched "
                   "flash_attention 0 times, want 6")
        assert res["stub"] == {"frames": [2, 64, 128]}
        assert res["offset"] == 0
    else:
        assert res["stub"] == {"patches": [2, 16, 128]}
        assert res["offset"] == 16 and "promotion" not in res
    assert chip_smoke.family_failures(res) == bad
    lines = chip_smoke.family_lines(res, "CPU, 0 W")
    assert lines[0].startswith(f"{arch} [{cfg.family}] on CPU, 0 W: ")
    assert ("encoder frames/s" in lines[0]) == (cfg.family == "encdec")
    assert len(lines) == (2 if cfg.family == "encdec" else 1)


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", "glm4-9b"])
def test_phase_dense_on_the_cpu(arch):
    """Phase 18 rehearsed on the reduced gemma-2b (GeGLU, MQA, tied
    table), olmo-1b (the non-parametric LayerNorm, MHA) and glm4-9b
    (GQA, untied): decode equals the fresh forward over sequence 0, the
    float32 'card' (the CPU here) equals the CPU at the reckoned depth
    over the given steps; only the launch checks fail."""
    cfg = _reduced(arch)
    res = chip_smoke.phase_dense(cfg, 7, device="cpu", batch=2, prompt=16,
                                 decode=4, check_prompt=16, check_decode=4)
    assert res["f32_n_layers"] == chip_smoke.dense_check_layers(cfg) == 2
    assert len(res["generated"]) == 5 and res["stub"] == {}
    assert res["allocated_before"] == res["allocated_after"] == 0
    assert chip_smoke.dense_failures(res) == [
        f"{arch}: a prefill launched flash_attention 0 times, want 2",
        f"{arch}: float32 prefill launched flash_attention 0 times, want 2"]
    line = chip_smoke.dense_line(res, "CPU, 0 W")
    assert line.startswith(f"{arch} [dense] on CPU, 0 W: 2 layers, d 128")
    assert "(DENSE_CHECK_DECODE)" in line


def test_dense_verdict_names_memory_left_allocated():
    res = dict(_family_passing(), promotion=None, allocated_before=1024,
               allocated_after=1024)
    assert chip_smoke.dense_failures(res) == []
    res["allocated_after"] = 1536
    assert chip_smoke.dense_failures(res) == [
        "whisper-small: 512 B more allocated after the model than before "
        "it"]


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", "glm4-9b",
                                  "kimi-k2-1t-a32b"])
def test_f32_step_bytes_are_the_layers_and_the_unembedding(arch):
    """``f32_step_bytes`` counts what a float32 decode step reads: the
    built model's layers and its unembedding table (the tied embedding
    for gemma-2b and olmo-1b, glm4-9b's and kimi-k2's own); a MoE layer
    its router and every expert."""
    from repro_torch.models import api
    cfg = _reduced(arch)
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    layers = sum(p.numel() for p in model.groups.parameters())
    table = (model.embed.tok if cfg.tie_embeddings
             else model.embed.unembed).numel()
    assert chip_smoke.f32_step_bytes(cfg, cfg.n_layers) == 4 * (layers + table)


def test_dense_check_layers_reckons_each_published_model():
    """Phase 18's float32 checks at published width: each CPU decode
    step reads at most DENSE_CHECK_STEP_BYTES — glm4-9b 2 layers of
    ~0.82 GB beside its 2.48 GB table, gemma-2b 4 of ~0.44 GB beside
    2.10 GB, olmo-1b F32_CHECK_LAYERS (~0.27 GB beside 0.41 GB) — and
    a table past the budget still leaves one layer."""
    import dataclasses
    want = {"glm4-9b": (2, 815_824_896, 2_483_027_968),
            "gemma-2b": (4, 440_418_304, 2_097_152_000),
            "olmo-1b": (chip_smoke.F32_CHECK_LAYERS, 268_435_456,
                        412_090_368)}
    for arch, (n, layer, table) in want.items():
        cfg = chip_smoke.lm_config(arch, 0)
        assert chip_smoke.f32_step_bytes(cfg, 0) == table
        assert chip_smoke.f32_step_bytes(cfg, 1) - table == layer
        assert chip_smoke.dense_check_layers(cfg) == n
        assert chip_smoke.f32_step_bytes(cfg, n) <= \
            chip_smoke.DENSE_CHECK_STEP_BYTES
    huge = dataclasses.replace(chip_smoke.lm_config("glm4-9b", 0),
                               vocab=10 ** 6)
    assert chip_smoke.dense_check_layers(huge) == 1


def _family_passing():
    """Phase 14's whisper results as a passing run leaves them (the
    float32 and promotion checks at F32_CHECK_LAYERS, 6 + 6)."""
    bd = [["bfloat16", True, 256, 256, 6], ["float32", False, 256, 1500, 6],
          ["float32", False, 1500, 1500, 6]]
    dt = {"encoder": ["float32"], "xk/xv": ["float32"],
          "self-KV": ["bfloat16"], "logits": ["float32"]}
    return dict(
        arch="whisper-small", kernel="flash_attention",
        want_launches={"flash_attention": 36},
        prefill_launches={"flash_attention": 36, "ssd_scan": 0},
        decode_launches={"flash_attention": 0, "ssd_scan": 0}, finite=True,
        decode_rel_err_by_step=[0.01] * 32, f32_launches=18,
        f32_want_launches={"flash_attention": 18},
        f32_rel_err=1e-6, f32_greedy_identical=True,
        promotion=dict(launches={"flash_attention": 18}, want_total=18,
                       by_dtype=[list(b) for b in bd], want_by_dtype=bd,
                       dtypes=dict(dt), want_dtypes=dt,
                       rel=dict(encoder=1e-6, xk=1e-6, xv=1e-6,
                                logits=0.01)))


@pytest.mark.parametrize("change,message", [
    (lambda r: r["prefill_launches"].update(flash_attention=24),
     "a prefill launched flash_attention 24 times, want 36"),
    (lambda r: r["prefill_launches"].update(ssd_scan=1),
     "a prefill launched ssd_scan 1 times, want 0"),
    (lambda r: r["decode_launches"].update(flash_attention=1),
     "decode launched"),
    (lambda r: r.update(finite=False), "non-finite logits"),
    (lambda r: r["decode_rel_err_by_step"].__setitem__(0, 0.07),
     "bf16 decode disagrees with a fresh forward"),
    (lambda r: r["decode_rel_err_by_step"].__setitem__(9, float("nan")),
     "bf16 decode disagrees with a fresh forward"),
    (lambda r: r.update(f32_launches=12),
     "float32 prefill launched flash_attention 12 times, want 18"),
    (lambda r: r.update(f32_rel_err=2e-4), "float32 card and CPU disagree"),
    (lambda r: r.update(f32_greedy_identical=False),
     "greedy tokens identical: False"),
    (lambda r: r["promotion"]["launches"].update(flash_attention=24),
     "the mixed-dtype prefill launched flash_attention 24 times"),
    (lambda r: r["promotion"]["by_dtype"][1].__setitem__(0, "bfloat16"),
     "the mixed-dtype prefill ran B5 as"),
    (lambda r: r["promotion"]["dtypes"].update(encoder=["bfloat16"]),
     "mixed-dtype outputs"),
    (lambda r: r["promotion"]["rel"].update(xk=2e-4),
     "float32 xk differs from the CPU's by 0.0002"),
    (lambda r: r["promotion"]["rel"].update(logits=0.07),
     "the mixed-dtype prefill's logits differ from the CPU's"),
], ids=["launches", "other-kernel", "decode-launch", "finite", "first-step",
        "nan-step", "f32-launches", "card-cpu", "tokens", "mixed-launches",
        "mixed-dtype", "mixed-outputs", "mixed-f32", "mixed-logits"])
def test_family_verdict_names_each_failed_check(change, message):
    assert chip_smoke.family_failures(_family_passing()) == []
    res = _family_passing()
    change(res)
    bad = chip_smoke.family_failures(res)
    assert len(bad) == 1 and bad[0].startswith("whisper-small: "), bad
    assert message in bad[0], bad


def test_attention_case_full_non_causal_builds_no_mask():
    """A non-causal case with no kv_len and no window hands the library
    no mask (an all-true one would send it off its fast path): the case
    builds on the CPU, where a mask would be made on the card, and the
    library call equals the plain version."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    case = chip_smoke.attention_case(randn, 1, 4, 2, 6, 10, 32,
                                     torch.float32, False, None, None)
    assert float((case["library"]() - case["plain"]()).abs().max()) < 1e-5
    assert case["ops"] == 4 * 32 * 6 * 10 * 4


# ---------------------------------------------------------------------------
# Phase 16's host side: jamba-1.5-large's distinct MoE layers, the shared
# experts, its verdict and a CPU rehearsal on the reduced config; phase
# 2's kimi-k2 attention case
# ---------------------------------------------------------------------------


def _jamba(**over):
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    return reduced(get_config(chip_smoke.HYBRID_ARCH), **over)


def test_hybrid_distinct_moe_reckons_two_on_an_h100():
    """One published period is 90.3 GB of weights with its four MoE
    layers' experts; each MoE layer that shares another's saves 19.3 GB.
    With 18 GiB for activations, 78.5 GiB free and 70 GiB hold 2 and 50
    GiB 1 (which the phase then fails); the override wins."""
    cfg = chip_smoke.hybrid_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff) == (
        8, 8192, 16, 24576)
    assert [round(chip_smoke.hybrid_weight_bytes(cfg, n) / 1e9, 2)
            for n in (1, 2, 3, 4)] == [32.31, 51.64, 70.96, 90.29]
    n, why = chip_smoke.hybrid_distinct_moe(cfg, int(78.5 * 2 ** 30))
    assert n == 2 and why.startswith("2 of 4 MoE layers with experts of "
                                     "their own: the weights are 90.3 GB")
    assert "MoE layers 3..4 route over MoE layer 2's 16 experts" in why
    assert chip_smoke.hybrid_distinct_moe(cfg, 85 * 2 ** 30)[0] == 3
    assert chip_smoke.hybrid_distinct_moe(cfg, 70 * 2 ** 30)[0] == 2
    assert chip_smoke.hybrid_distinct_moe(cfg, 50 * 2 ** 30)[0] == 1
    assert chip_smoke.hybrid_distinct_moe(cfg, 50 * 2 ** 30, 2) == (
        2, "2 of 4 MoE layers with experts of their own (--hybrid-distinct)")
    check = chip_smoke.hybrid_check_config(cfg)
    assert round(2 * chip_smoke.hybrid_weight_bytes(check, 4) / 1e9, 1) \
        == 3.3


@pytest.mark.parametrize("distinct", [1, 2, 3, 4])
def test_shared_experts_keep_routers_and_weigh_as_reckoned(distinct):
    """The MoE layers past the first ``distinct`` hold the last distinct
    layer's expert Parameters themselves (one storage), each its own
    router; the bf16 model stores the bytes ``hybrid_weight_bytes``
    reckons, and serves as many parameters as an unshared one."""
    from repro_torch.models.moe import MoE
    cfg = _jamba()
    model = chip_smoke.hybrid_model(cfg, 7, distinct, torch.bfloat16, "cpu")
    mods = [m for m in model.modules() if isinstance(m, MoE)]
    assert len(mods) == chip_smoke.n_moe_layers(cfg) == 4
    last = mods[distinct - 1]
    for i, m in enumerate(mods):
        for name in ("w_up", "w_gate", "w_down"):
            same = getattr(m, name) is getattr(last, name)
            assert same == (i >= distinct - 1), (i, name)
        for other in mods[:i]:
            assert m.wg is not other.wg
            assert not torch.equal(m.wg, other.wg)
            if i < distinct:
                assert m.w_up.data_ptr() != other.w_up.data_ptr()
    sh = chip_smoke.expert_sharing(model)
    assert sh["stored_bytes"] == chip_smoke.hybrid_weight_bytes(cfg,
                                                                distinct)
    full = chip_smoke.expert_sharing(chip_smoke.hybrid_model(
        cfg, 7, 4, torch.bfloat16, "cpu"))
    assert sh["served"] == full["served"] == full["stored"]
    names = [n for n, m in model.named_modules() if isinstance(m, MoE)]
    assert sh["shares"] == {n: names[distinct - 1]
                            for n in names[distinct:]}


def test_phase_hybrid_on_the_cpu():
    """Phase 16 rehearsed on the reduced jamba at its published capacity
    factor, 2 of its 4 MoE layers with experts of their own: the decode
    equals the fresh forward at the check-only capacity (E / k), the
    float32 'card' (the CPU here) routes as the CPU; only the launch
    checks fail, since no kernel runs on the CPU."""
    cfg = _jamba(capacity_factor=1.25)
    res = chip_smoke.phase_hybrid(cfg, 7, 2, device="cpu", batch=2,
                                  prompt=64, decode=4, check_cfg=cfg,
                                  check_prompt=32, check_decode=4)
    assert chip_smoke.hybrid_failures(res) == [
        "jamba-1.5-large-398b: a prefill launched flash_attention 0 times, "
        "want 1",
        "jamba-1.5-large-398b: a prefill launched ssd_scan 0 times, want 7"]
    assert res["want"] == {"flash_attention": 1, "ssd_scan": 7}
    assert res["shares"] == {"groups.0.l5.moe": "groups.0.l3.moe",
                             "groups.0.l7.moe": "groups.0.l3.moe"}
    assert len(res["routing"]["per_layer"]) == 4
    assert res["routing"]["dropped"] > 0
    assert res["bf16_decode"]["capacity_factor"] == cfg.n_experts / 2
    assert len(res["bf16_decode"]["step_rel"]) == 4
    c = res["card_cpu"]
    assert c["calls"] == 4 * (1 + 4) and c["rel"] == 0.0
    assert c["flips"] == [] and c["unexplained"] == []


def _hybrid_passing():
    """Phase 16's results as a passing run leaves them."""
    want = {"flash_attention": 1, "ssd_scan": 7}
    return dict(
        arch="jamba-1.5-large-398b", distinct=3, moe_layers=4, want=want,
        allocated_before=2 ** 20, prefill_launches=dict(want,
                                                        delta_apply=0),
        decode_launches={"flash_attention": 0, "ssd_scan": 0}, finite=True,
        bf16_decode=dict(step_rel=[0.01] * 32, flips=[], judged=[],
                         finite=True),
        card_cpu=dict(rel=1e-6, same_tokens=True, flips=[], unexplained=[]))


@pytest.mark.parametrize("change,message", [
    (lambda r: r.update(distinct=1),
     "1 of 4 MoE layers with experts of their own, fewer than 2"),
    (lambda r: r.update(allocated_before=3 * 2 ** 30),
     "3.00 GiB still allocated when the phase began"),
    (lambda r: r["prefill_launches"].update(ssd_scan=6),
     "a prefill launched ssd_scan 6 times, want 7"),
    (lambda r: r["prefill_launches"].update(delta_apply=1),
     "a prefill launched {'delta_apply': 1}"),
    (lambda r: r["decode_launches"].update(ssd_scan=1),
     "decode launched"),
    (lambda r: r["bf16_decode"]["step_rel"].__setitem__(0, 0.07),
     "bf16 decode disagrees with a fresh forward at steps without a "
     "route flip: (step, rel err) [(0, 0.07)]"),
    (lambda r: r["card_cpu"].update(rel=2e-4),
     "float32 card and CPU logits differ by 0.0002"),
    (lambda r: r["card_cpu"].update(same_tokens=False),
     "float32 card and CPU greedy tokens differ"),
    (lambda r: r["card_cpu"]["flips"].append(dict(
        call=3, layer=1, token=0, gap=0.5, delta=0.01, near_tie=False)),
     "route tokens differently with no near-tie: (call, layer, token) "
     "[(3, 1, 0)]"),
    (lambda r: r["card_cpu"]["unexplained"].append((2, 0)),
     "keep or slot pairs differently with every token routed alike"),
])
def test_hybrid_verdict_names_each_failed_check(change, message):
    assert chip_smoke.hybrid_failures(_hybrid_passing()) == []
    res = _hybrid_passing()
    res["card_cpu"]["flips"].append(dict(call=1, layer=0, token=0, gap=1e-6,
                                         delta=2e-6, near_tie=True))
    assert chip_smoke.hybrid_failures(res) == []
    change(res)
    bad = chip_smoke.hybrid_failures(res)
    assert len(bad) == 1 and bad[0].startswith("jamba-1.5-large-398b: "), bad
    assert message in bad[0], bad


def test_route_differences_judge_each_token_and_swaps():
    """A token with other experts is judged by ``route_flip``; the same
    experts in another order by the gap between the pair that swaps; a
    keep mask that differs with every token routed alike is named."""
    t = torch.tensor
    logits = t([[3.0, 2.0, 1.99, 0.0], [1.0, 0.5, 0.0, -1.0],
                [2.0, 1.999, 0.0, -1.0]])
    cpu = [(0, t([[0, 1], [0, 1], [0, 1]]), t([True] * 6),
            t(range(6)), logits)]
    card_logits = logits + t([[0.0, 0.0, 0.02, 0.0], [0.0] * 4,
                              [0.0, 0.002, 0.0, 0.0]])
    card = [(0, t([[0, 2], [0, 1], [1, 0]]), t([True] * 6),
             t(range(6)), card_logits)]
    d = chip_smoke.route_differences(card, cpu, 2)
    assert [(f["token"], f["near_tie"]) for f in d["flips"]] == [
        (0, True), (2, True)]
    assert d["flips"][1]["gap"] == pytest.approx(0.001, abs=1e-6)
    assert d["unexplained"] == []
    same = [(0, cpu[0][1], t([True] * 5 + [False]), cpu[0][3], logits)]
    assert chip_smoke.route_differences(same, cpu, 2)["unexplained"] == [
        (0, 0)]


def test_attention_case_at_kimi_k2_head_dim():
    """Phase 2's kimi-k2 case (head dim 112, which the launch pads to 128)
    builds on the CPU, its bound counts the unpadded work, and the
    kernel's CPU path and the library equal the plain version."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    case = chip_smoke.attention_case(randn, 1, 8, 2, 16, 16, 112,
                                     torch.float32, True, None, None)
    assert case["ops"] == 4 * 112 * (16 * 17 // 2) * 8
    assert case["bytes"] == 4 * (2 * 8 * 16 * 112 + 2 * 2 * 16 * 112)
    assert "D=112" in case["shape"]
    plain = case["plain"]()
    assert torch.equal(case["kernel"](), plain)
    assert float((case["library"]() - plain).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# Phase 19's host side: kimi-k2's depth and float32 check reckoned at
# published width, the shared-expert layers, its verdict and lines, and a
# CPU rehearsal on a narrow kimi-k2 with its 384 experts; phase 15's
# training reckonings
# ---------------------------------------------------------------------------


def _kimi(**over):
    """kimi-k2 narrow (``reduced``'s widths) with its published 384
    experts top-8 and capacity factor."""
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    return reduced(get_config(chip_smoke.KIMI_ARCH),
                   **dict(dict(n_experts=384, top_k=8, capacity_factor=1.25,
                               n_layers=3), **over))


def test_kimi_depth_reckons_one_distinct_layer_on_an_h100():
    """At published width one layer with its 384 experts and the untied
    tables is 38.76 GB of bf16, two 72.83 GB; beside (c)'s forward over
    2,080 tokens at capacity = T (three 11.45 GB tensors) and
    KIMI_OTHER_BYTES, 75.6 GiB free hold one layer with experts of its
    own and not two; the layers past it cost 0.242 GB each, and
    KIMI_LAYERS caps the depth unless ``--lm-layers`` sets it."""
    import dataclasses
    cfg = chip_smoke.lm_config(chip_smoke.KIMI_ARCH, 0)
    assert (cfg.d_model, cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.hd(),
            cfg.vocab, cfg.capacity_factor) == (7168, 384, 8, 2048, 112,
                                                163840, 1.25)
    one, two = (dataclasses.replace(cfg, n_layers=n) for n in (1, 2))
    assert round(chip_smoke.hybrid_weight_bytes(one, 1) / 1e9, 2) == 38.76
    assert round(chip_smoke.hybrid_weight_bytes(two, 2) / 1e9, 2) == 72.83
    assert chip_smoke.hybrid_weight_bytes(one, 1) == \
        chip_smoke.moe_weight_bytes(one)
    check = dataclasses.replace(cfg, capacity_factor=48.0)
    assert round(chip_smoke.moe_call_bytes(check, 2080) / 3 / 1e9, 2) == \
        11.45
    transient = chip_smoke.kimi_transient_bytes(cfg)
    assert transient == chip_smoke.moe_call_bytes(check, 2080) + \
        chip_smoke.KIMI_OTHER_BYTES
    free = int(75.6 * 2 ** 30)
    assert chip_smoke.hybrid_weight_bytes(one, 1) + transient <= free
    assert chip_smoke.hybrid_weight_bytes(two, 2) + transient > free
    distinct, layers, why = chip_smoke.kimi_depth(cfg, free)
    assert (distinct, layers) == (1, chip_smoke.KIMI_LAYERS) == (1, 2)
    assert why.startswith("1 of 2 MoE layers with experts of their own")
    assert "MoE layers 2..2 route over MoE layer 1's 384 experts" in why
    assert "another's experts is 0.242 GB, so the card holds 16 of 61 " \
        "layers; 2 served (KIMI_LAYERS" in why
    assert chip_smoke.kimi_depth(cfg, free, 4)[:2] == (1, 4)
    assert chip_smoke.kimi_depth(cfg, 60 * 2 ** 30)[:2] == (1, 1)


def test_kimi_shared_layers_weigh_as_reckoned():
    """The model phase 19 builds (``hybrid_model``, one layer with
    experts of its own) stores what ``hybrid_weight_bytes`` reckons; a
    layer more adds its attention, norms and router alone, each later
    layer holding the first layer's expert Parameters with a router of
    its own."""
    import dataclasses
    from repro_torch.models.moe import MoE
    cfg = _kimi()
    sizes = {}
    for n in (2, 3):
        c = dataclasses.replace(cfg, n_layers=n)
        model = chip_smoke.hybrid_model(c, 7, 1, torch.bfloat16, "cpu")
        sh = chip_smoke.expert_sharing(model)
        assert sh["stored_bytes"] == chip_smoke.hybrid_weight_bytes(c, 1)
        sizes[n] = sh["stored_bytes"]
    mods = [m for m in model.modules() if isinstance(m, MoE)]
    assert all(m.w_up is mods[0].w_up and m.w_down is mods[0].w_down
               and m.w_gate is mods[0].w_gate for m in mods)
    assert len({id(m.wg) for m in mods}) == 3
    layer = model.groups[2]
    assert sizes[3] - sizes[2] == sum(
        p.numel() * p.element_size() for n, p in layer.named_parameters()
        if not n.endswith(("w_up", "w_gate", "w_down")))


def test_kimi_check_config_reckons_d_384():
    """(d)'s float32 check: one layer, the published 384 experts top-8 of
    d_ff 2048, 8 / 1 heads of 112, vocabulary and capacity, at d 384,
    whose CPU decode step reads 3.88 GB with every expert (d 512 would
    read 5.17 GB, past DENSE_CHECK_STEP_BYTES); without the experts'
    term the dense count would read 0.26 GB."""
    import dataclasses
    cfg = chip_smoke.lm_config(chip_smoke.KIMI_ARCH, 0)
    small = chip_smoke.kimi_check_config(cfg)
    assert (small.d_model, small.n_layers, small.n_heads, small.n_kv_heads,
            small.hd(), small.n_experts, small.top_k, small.d_ff,
            small.vocab, small.capacity_factor) == (
        384, 1, 8, 1, 112, 384, 8, 2048, 163840, 1.25)
    step = chip_smoke.f32_step_bytes(small, 1)
    assert round(step / 1e9, 2) == 3.88
    assert step <= chip_smoke.DENSE_CHECK_STEP_BYTES
    wider = dataclasses.replace(small, d_model=512)
    assert round(chip_smoke.f32_step_bytes(wider, 1) / 1e9, 2) == 5.17
    dense = dataclasses.replace(small, n_experts=0)
    assert round(chip_smoke.f32_step_bytes(dense, 1) / 1e9, 2) == 0.26


def test_phase_kimi_on_the_cpu():
    """Phase 19 rehearsed on a narrow kimi-k2 with its 384 experts top-8
    at capacity factor 1.25, three layers routing over the first one's
    experts: pairs drop, the bf16 check decodes sequence 0 alone at E / k,
    the float32 'card' (the CPU here) routes as the CPU, nothing stays
    allocated; only the launch check fails, since no kernel runs on the
    CPU."""
    cfg = _kimi()
    res = chip_smoke.phase_kimi(cfg, 7, 1, device="cpu", batch=2, prompt=64,
                                decode=4, check_cfg=cfg, check_prompt=32,
                                check_decode=4)
    assert chip_smoke.kimi_failures(res) == [
        "kimi-k2-1t-a32b: a prefill launched flash_attention 0 times, "
        "want 3"]
    assert res["want"] == {"flash_attention": 3, "ssd_scan": 0}
    assert res["shares"] == {"groups.1.l0.moe": "groups.0.l0.moe",
                             "groups.2.l0.moe": "groups.0.l0.moe"}
    assert res["served"] > res["stored"]
    ro = res["routing"]
    assert len(ro["per_layer"]) == 3 and ro["dropped"] > 0
    assert ro["fullest"] > ro["cap"] == 8
    b = res["bf16_decode"]
    assert b["batch"] == 1 and b["capacity_factor"] == 48.0
    assert len(b["step_rel"]) == 4
    c = res["card_cpu"]
    assert c["calls"] == 3 * (1 + 4) and c["rel"] == 0.0
    assert c["flips"] == [] and c["unexplained"] == []
    assert res["allocated_before"] == res["allocated_after"] == 0
    # the lines a card run prints, with the card's readings filled in
    res.update(prefill_s=0.5, prefill_tokens_per_s=32768.0, peak_gib=70.0,
               weights_gib=36.8, f32_check_s=9.0, profile_prefill=None,
               profile_decode8=dict(kernels=8 * 3 * 2700, wall_s=0.8,
                                    device_s=0.2, busy=0.25, top_ms=[]))
    lines = chip_smoke.kimi_lines(res, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert lines[0].startswith("kimi-k2-1t-a32b [moe] on NVIDIA H100 80GB "
                               "HBM3, 700.00 W: 3 layers, d 128, 384 experts")
    assert "bf16 decode of 1 prompt(s)" in lines[3]
    assert "runs 8100 device kernels (2700 a layer), 100.000 ms under the " \
        "profiler, device busy 0.250: the host's share 0.750" in lines[-2]
    assert lines[-1] == ("kimi-k2-1t-a32b: allocated before the model 0 B, "
                         "after 0 B")


def _kimi_passing():
    """Phase 19's results as a passing run leaves them."""
    return dict(_hybrid_passing(), arch="kimi-k2-1t-a32b", distinct=1,
                moe_layers=4, want={"flash_attention": 4, "ssd_scan": 0},
                prefill_launches={"flash_attention": 4, "ssd_scan": 0},
                capacity_factor=1.25,
                routing=dict(dropped=9000, cap=432, fullest=2000),
                allocated_after=2 ** 20)


@pytest.mark.parametrize("change,message", [
    (lambda r: r.update(allocated_before=3 * 2 ** 30, allocated_after=0),
     "3.00 GiB still allocated when the phase began"),
    (lambda r: r["prefill_launches"].update(flash_attention=3),
     "a prefill launched flash_attention 3 times, want 4"),
    (lambda r: r["prefill_launches"].update(delta_apply=1),
     "a prefill launched {'delta_apply': 1}"),
    (lambda r: r["decode_launches"].update(flash_attention=1),
     "decode launched"),
    (lambda r: r.update(finite=False), "non-finite logits"),
    (lambda r: r["routing"].update(dropped=0),
     "no pair dropped at capacity_factor 1.25 (capacity 432"),
    (lambda r: r["bf16_decode"]["step_rel"].__setitem__(3, 0.3),
     "bf16 decode disagrees with a fresh forward at steps without a "
     "route flip: (step, rel err) [(3, 0.3)]"),
    (lambda r: r["card_cpu"].update(rel=2e-4),
     "float32 card and CPU logits differ by 0.0002"),
    (lambda r: r["card_cpu"].update(same_tokens=False),
     "float32 card and CPU greedy tokens differ"),
    (lambda r: r["card_cpu"]["flips"].append(dict(
        call=3, layer=1, token=0, gap=0.5, delta=0.01, near_tie=False)),
     "route tokens differently with no near-tie: (call, layer, token) "
     "[(3, 1, 0)]"),
    (lambda r: r["card_cpu"]["unexplained"].append((2, 0)),
     "keep or slot pairs differently with every token routed alike"),
    (lambda r: r.update(allocated_after=2 ** 20 + 512),
     "512 B more allocated after the model than before it"),
], ids=["memory", "launches", "other-kernel", "decode-launch", "finite",
        "no-drop", "bf16-step", "card-cpu", "tokens", "no-near-tie",
        "unexplained", "left-allocated"])
def test_kimi_verdict_names_each_failed_check(change, message):
    """``kimi_failures`` passes a passing run, a near-tie route
    difference between card and CPU and a single distinct MoE layer, and
    names each failed check alone."""
    assert chip_smoke.kimi_failures(_kimi_passing()) == []
    res = _kimi_passing()
    res["card_cpu"]["flips"].append(dict(call=1, layer=0, token=0, gap=1e-6,
                                         delta=2e-6, near_tie=True))
    assert chip_smoke.kimi_failures(res) == []
    change(res)
    bad = chip_smoke.kimi_failures(res)
    assert len(bad) == 1 and bad[0].startswith("kimi-k2-1t-a32b: "), bad
    assert message in bad[0], bad


def test_int8_train_reckonings_count_the_models_as_built():
    """Phase 15's single-card training reckonings: ``stored_params``
    equals the parameters of the models as built — jamba's period with
    one MoE layer's experts, the other three sharing them, and kimi-k2's
    one layer — and at published width 16.15 G (96.9 GB at 6 B a
    parameter) and 19.38 G (116.3 GB), past an 80 GB card."""
    from repro_torch.models import api
    jamba = _jamba()
    built = chip_smoke.hybrid_model(jamba, 7, 1, torch.float32, "cpu")
    assert sum(p.numel() for p in built.parameters()) == sum(
        chip_smoke.stored_params(jamba, 1))
    kimi = _kimi(n_layers=1)
    built = api.init_params(kimi, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    assert sum(p.numel() for p in built.parameters()) == sum(
        chip_smoke.stored_params(kimi, 1)) == chip_smoke.moe_train_params(
        kimi)
    lines = chip_smoke.int8_train_reckonings(80 * 10 ** 9)
    assert lines[0].startswith(
        "train jamba-1.5-large-398b on one card with the int8 optimizer "
        "state: not run; one period (8 layers) with one MoE layer's "
        "experts, the other 3 sharing them is 16,153,514,240 params")
    assert "6 B a param (bf16 param and gradient, int8 m and v) 96.9 GB" \
        in lines[0]
    assert "kimi-k2-1t-a32b" in lines[1] and "19,378,623,488 params" in \
        lines[1] and "116.3 GB" in lines[1]
    assert all(line.endswith("more than the card's 80.0 GB")
               for line in lines)
    assert "within the card's 200.0 GB" in \
        chip_smoke.int8_train_reckonings(200 * 10 ** 9)[0]


# ---------------------------------------------------------------------------
# Phase 15 (c): serving on the world-1 mesh


@pytest.fixture
def world_1_mesh(tmp_path):
    """A (data 1, model 1) mesh over one gloo process, as phase 15 (c)'s
    mesh on one card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield make_test_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", chip_smoke.MESH_SERVE)
def test_phase_15_mesh_serving_on_the_cpu(world_1_mesh, arch):
    """Phase 15 (c)'s serving rehearsed on the CPU at reduced size (one
    gloo process): the mesh's prefill and every decode step's logits
    bit-equal to the plain path's on the same weights (at world 1 each
    local shard is the whole tensor), no kernel launched on either
    (the CPU runs the plain versions), so only the launch rule fails."""
    cfg = _reduced(arch)
    dev = torch.device("cpu")
    r = chip_smoke.mesh_serve(chip_smoke.mesh_serve_model(cfg, 7, None, dev),
                              cfg, world_1_mesh, dev, seed=7, batch=2,
                              prompt=16, decode=3, cut="reduced")
    assert r["bit_equal"] == [True] * 4 and r["max_abs_diff"] == 0.0
    assert r["finite"] and r["mesh"] == {"data": 1, "model": 1}
    assert chip_smoke.mesh_serve_failures(r) == [
        f"a mesh prefill launched {{}}, want {r['want']}"]
    line = chip_smoke.mesh_serve_line(r, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "bit-equal to the plain path's at 4 of 4 calls" in line
    assert "700.00 W" in line


def test_mesh_and_plain_share_storage_and_shared_experts(world_1_mesh):
    """``mesh_and_plain`` on jamba's period with its MoE layers past the
    first sharing its experts: every parameter a DTensor at its rule's
    placement, the plain model's tensors the mesh model's local ones
    (one storage), and the shared experts still one Parameter."""
    from repro_torch.sharding import named_shardings
    cfg = _reduced(chip_smoke.HYBRID_ARCH)
    model = chip_smoke.hybrid_model(cfg, 7, 1, torch.float32, "cpu")
    want = {n: s.placements
            for n, s in named_shardings(model, world_1_mesh).items()}
    stored = sum(p.numel() for p in model.parameters())
    meshed, plain = chip_smoke.mesh_and_plain(model, world_1_mesh)
    assert meshed is model
    got = dict(meshed.named_parameters())
    assert {n: tuple(p.placements) for n, p in got.items()} == want
    assert sum(p.numel() for p in meshed.parameters()) == stored
    for (n, p), (m, q) in zip(meshed.named_parameters(),
                              plain.named_parameters()):
        assert n == m and not hasattr(q, "placements")
        assert q.data_ptr() == p.to_local().data_ptr()
    shares = chip_smoke.expert_sharing(plain)["shares"]
    assert shares and shares == chip_smoke.expert_sharing(meshed)["shares"]


def test_mesh_serve_config_reckons_each_model():
    """On an H100's free memory mixtral would be cut as phase 13 cuts
    it, and is cut further, as smollm, mamba2 and internvl2 are, to
    MESH_SERVE_LAYERS for the script's time (the cut and the memory's
    reckoning printed); whisper is served at published size; jamba keeps phase 16's experts; on too little, jamba is
    skipped with its reckoning."""
    for arch in ("smollm-360m", "mamba2-130m", "internvl2-1b"):
        cfg, cut, distinct = chip_smoke.mesh_serve_config(arch, 0, "cpu")
        n = chip_smoke.MESH_SERVE_LAYERS[arch]
        assert cfg.n_layers == n < chip_smoke.lm_config(arch, 0).n_layers
        assert distinct is None and "cut for the script's time" in cut
    assert chip_smoke.mesh_serve_config("smollm-360m", 4, "cpu")[:2] == (
        chip_smoke.lm_config("smollm-360m", 4), "4 layers")
    cfg, cut, _ = chip_smoke.mesh_serve_config("whisper-small", 0, "cpu")
    assert cfg == chip_smoke.lm_config("whisper-small", 0)
    cfg, cut, distinct = chip_smoke.mesh_serve_config(
        chip_smoke.MOE_ARCH, 0, "cpu")
    n = chip_smoke.MESH_SERVE_LAYERS[chip_smoke.MOE_ARCH]
    assert cfg.n_layers == n < chip_smoke.MOE_LAYERS and distinct is None
    assert cut.startswith(f"{n} of 32 layers, cut for the script's time")
    assert f"the card holds {chip_smoke.MOE_LAYERS} of 32 layers" in cut
    cfg, cut, distinct = chip_smoke.mesh_serve_config(
        chip_smoke.HYBRID_ARCH, 0, "cpu")
    assert cfg.n_layers == 8 and distinct >= chip_smoke.HYBRID_MIN_DISTINCT
    assert "MoE layers with experts of their own" in cut


def _serve_passing():
    run = dict(prefill_launches={"flash_attention": 2, "ssd_scan": 0},
               decode_launches={"flash_attention": 0, "ssd_scan": 0},
               prefill_s=1.0, prefill_cold_s=1.5, decode_ms_per_step=10.0)
    return dict(bit_equal=[True] * 3, max_abs_diff=0.0, finite=True,
                want={"flash_attention": 2, "ssd_scan": 0},
                mesh_run=dict(run), plain=dict(run))


@pytest.mark.parametrize("change,message", [
    (dict(bit_equal=[True, False, True], max_abs_diff=0.5),
     "differ from the plain path's at [1] of 3"),
    (dict(finite=False), "non-finite"),
    (dict(plain=dict(_serve_passing()["plain"],
                     prefill_launches={"flash_attention": 1})),
     "the plain path's {'flash_attention': 1}"),
    (dict(want={"flash_attention": 3}), "want {'flash_attention': 3}"),
    (dict(mesh_run=dict(_serve_passing()["mesh_run"],
                        decode_launches={"flash_attention": 1})),
     "decode launched")])
def test_mesh_serve_verdict_names_each_failed_check(change, message):
    assert chip_smoke.mesh_serve_failures(_serve_passing()) == []
    bad = chip_smoke.mesh_serve_failures(dict(_serve_passing(), **change))
    assert any(message in b for b in bad), bad
    assert all(b.startswith("serving x: ") for b in chip_smoke.mesh_failures(
        dict(_mesh_passing(), serve={"x": dict(_serve_passing(),
                                                **change)})))


def test_phase_15_training_depth_cuts():
    """Phase 15 (a)'s depth cuts: whisper-small's two stacks and
    internvl2-1b at FAMILY_TRAIN_LAYERS, published width kept; mixtral
    at most MOE_TRAIN_MAX_LAYERS on an H100's free memory (where
    ``moe_train_depth`` reckons 2), ``--lm-layers`` still overriding;
    (b)'s checks at 1 step."""
    for arch, n in chip_smoke.FAMILY_TRAIN_LAYERS.items():
        cfg = chip_smoke.family_check_config(arch, n)
        full = chip_smoke.lm_config(arch, 0)
        assert cfg.n_layers == n < full.n_layers
        assert cfg.d_model == full.d_model and cfg.vocab == full.vocab
        if cfg.family == "encdec":
            assert cfg.n_enc_layers == n
    assert chip_smoke.FAMILY_CHECK_STEPS == {
        "whisper-small": 1, "internvl2-1b": 1, chip_smoke.MOE_ARCH: 1}
    assert set(chip_smoke.FAMILY_CHECK_STEPS) == set(
        chip_smoke.FAMILY_CHECK_LAYERS)
    free = int(79.1 * 2 ** 30)
    assert chip_smoke.moe_train_depth(chip_smoke.lm_config(
        chip_smoke.MOE_ARCH, 0), free)[0] == 2
    n, cut = chip_smoke.moe_train_cut(free, 0)
    assert n == chip_smoke.MOE_TRAIN_MAX_LAYERS == 1
    assert "cut for the script's time" in cut and "2 of 32 layers" in cut
    assert chip_smoke.moe_train_cut(free, 3)[0] == 3
    cfg, cut = chip_smoke.mesh_model_config(chip_smoke.MOE_ARCH, 0, "cpu")
    assert cfg.n_layers == chip_smoke.MOE_TRAIN_MAX_LAYERS
    # (c) trains whisper and internvl2 at (a)'s depths, mamba2 at 12 of
    # 24; (b) checks whisper and internvl2 at 1 layer; 11 (c) at 2
    for arch, n in chip_smoke.MESH_TRAIN_LAYERS.items():
        cfg, cut = chip_smoke.mesh_model_config(arch, 0, "cpu")
        assert cfg == chip_smoke.family_check_config(arch, n)
        assert cut.startswith(f"{n} of ") and "script's time" in cut
        assert chip_smoke.mesh_model_config(arch, 4, "cpu")[0].n_layers == 4
    assert chip_smoke.MESH_TRAIN_LAYERS == {
        "mamba2-130m": 12, "whisper-small": 6, "internvl2-1b": 12}
    assert chip_smoke.FAMILY_CHECK_LAYERS == {
        "whisper-small": 1, "internvl2-1b": 1, chip_smoke.MOE_ARCH: 1}
    assert chip_smoke.RECOVERY_LAYERS == 2


def test_phase_15_int8_step_on_the_cpu(world_1_mesh):
    """Phase 15 (c)'s int8 step rehearsed on the CPU at reduced size
    (one gloo process, bf16 params, the int8 optimizer state): the mesh
    and plain states after one step bit-equal — every ``q``, ``scale``
    and parameter — each ``q`` at its parameter's placement; no kernel
    launched (the CPU runs the plain versions), so only the launch rule
    fails.  The mesh step is timed twice (cold, warm) from one state."""
    from repro_torch.config import reduced
    cfg = reduced(chip_smoke.lm_config("smollm-360m", 0))
    r = chip_smoke.int8_mesh_step(cfg, world_1_mesh, torch.device("cpu"),
                                  batch=2, seq=32)
    assert r["differing"] == [] and r["q_arrays"] > 0 and r["q_placed"]
    assert r["peak_bytes"] is None
    assert r["first_step_s"] > 0 and r["step_s"] > 0
    assert chip_smoke.int8_failures(r) == [
        f"the int8 {what} step launched {{}}, want "
        f"{{'flash_attention': {r['per_step']}}}"
        for what in ("mesh", "plain")]
    line = chip_smoke.int8_line(r, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "bit-equal True" in line and "peak not measured" in line
    assert " s cold, " in line and " s warm " in line


def test_phase_17_dryrun_on_the_cpu(tmp_path):
    """Phase 17 rehearsed on the CPU: the child (this script's
    ``dryrun_child``, a process of its own on the fake process group)
    traces a reduced int8 cell on fake CPU tensors (a train cell on fake
    CUDA tensors needs a CUDA build) and prints its result last; the
    verdict and the line read it beside a measured step, and a ratio
    outside the bound fails."""
    import subprocess
    import sys
    code = ("import sys, chip_smoke; from repro_torch.config import reduced;"
            "sys.exit(chip_smoke.dryrun_child(0, device='cpu', "
            "cfg=reduced(chip_smoke.lm_config('smollm-360m', 0)), batch=2, "
            "seq=32))")
    log = tmp_path / "child.txt"
    with open(log, "w") as f:
        child = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                 stderr=subprocess.STDOUT,
                                 cwd=chip_smoke.ROOT,
                                 env=dict(os.environ, OMP_NUM_THREADS="1",
                                          PYTHONPATH=os.path.join(
                                              chip_smoke.ROOT, "src")))
    int8 = {"peak_bytes": None, "step_s": 0.5}
    f = open(log, "a")
    child.wait(timeout=300)
    with open(log) as g:
        trace = json.loads(g.read().strip().splitlines()[-1])
    peak = trace["memory_analysis"]["peak_bytes"]
    assert trace["opt_state_dtype"] == "int8" and trace["mesh"] == "1x1"
    assert trace["flops_per_device"] > 0 and peak > 0
    int8["peak_bytes"], int8["started"] = peak * 0.8, trace["ended"] + 2.0
    r = chip_smoke.phase_dryrun(child, f, str(log), int8)
    assert r["rc"] == 0 and r["ratio"] == pytest.approx(1.25)
    assert r["ended_before_s"] == pytest.approx(2.0)
    assert chip_smoke.dryrun_failures(r) == []
    assert r["tflops"] == trace["flops_per_device"] / 0.5 / 1e12
    line = chip_smoke.dryrun_line(r, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert "ratio 1.2500" in line and "700.00 W" in line
    assert "masked scores included" in line and "ended 2.0 s before" in line
    r["ratio"] = 2.5
    assert "outside [0.5, 2.0]" in chip_smoke.dryrun_failures(r)[0]
