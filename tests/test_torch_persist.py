"""The port's durability layer (``repro_torch.persist``) against
``repro.persist``: the same op stream with the same flush points gives
the same bytes in both packages — every WAL record, the manifest and
every segment block — and a root written by either opens in the other
with equal answers.  Checkpoint/recovery roundtrips (segmented and
monolithic roots, both layouts), WAL rotation, the config guards, the
segment CRC, recovery of the exact prefix at every WAL cut, the
reference's offline checker on a port root, and the reference's eight
kill -9 cases against a port child.

The crash child is this file run as a script::

    python tests/test_torch_persist.py ROOT LAYOUT KILL_SPEC NTH

It imports only ``repro_torch`` (never ``repro`` or ``jax``), streams
``persist_harness``'s history one time unit per ``ingest`` into a
durable CPU session, and SIGKILLs itself where KILL_SPEC says (see
``tests/persist_harness.py`` for the specs), logging acknowledged
progress to ``ROOT/acks.log``.
"""
import os
import signal
import subprocess
import sys

import numpy as np

# the harness's constants and stream, from the port's generator: the
# child never imports the harness (which generates with ``repro``)
from torch_harness import N_CAP, N_NODES, SEED, SEGMENT_MIN_OPS, SWAP_EVERY
from torch_harness import grid as _grid
from torch_harness import proposal_units

COLS = ("op", "u", "v", "slot", "t")


# ---------------------------------------------------------------------------
# The crash child (imports only repro_torch)
# ---------------------------------------------------------------------------


def _kill():
    os.kill(os.getpid(), signal.SIGKILL)


def _hook(orig, before: bool, state: dict, nth: int):
    def wrapped(*args, **kw):
        state["n"] += 1
        if before and state["n"] == nth:
            _kill()
        out = orig(*args, **kw)
        if not before and state["n"] == nth:
            _kill()
        return out
    return wrapped


def install_kill(persist, spec: str, nth: int) -> None:
    """``persist_harness.install_kill`` on the port's modules."""
    state = {"n": 0}
    if spec == "append_wal_pre":
        persist.log_pending = _hook(persist.log_pending, True, state, nth)
    elif spec == "append_wal_post":
        persist.log_pending = _hook(persist.log_pending, False, state, nth)
    elif spec == "drain_logged":
        persist.log_drain = _hook(persist.log_drain, False, state, nth)
    elif spec == "mid_checkpoint":
        from repro_torch.persist import manifest as mf
        mf.write_manifest = _hook(mf.write_manifest, True, state, nth)
    elif spec == "post_checkpoint":
        persist.checkpoint = _hook(persist.checkpoint, False, state, nth)
    elif spec == "seal_logged":
        # class-level: persist.wal is replaced at every rotation
        from repro_torch.persist.wal import WriteAheadLog
        WriteAheadLog.log_seal = _hook(WriteAheadLog.log_seal, False,
                                       state, nth)
    else:
        raise SystemExit(f"unknown kill spec {spec!r}")


def child(argv) -> int:
    """Stream the history into a durable port session at ROOT and die
    at the kill point (exit 3 if it never fires)."""
    root, layout, spec, nth = argv[0], argv[1], argv[2], int(argv[3])
    from repro_torch.api import GraphSession
    session = GraphSession.open(root, n_cap=N_CAP, layout=layout,
                                segment_min_ops=SEGMENT_MIN_OPS,
                                device="cpu")
    install_kill(session.store.persist, spec, nth)
    with open(os.path.join(root, "acks.log"), "a") as acks:
        def ack(line: str) -> None:
            acks.write(line + "\n")
            acks.flush()
            os.fsync(acks.fileno())

        for i, unit in enumerate(proposal_units()):
            session.ingest(unit)
            ack(f"unit {i} {unit[-1][3]}")
            if (i + 1) % SWAP_EVERY == 0:
                session.flush()
                ack(f"swap {session.watermark}")
    return 3


if __name__ == "__main__":
    sys.exit(child(sys.argv[1:]))


# ---------------------------------------------------------------------------
# The tests (import both packages)
# ---------------------------------------------------------------------------

import filecmp  # noqa: E402
import shutil  # noqa: E402

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import persist_harness as harness  # noqa: E402
from repro import persist as jpersist  # noqa: E402
from repro.api import GraphSession as JSession  # noqa: E402
from repro.core.plans import Query as JQuery  # noqa: E402
from repro.core.store import Op as JOp  # noqa: E402
from repro.core.store import TemporalGraphStore as JStore  # noqa: E402
from repro.persist import manifest as jmf  # noqa: E402
from repro.persist import recovery as jrec  # noqa: E402
from repro.persist import wal as jwal  # noqa: E402
from repro_torch import persist as tpersist  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.core.delta import ADD_EDGE, ADD_NODE  # noqa: E402
from repro_torch.core.plans import Query  # noqa: E402
from repro_torch.core.store import Op, TemporalGraphStore  # noqa: E402
from repro_torch.persist import manifest as tmf  # noqa: E402
from repro_torch.persist import recovery as trec  # noqa: E402
from repro_torch.persist import wal as twal  # noqa: E402
from test_persist import KILL_CASES  # noqa: E402
from test_torch_reconstruct import eq  # noqa: E402

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
FSCK = os.path.join(ROOT, "scripts", "fsck_graph.py")
CHILD_TIMEOUT_S = 300


def _child_env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


_ORACLES: dict = {}


def _oracle(layout: str) -> JStore:
    """``repro``'s from-scratch store over the whole proposal stream
    (built once per layout)."""
    if layout not in _ORACLES:
        ops = [o for unit in harness.proposal_units() for o in unit]
        s = JStore(n_cap=N_CAP, layout=layout)
        s.ingest(ops)
        s.advance_to(max(o.t for o in ops))
        _ORACLES[layout] = s
    return _ORACLES[layout]


def _matches_oracle(store, layout: str, t_lo: int, t_hi: int, ctx=""):
    """A port store's answers on ``_grid(t_lo, t_hi)`` equal the
    reference oracle's, bit for bit."""
    specs = _grid(t_lo, t_hi)
    got = store.evaluate_many([Query(**s) for s in specs])
    want = _oracle(layout).evaluate_many([JQuery(**s) for s in specs])
    for s, g, w in zip(specs, got, want):
        try:
            eq(w, g)
        except AssertionError as exc:
            raise AssertionError(f"{ctx} {s}: {g!r} vs {w!r}") from exc


def _tree(root: str) -> dict[str, str]:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def _assert_same_files(a: str, b: str) -> None:
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        assert filecmp.cmp(ta[rel], tb[rel], shallow=False), rel


def _stream_session(session, units) -> None:
    for i, unit in enumerate(units):
        session.ingest(unit)
        if (i + 1) % SWAP_EVERY == 0:
            session.flush()
    session.close()


def _same_current(jstore, tstore) -> None:
    if tstore.layout == "edge":
        j, t = jstore.current_edge_snapshot(), tstore.current_edge_snapshot()
        eq(j.emask, t.emask.cpu())
    else:
        j, t = jstore.current, tstore.current
        eq(j.adj, t.adj.cpu())
    eq(j.nodes, t.nodes.cpu())


def test_stream_matches_harness():
    """The child's stream and constants are the harness's, op for op."""
    assert (N_CAP, N_NODES, SEED, SWAP_EVERY, SEGMENT_MIN_OPS) == (
        harness.N_CAP, harness.N_NODES, harness.SEED, harness.SWAP_EVERY,
        harness.SEGMENT_MIN_OPS)
    assert proposal_units() == [[(o.op, o.u, o.v, o.t) for o in unit]
                                for unit in harness.proposal_units()]


# ---------------------------------------------------------------------------
# Codecs: equal bytes, each decodes the other's
# ---------------------------------------------------------------------------


def _records(mods) -> list[bytes]:
    wal, op = mods
    ops = [op(ADD_NODE, 0, 0, 1), op(ADD_NODE, 1, 1, 1),
           op(ADD_EDGE, 0, 1, 2)]
    cols = {c: np.arange(4, dtype=np.int32) + k for k, c in enumerate(COLS)}
    return [wal.encode_ops(wal.REC_OPS, ops),
            wal.encode_ops(wal.REC_PENDING, ops[:1]),
            wal.encode_advance(7), wal.encode_seal(5, 12, True),
            wal.encode_drain(3, 9), wal.encode_tail(9, 2, 5, cols),
            wal.encode_ops(wal.REC_OPS, [])]


def _decoded_equal(a, b) -> None:
    assert a[0] == b[0]
    fa, fb = a[1], b[1]
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if k == "cols":
            for c in COLS:
                np.testing.assert_array_equal(fa[k][c], fb[k][c])
        else:
            np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("i", range(7), ids=["ops", "pending", "advance",
                                             "seal", "drain", "tail",
                                             "empty_ops"])
def test_wal_record_bytes_equal_and_cross_decode(i):
    jb, tb = _records((jwal, JOp))[i], _records((twal, Op))[i]
    assert jb == tb
    _decoded_equal(jwal.decode(tb), twal.decode(jb))


def test_wal_files_equal_and_cross_read(tmp_path):
    """Whole logs (magic, frames, CRCs) written record by record through
    each package's ``WriteAheadLog`` are equal, and each package reads
    the other's."""
    paths = {}
    for name, wal, op in (("j", jwal, JOp), ("t", twal, Op)):
        paths[name] = str(tmp_path / f"{name}.log")
        log = wal.WriteAheadLog(paths[name])
        for payload in _records((wal, op)):
            log.append(payload)
        log.close()
    assert filecmp.cmp(paths["j"], paths["t"], shallow=False)
    for a, b in zip(jwal.read_records(paths["t"]),
                    twal.read_records(paths["j"])):
        _decoded_equal(a, b)


def test_manifest_and_segment_files_equal(tmp_path):
    man = {"config": {"n_cap": 48, "e_cap": 384, "layout": "dense",
                      "segmented": True, "segment_min_ops": 8,
                      "enforce_invertible": True},
           "t_sealed": 9, "anchors": [3], "wal_seq": 4,
           "segments": [{"file": jmf.segment_name(0), "n_ops": 5,
                         "t_min": 1, "t_max": 9, "crc32": 17}]}
    cols = {c: np.arange(5, dtype=np.int32) * (k + 1)
            for k, c in enumerate(COLS)}
    crcs = {}
    for name, mf in (("j", jmf), ("t", tmf)):
        root = str(tmp_path / name)
        os.makedirs(os.path.join(root, mf.SEGMENT_DIR))
        mf.write_manifest(root, man)
        crcs[name] = mf.save_segment_file(
            os.path.join(root, mf.segment_name(0)), cols)
    _assert_same_files(str(tmp_path / "j"), str(tmp_path / "t"))
    assert crcs["j"] == crcs["t"]
    assert tmf.read_manifest(str(tmp_path / "j")) == jmf.read_manifest(
        str(tmp_path / "t"))
    seg = os.path.join(str(tmp_path / "j"), tmf.segment_name(0))
    got = tmf.load_segment_file(seg, expected_crc=crcs["j"])
    for c in COLS:
        np.testing.assert_array_equal(got[c], cols[c])


# ---------------------------------------------------------------------------
# Whole roots: byte identity and opening each other's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_roots_equal_file_by_file_and_open_across(tmp_path, layout):
    units = proposal_units()
    j_root, t_root = str(tmp_path / "jax"), str(tmp_path / "port")
    _stream_session(JSession.open(j_root, n_cap=N_CAP, layout=layout,
                                  segment_min_ops=SEGMENT_MIN_OPS), units)
    _stream_session(GraphSession.open(t_root, n_cap=N_CAP, layout=layout,
                                      segment_min_ops=SEGMENT_MIN_OPS,
                                      device="cpu"), units)
    assert len(jmf.read_manifest(j_root)["segments"]) >= 2
    _assert_same_files(j_root, t_root)

    # the port opens the reference's root; the reference opens the port's
    # (the units after the last flush come back as the pending buffer)
    t_rec = tpersist.open_store(j_root, device="cpu")
    j_rec = jpersist.open_store(t_root)
    t_store, j_store = t_rec.store, j_rec.store
    assert t_store.t_cur == j_store.t_cur > 1
    assert t_rec.pending and [tuple(vars(o).values()) for o in t_rec.pending
                              ] == [tuple(vars(o).values())
                                    for o in j_rec.pending]
    _same_current(j_store, t_store)
    specs = _grid(1, t_store.t_cur)
    got = t_store.evaluate_many([Query(**s) for s in specs])
    want = j_store.evaluate_many([JQuery(**s) for s in specs])
    for g, w in zip(got, want):
        eq(w, g)
    _matches_oracle(t_store, layout, 1, t_store.t_cur)


def _monolithic_root(store_cls, rec, wal, mf, root, layout, **kw):
    """A durable root over a ``segmented=False`` store, attached as
    ``open_store`` attaches a fresh one (``open_store`` itself always
    creates segmented roots)."""
    store = store_cls(N_CAP, layout=layout, segmented=False, **kw)
    persist = rec.StorePersistence(root)
    persist.wal = wal.WriteAheadLog(persist._wal_path(1), repair=False)
    persist.wal.append(wal.encode_tail(0, 0, 0, store._tail_host()))
    mf.write_manifest(root, persist._manifest_dict(store, 1))
    store.persist = persist
    return store


@pytest.mark.parametrize("layout,segmented", [("dense", True),
                                              ("edge", True),
                                              ("dense", False)],
                         ids=["dense", "edge", "dense-monolithic"])
def test_flush_close_reopen_bitexact(tmp_path, layout, segmented):
    """Stream, seal, close, reopen: the recovered store answers like the
    reference's from-scratch store and like itself before the close.  A
    ``segmented=False`` root is written by both packages (equal files)
    and recovers into a monolithic store."""
    root = str(tmp_path / "g")
    if segmented:
        store = tpersist.open_store(root, n_cap=N_CAP, layout=layout,
                                    segment_min_ops=SEGMENT_MIN_OPS,
                                    device="cpu").store
    else:
        store = _monolithic_root(TemporalGraphStore, trec, twal, tmf, root,
                                 layout, device="cpu")
        jstore = _monolithic_root(JStore, jrec, jwal, jmf,
                                  str(tmp_path / "jax"), layout)
    units = proposal_units()
    for i, unit in enumerate(units):
        for s in (store,) if segmented else (store, jstore):
            s.ingest(unit)
            s.advance_to(unit[-1][3])
            if i == len(units) // 2:
                s.seal_tail(s.t_cur)     # a no-op on a monolithic log
    store.seal_tail(store.t_cur)
    store.close()
    if not segmented:
        jstore.close()
        _assert_same_files(str(tmp_path / "jax"), root)

    rec = tpersist.open_store(root, device="cpu")
    assert rec.pending == []
    got = rec.store
    assert got.t_cur == store.t_cur
    assert got.segmented is segmented
    assert len(got._segments) == len(store._segments)
    if segmented:
        assert len(got._segments) >= 2
        # sealed history comes back mmap-backed, and the device copy
        # never shares the mapping
        assert any(isinstance(np.asarray(s.op).base, np.memmap)
                   for s in got._segments)
        seg = got._segments[0]
        assert not np.shares_memory(seg.delta.op.numpy(), seg.op)
    _same_current(_oracle(layout), got)
    _matches_oracle(got, layout, 1, got.t_cur, ctx=layout)
    specs = _grid(1, got.t_cur)
    for a, b in zip(got.evaluate_many([Query(**s) for s in specs]),
                    store.evaluate_many([Query(**s) for s in specs])):
        eq(a, b)
    got.close()
    # the root serves a session too (a monolithic one freezes its whole
    # log at every swap)
    with GraphSession.open(root, device="cpu") as s:
        assert s.store.segmented is segmented
        _matches_oracle(s.store, layout, 1, s.t_cur, ctx="session")


def test_reopen_without_close_replays_wal(tmp_path):
    """No checkpoint at all — the fsync'd WAL alone rebuilds."""
    root = str(tmp_path / "g")
    units = proposal_units()
    store = tpersist.open_store(root, n_cap=N_CAP, segment_min_ops=8,
                                device="cpu").store
    for unit in units[:6]:
        store.ingest(unit)
        store.advance_to(unit[-1][3])
    store.seal_tail(store.t_cur)         # sealed segment + open tail
    for unit in units[6:8]:
        store.ingest(unit)
        store.advance_to(unit[-1][3])
    # ... process dies here (no flush/close)
    got = tpersist.open_store(root, verify=True, device="cpu").store
    assert got.t_cur == store.t_cur
    _matches_oracle(got, "dense", 1, got.t_cur)


def test_checkpoint_rotates_wal(tmp_path):
    root = str(tmp_path / "g")
    store = tpersist.open_store(root, n_cap=16, device="cpu").store
    store.ingest([Op(ADD_NODE, 0, 0, 1), Op(ADD_NODE, 1, 1, 2)])
    store.advance_to(2)
    assert tmf.read_manifest(root)["wal_seq"] == 1
    store.flush()
    m = tmf.read_manifest(root)
    assert m["wal_seq"] == 2
    assert not os.path.exists(os.path.join(root, tmf.wal_name(1)))
    # the rotated WAL holds nothing but the base record
    recs = list(twal.read_records(os.path.join(root, tmf.wal_name(2))))
    assert [r[0] for r in recs] == [twal.REC_TAIL]
    assert recs[0][1]["t_cur"] == 2


def test_open_config_guards(tmp_path):
    root = str(tmp_path / "g")
    with pytest.raises(ValueError, match="no manifest"):
        tpersist.open_store(root, device="cpu")
    with pytest.raises(ValueError, match="no manifest"):
        tpersist.open_store(root, n_cap=16, readonly=True, device="cpu")
    assert not os.path.exists(root)      # a readonly open creates nothing
    store = tpersist.open_store(root, n_cap=16, layout="dense",
                                device="cpu").store
    store.close()
    with pytest.raises(ValueError, match="n_cap"):
        tpersist.open_store(root, n_cap=32, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        tpersist.open_store(root, layout="edge", device="cpu")
    assert tpersist.open_store(root, n_cap=16,
                               device="cpu").store.n_cap == 16


def test_segment_bitflip_raises(tmp_path):
    """One flipped byte in a sealed segment's data is caught by the
    manifest's CRC32 stamp on the default (mmap) read path."""
    root = str(tmp_path / "g")
    store = tpersist.open_store(root, n_cap=16, segment_min_ops=1,
                                device="cpu").store
    store.ingest([Op(ADD_NODE, i, i, i + 1) for i in range(6)])
    store.advance_to(6)
    store.seal_tail(6)
    store.close()
    entry = tmf.read_manifest(root)["segments"][0]
    seg_file = os.path.join(root, entry["file"])
    assert tmf.segment_file_crc(seg_file) == entry["crc32"]
    size = os.path.getsize(seg_file)
    with open(seg_file, "r+b") as fh:
        fh.seek(size - 3)
        b = fh.read(1)
        fh.seek(size - 3)
        fh.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(tpersist.SegmentCorruptError, match="crc32 mismatch"):
        tpersist.open_store(root, device="cpu")
    with pytest.raises(tpersist.SegmentCorruptError):
        tpersist.open_store(root, readonly=True, device="cpu")


def test_verify_cross_checks_the_manifest_entries(tmp_path):
    """``verify=True`` holds each segment's (n_ops, t_min, t_max) to its
    manifest entry, as the reference does; an entry that disagrees with
    an intact file (its CRC stamp still right) passes the default open
    and fails the verified one, in both packages."""
    root = str(tmp_path / "g")
    store = tpersist.open_store(root, n_cap=16, segment_min_ops=1,
                                device="cpu").store
    store.ingest([Op(ADD_NODE, i, i, i + 1) for i in range(6)])
    store.advance_to(6)
    store.seal_tail(6)
    store.close()
    tpersist.open_store(root, verify=True, device="cpu").store.close()
    man = tmf.read_manifest(root)
    man["segments"][0]["t_max"] += 1
    tmf.write_manifest(root, {k: v for k, v in man.items()
                              if k != "version"})
    tpersist.open_store(root, readonly=True, device="cpu")
    for open_verified in (
            lambda: tpersist.open_store(root, verify=True, readonly=True,
                                        device="cpu"),
            lambda: jpersist.open_store(root, verify=True, readonly=True)):
        with pytest.raises(ValueError, match="does not match its manifest"):
            open_verified()


def _snapshot_files(root: str) -> dict[str, bytes]:
    return {rel: open(p, "rb").read() for rel, p in _tree(root).items()}


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_readonly_open_leaves_the_root_byte_identical(tmp_path, layout):
    """A readonly open of a live root — sealed segments, a rotated WAL
    with records past its base and a torn frame at its end — recovers
    the WAL's intact prefix (the reference oracle's answers) with no
    persistence attached, and leaves every file as it was: the torn
    tail is not truncated, no stray file is swept, nothing is added."""
    root = str(tmp_path / "g")
    units = proposal_units()
    store = tpersist.open_store(root, n_cap=N_CAP, layout=layout,
                                segment_min_ops=SEGMENT_MIN_OPS,
                                device="cpu").store
    for unit in units[:6]:
        store.ingest(unit)
        store.advance_to(unit[-1][3])
    store.flush()
    for unit in units[6:9]:
        store.ingest(unit)
        store.advance_to(unit[-1][3])
    wal_path = os.path.join(root, tmf.wal_name(
        tmf.read_manifest(root)["wal_seq"]))
    with open(wal_path, "ab") as fh:     # half a frame: a torn append
        fh.write(b"\x40\x00\x00\x00\x12\x34")
    stray = os.path.join(root, tmf.wal_name(99))
    with open(stray, "wb") as fh:        # what _clean_stray_wals removes
        fh.write(twal.MAGIC)
    before = _snapshot_files(root)

    rec = tpersist.open_store(root, readonly=True, device="cpu")
    got = rec.store
    assert got.persist is None and rec.pending == []
    assert got.t_cur == store.t_cur
    _matches_oracle(got, layout, 1, got.t_cur, ctx="readonly")
    got.ingest([Op(ADD_NODE, N_CAP - 1, N_CAP - 1, got.t_cur + 1)])
    got.advance_to(got.t_cur + 1)        # mutations log nothing
    got.seal_tail(got.t_cur, force=True)
    assert _snapshot_files(root) == before


def test_recovers_exact_prefix_at_every_wal_cut(tmp_path):
    """Truncate a live root's WAL at every frame boundary and in the
    middle of every frame, and reopen: each cut past the base record
    recovers an exact prefix (the reference oracle's answers at every
    t ≤ its t_cur, never shorter than a shorter cut's); a cut inside
    the base record refuses loudly."""
    root = str(tmp_path / "g")
    units = proposal_units()
    store = tpersist.open_store(root, n_cap=N_CAP, segment_min_ops=8,
                                device="cpu").store
    for unit in units[:5]:
        store.ingest(unit)
        store.advance_to(unit[-1][3])
    store.flush()                        # rotation: WAL = base + suffix
    for unit in units[5:8]:
        store.ingest(unit)
        store.advance_to(unit[-1][3])
    wal_rel = tmf.wal_name(tmf.read_manifest(root)["wal_seq"])
    with open(os.path.join(root, wal_rel), "rb") as fh:
        buf = fh.read()
    spans, off = [], len(twal.MAGIC)
    for _payload, end in twal.iter_frames(buf):
        spans.append((off, end))
        off = end
    assert len(spans) >= 5
    cuts = [len(twal.MAGIC)] + [(s + e) // 2 for s, e in spans]
    cuts += [e for _s, e in spans]
    t_seen = -1
    for cut in sorted(set(cuts)):
        work = str(tmp_path / f"cut_{cut}")
        shutil.copytree(root, work)
        with open(os.path.join(work, wal_rel), "r+b") as fh:
            fh.truncate(cut)
        if cut < spans[0][1]:            # base record torn
            with pytest.raises(RuntimeError, match="torn base"):
                tpersist.open_store(work, device="cpu")
            continue
        got = tpersist.open_store(work, device="cpu").store
        assert t_seen <= got.t_cur <= store.t_cur
        t_seen = got.t_cur
        if got.t_cur >= 1:
            _matches_oracle(got, "dense", 1, got.t_cur, ctx=f"cut={cut}")
        got.close()
    assert t_seen == store.t_cur


def test_fsck_deep_on_port_root(tmp_path):
    """The reference's offline checker (``scripts/fsck_graph.py``)
    finds a port-written root clean, down to a readonly recovery."""
    root = str(tmp_path / "g")
    units = proposal_units()
    store = tpersist.open_store(root, n_cap=N_CAP, segment_min_ops=8,
                                device="cpu").store
    for unit in units[:6]:
        store.ingest(unit)
        store.advance_to(unit[-1][3])
    store.seal_tail(store.t_cur)
    store.flush()
    for unit in units[6:8]:
        store.ingest(unit)
        store.advance_to(unit[-1][3])
    r = subprocess.run([sys.executable, FSCK, root, "--deep"],
                       env=_child_env(), capture_output=True, text=True,
                       timeout=CHILD_TIMEOUT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "deep recovery ok" in r.stdout


# ---------------------------------------------------------------------------
# kill -9 against a port child
# ---------------------------------------------------------------------------


def _check_recovery(root: str, layout: str) -> None:
    """``test_persist._check_recovery`` on the port: the recovered
    watermark covers every served one, answers below it equal the
    reference oracle's, and the WAL'd pending buffer reaches the last
    acknowledged append."""
    acked_units, acked_swaps = [], []
    with open(os.path.join(root, "acks.log")) as fh:
        for line in fh:
            kind, *rest = line.split()
            if kind == "unit":
                acked_units.append(int(rest[1]))
            else:
                acked_swaps.append(int(rest[0]))
    with GraphSession.open(root, device="cpu") as s:
        w = s.watermark
        assert w >= max(acked_swaps, default=0)
        if w >= 1:
            _matches_oracle(s.store, layout, 1, w, ctx="pre")
        s.flush()
        w2 = s.watermark
        assert w2 >= max(acked_units, default=0)
        if w2 > w:
            _matches_oracle(s.store, layout, max(1, w), w2, ctx="post")


@pytest.mark.parametrize("layout,spec,nth", KILL_CASES,
                         ids=[f"{lo}-{sp}" for lo, sp, _ in KILL_CASES])
def test_kill9_recovery_bitexact(tmp_path, layout, spec, nth):
    root = str(tmp_path / "g")
    proc = subprocess.run(
        [sys.executable, HERE, root, layout, spec, str(nth)],
        env=_child_env(), capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == -signal.SIGKILL, \
        (spec, proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:])
    _check_recovery(root, layout)
    # the root stays usable: a fresh session keeps appending
    with GraphSession.open(root, device="cpu") as s:
        t = s.t_cur + 1
        assert s.ingest([Op(ADD_NODE, N_CAP - 1, N_CAP - 1, t)]) == 1
        assert s.query("num_nodes", t=t) >= 1
