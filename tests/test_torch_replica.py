"""The port's replication layer (``repro_torch.replica``) against
``repro.replica``: every case of ``tests/test_replica.py`` on the port —
fault injector, publisher diff, transport, bit-exact incremental sync,
sync under random faults, quarantine, degrade-then-recover, bounded
fetch timeout, restart from the mirror, the hot-anchor budget, the
router's watermark routing, failover and shed, a router over live
replicas, kill -9 of a replica after and mid sync, kill -9 of the
writer and the chaos drill — plus mixed fleets across the two packages
(a port replica of a JAX writer, a JAX replica of a port writer) and a
port and a reference replica under one fault seed.  Every answer is
held bit for bit to the reference's from-scratch oracle.

The kill -9 children are this file run as a script::

    python tests/test_torch_replica.py writer ROOT PUBLISH_ROOT MS_PER_UNIT
    python tests/test_torch_replica.py replica PUBLISH_ROOT LOCAL_ROOT \\
        OUT_JSON KILL_SPEC NTH

They import only ``repro_torch`` (never ``repro`` or ``jax``).  The
writer streams ``torch_harness``'s history into a durable CPU session
that publishes every swap, sleeping MS_PER_UNIT ms a unit (a restart
resumes after the last acknowledged unit), as ``persist_harness``
does with KILL_SPEC ``none``.  The replica is ``replica_harness`` on
the port: it syncs until it holds the publish root's watermark, answers
the grid there and writes answers and stats to OUT_JSON, SIGKILLing
itself where KILL_SPEC says (``after_sync``: right after sync NTH;
``mid_sync``: in sync NTH, after the segment files reach the mirror and
before its manifest rename).
"""
import json
import os
import signal
import sys
import time

from torch_harness import N_CAP, SEGMENT_MIN_OPS, SWAP_EVERY, grid
from torch_harness import proposal_units

# ---------------------------------------------------------------------------
# The kill -9 children (import only repro_torch)
# ---------------------------------------------------------------------------


def _kill():
    os.kill(os.getpid(), signal.SIGKILL)


def writer_child(argv) -> int:
    """Stream the history into a durable port session at ROOT that
    publishes to PUBLISH_ROOT; a reopened root skips the units it
    already holds."""
    root, publish_root, ms_per_unit = argv[0], argv[1], int(argv[2])
    from repro_torch.api import GraphSession
    session = GraphSession.open(root, n_cap=N_CAP,
                                segment_min_ops=SEGMENT_MIN_OPS,
                                device="cpu")
    session.publish_to(publish_root)
    # ingest is batch-atomic: skipping whole units by their closing time
    # resumes the stream exactly
    t_done = session.live._t_append_last
    for i, unit in enumerate(proposal_units()):
        if unit[-1][3] <= t_done:
            continue
        session.ingest(unit)
        if (i + 1) % SWAP_EVERY == 0:
            session.flush()
        time.sleep(ms_per_unit / 1000.0)
    session.flush()
    session.close()
    return 0


def replica_child(argv) -> int:
    """Sync a port replica of PUBLISH_ROOT (mirrored at LOCAL_ROOT) up to
    the published watermark, answer the grid there, write OUT_JSON;
    exit 3 if a kill spec never fired."""
    publish_root, local_root, out_json = argv[0], argv[1], argv[2]
    spec = argv[3] if len(argv) > 3 else "none"
    nth = int(argv[4]) if len(argv) > 4 else 1
    import numpy as np

    from repro_torch.core.plans import Query
    from repro_torch.persist import manifest as mf
    from repro_torch.replica import LocalDirTransport, ReadReplica
    replica = ReadReplica(LocalDirTransport(publish_root), local_root,
                          name="child", seed=5, device="cpu")
    if spec == "mid_sync":
        # fire between the mirrored WAL write and the local manifest
        # rename of the NTH sync: counts manifest writes into the
        # local root only
        orig, state = mf.write_manifest, {"n": 0}

        def hooked(root, manifest):
            if os.path.abspath(root) == os.path.abspath(local_root):
                state["n"] += 1
                if state["n"] == nth:
                    _kill()
            return orig(root, manifest)

        mf.write_manifest = hooked
    target = None
    for _ in range(2000):
        pub = mf.read_manifest(publish_root)
        if pub is not None:
            target = int(pub["t_sealed"])
        try:
            replica.sync()
        except Exception:
            continue
        if spec == "after_sync" and replica.stats.syncs >= nth:
            _kill()
        if target is not None and replica.watermark >= target:
            break
    qs = [Query(**q) for q in grid(1, max(replica.watermark, 1))]
    answers = [[float(x) for x in np.asarray(a).reshape(-1)]
               for a in replica.evaluate_many(qs)]
    payload = {"watermark": replica.watermark, "answers": answers,
               "stats": replica.status()["stats"]}
    tmp = out_json + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, out_json)
    return 0 if spec == "none" else 3


if __name__ == "__main__":
    role = {"writer": writer_child, "replica": replica_child}[sys.argv[1]]
    sys.exit(role(sys.argv[2:]))


# ---------------------------------------------------------------------------
# The tests (import both packages)
# ---------------------------------------------------------------------------

import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import test_persist as jtp  # noqa: E402
from repro import replica as jrep  # noqa: E402
from repro.api import GraphSession as JSession  # noqa: E402
from repro.core.store import Op as JOp  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.core.engine import WatermarkError  # noqa: E402
from repro_torch.core.plans import Query  # noqa: E402
from repro_torch.persist import manifest as tmf  # noqa: E402
from repro_torch.persist import open_store  # noqa: E402
import repro_torch.replica as trep  # noqa: E402
from repro_torch.replica import (FaultInjector, FaultyTransport,  # noqa: E402
                                 InjectedFault, LocalDirTransport,
                                 QueryRouter, ReadReplica, ReplicaDown,
                                 ReplicaSyncError, SegmentPublisher,
                                 TransportError)
from repro_torch.serving import ingest as tingest  # noqa: E402
from repro_torch.serving.frontend import OverloadError  # noqa: E402
from test_torch_persist import _child_env, _matches_oracle  # noqa: E402
from test_torch_persist import _oracle  # noqa: E402

HERE = os.path.abspath(__file__)
CHILD_TIMEOUT_S = 300


def _writer(tmp_path, layout="dense"):
    return GraphSession.open(str(tmp_path / "writer"), n_cap=N_CAP,
                             layout=layout, segment_min_ops=SEGMENT_MIN_OPS,
                             device="cpu")


def _stream_writer(tmp_path):
    """In-process durable port writer + publisher over the fixed
    stream."""
    s = _writer(tmp_path)
    pub = s.publish_to(str(tmp_path / "pub"))
    for i, unit in enumerate(proposal_units()):
        s.ingest(unit)
        if (i + 1) % SWAP_EVERY == 0:
            s.flush()
    s.flush()
    return s, pub


def _replica(transport, root, **kw):
    return ReadReplica(transport, str(root), device="cpu", **kw)


def _check_replica_exact(replica, layout="dense") -> None:
    """Every grid answer at t ≤ the replica's watermark equals the
    reference's from-scratch oracle, bit for bit."""
    w = replica.watermark
    assert w >= 1
    _matches_oracle(replica, layout, 1, w, ctx=f"replica@{w}")


def _q(t):
    return Query("point", "global", "num_edges", t_k=t)


# ---------------------------------------------------------------------------
# fault injector
# ---------------------------------------------------------------------------


def test_fault_injector_schedules():
    inj = FaultInjector(seed=3)
    inj.add("p", "raise", nth=2)
    inj.check("p")                       # 1st: clean
    with pytest.raises(InjectedFault):
        inj.check("p")                   # 2nd: fires
    inj.check("p")                       # one-shot: consumed
    assert inj.fired == [("p", "raise", 2)]

    inj.add("q", "drop", at=(7, 9))
    inj.check("q", value=5)
    with pytest.raises(TransportError):
        inj.check("q", value=7)
    with pytest.raises(TransportError):
        inj.check("q", value=9)
    inj.check("q", value=7)              # each value one-shot

    inj.add("r", "eio", every=3)
    hits = 0
    for _ in range(9):
        try:
            inj.check("r")
        except OSError:
            hits += 1
    assert hits == 3


def test_fault_injector_corruptions_deterministic():
    data = bytes(range(64))
    a = FaultInjector(seed=11)
    a.add("f", "bit_flip", every=1)
    b = FaultInjector(seed=11)
    b.add("f", "bit_flip", every=1)
    flips_a = [a.corrupt("f", data) for _ in range(5)]
    flips_b = [b.corrupt("f", data) for _ in range(5)]
    assert flips_a == flips_b            # seeded: schedules replay
    assert all(f != data and len(f) == len(data) for f in flips_a)

    torn = FaultInjector()
    torn.add("f", "torn", every=1, frac=0.25)
    assert torn.corrupt("f", data) == data[:16]

    slow = FaultInjector()
    slow.add("f", "delay", every=1, delay_s=5.0)
    t0 = time.perf_counter()
    with pytest.raises(TransportError, match="timeout"):
        slow.corrupt("f", data, timeout=0.01)
    assert time.perf_counter() - t0 < 1.0  # slept the timeout, not 5s


def test_fault_schedule_equals_the_reference():
    """One seed, one rule set and one invocation sequence give the same
    fired faults and the same mangled bytes in both packages."""
    def run(mod):
        inj = mod.FaultInjector([mod.FaultRule("fetch", "drop", prob=0.2),
                                 mod.FaultRule("fetch", "torn", prob=0.2,
                                               frac=0.3)], seed=23)
        inj.add("fetch", "bit_flip", prob=0.3)
        inj.add("fetch:seg", "bit_flip", nth=2)
        out = []
        for i in range(200):
            point = "fetch:seg" if i % 7 == 0 else "fetch"
            try:
                out.append(inj.corrupt(point, bytes(range(i % 50 + 1))))
            except mod.TransportError as exc:
                out.append(type(exc).__name__)
        return out, inj.fired

    import repro.replica.faults as jfaults
    from repro_torch.replica import faults as tfaults
    got, want = run(tfaults), run(jfaults)
    assert got == want
    assert len({k for _, k, _ in got[1]}) == 3


# ---------------------------------------------------------------------------
# shipping
# ---------------------------------------------------------------------------


def test_publisher_ships_manifest_diff(tmp_path):
    s, pub = _stream_writer(tmp_path)
    n_segments = len(s.store._segments)
    assert n_segments >= 2
    # each sealed segment crossed the wire exactly once
    assert sum(r.segments_shipped for r in pub.history) == n_segments
    assert pub.publish().segments_shipped == 0   # no change: no re-ship
    # the publish root is itself a valid store root at the watermark
    rec = open_store(str(tmp_path / "pub"), readonly=True, device="cpu")
    assert rec.store.t_cur == s.store.t_cur
    s.close()

    # a restarted writer's publisher resumes the diff, not the history
    pub2 = SegmentPublisher(str(tmp_path / "writer"), str(tmp_path / "pub"))
    assert pub2.publish().segments_shipped == 0


def test_local_transport_missing_file(tmp_path):
    t = LocalDirTransport(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        t.fetch("nope.bin")


# ---------------------------------------------------------------------------
# replica sync under faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_replica_bitexact_and_incremental(tmp_path, layout):
    s = _writer(tmp_path, layout)
    pub = s.publish_to(str(tmp_path / "pub"))
    replica = _replica(pub.transport(), tmp_path / "rep")

    for i, unit in enumerate(proposal_units()):
        s.ingest(unit)
        if (i + 1) % SWAP_EVERY == 0:
            s.flush()
            replica.sync()
            assert replica.watermark == s.watermark
            _check_replica_exact(replica, layout)
    s.flush()
    rec = replica.sync()
    assert rec["mode"] in ("incremental", "rotate")
    _check_replica_exact(replica, layout)
    assert replica.stats.full_rebuilds == 0
    # the replica's current is the writer's, bit for bit
    for name in ("nodes", "adj") if layout == "dense" else ("nodes",):
        assert torch.equal(getattr(replica.store.current, name),
                           getattr(s.store.current, name))
    # steady state: syncing with no writer activity moves nothing
    assert replica.sync()["mode"] == "noop"
    s.close()


def test_replica_sync_under_random_faults(tmp_path):
    """Drops, delays, torn transfers and bit flips on every fetch —
    the sync loop must converge and stay bit-exact regardless."""
    s, pub = _stream_writer(tmp_path)
    inj = FaultInjector(seed=23)
    inj.add("fetch", "drop", prob=0.25)
    inj.add("fetch", "torn", prob=0.2, frac=0.3)
    inj.add("fetch", "bit_flip", prob=0.2)
    replica = _replica(FaultyTransport(pub.transport(), inj),
                       tmp_path / "rep", seed=7, backoff_base=0.001,
                       backoff_max=0.01, max_retries=10)
    for _ in range(20):                  # keep trying through the noise
        try:
            replica.sync()
        except ReplicaSyncError:
            continue
        if replica.watermark >= s.watermark:
            break
    assert replica.watermark == s.watermark
    assert inj.fired                     # the schedule actually bit
    _check_replica_exact(replica)
    s.close()


def test_replica_quarantines_corrupt_segment(tmp_path):
    """A bit-flipped segment payload is caught by CRC verification
    BEFORE touching the mirror, quarantined, and re-fetched clean."""
    s, pub = _stream_writer(tmp_path)
    seg0 = tmf.segment_name(0)            # "segments/seg_000000.npy"
    inj = FaultInjector(seed=1)
    inj.add(f"fetch:{seg0}", "bit_flip", nth=1, offset=200)
    replica = _replica(FaultyTransport(pub.transport(), inj),
                       tmp_path / "rep", seed=2, backoff_base=0.001)
    replica.sync()
    assert replica.stats.quarantined == 1
    qdir = os.path.join(str(tmp_path / "rep"), "quarantine")
    assert len(os.listdir(qdir)) == 1    # the corrupt payload, kept
    assert replica.stats.segments_fetched == len(s.store._segments)
    _check_replica_exact(replica)
    s.close()


def test_replica_degrades_gracefully_then_recovers(tmp_path):
    """Transport down: sync fails after bounded retries, the replica
    keeps serving its old watermark; transport healed: it catches up."""
    s = _writer(tmp_path)
    pub = s.publish_to(str(tmp_path / "pub"))
    units = proposal_units()
    for unit in units[:6]:
        s.ingest(unit)
    s.flush()

    inj = FaultInjector(seed=4)
    replica = _replica(FaultyTransport(pub.transport(), inj),
                       tmp_path / "rep", seed=3, max_retries=3,
                       backoff_base=0.001, backoff_max=0.01)
    replica.sync()
    w_old = replica.watermark
    _check_replica_exact(replica)

    for unit in units[6:]:               # writer moves on
        s.ingest(unit)
    s.flush()
    inj.add("fetch", "drop", every=1)    # then the network dies
    with pytest.raises(ReplicaSyncError):
        replica.sync()
    assert replica.watermark == w_old    # still serving, just stale
    _check_replica_exact(replica)
    assert replica.stats.sync_failures == 1
    assert replica.stats.fetch_retries >= 3   # bounded backoff ran

    inj.clear("fetch")                   # network heals
    replica.sync()
    assert replica.watermark == s.watermark
    _check_replica_exact(replica)
    s.close()


def test_replica_fetch_timeout_is_bounded(tmp_path):
    s, pub = _stream_writer(tmp_path)
    inj = FaultInjector(seed=9)
    inj.add("fetch", "delay", every=1, delay_s=30.0)
    replica = _replica(FaultyTransport(pub.transport(), inj),
                       tmp_path / "rep", fetch_timeout=0.01, max_retries=2,
                       backoff_base=0.001)
    t0 = time.perf_counter()
    with pytest.raises(ReplicaSyncError):
        replica.sync()
    assert time.perf_counter() - t0 < 5.0   # never waits out the 30s
    s.close()


def test_replica_restart_resumes_from_mirror(tmp_path):
    """A replica restarted from its mirror serves immediately (no
    transport) and then rejoins by diff."""
    s, pub = _stream_writer(tmp_path)
    rep_root = tmp_path / "rep"
    r1 = _replica(pub.transport(), rep_root)
    r1.sync()
    w = r1.watermark
    assert r1.stats.segments_fetched >= 2
    del r1

    class _DeadTransport:
        def fetch(self, relpath, *, timeout=None):
            raise TransportError("source down")

    r2 = _replica(_DeadTransport(), rep_root)   # writer unreachable
    assert r2.watermark == w             # serving from the mirror alone
    _check_replica_exact(r2)

    r3 = _replica(pub.transport(), rep_root, name="rejoin")
    assert r3.sync()["mode"] == "noop"    # mirror already current
    assert r3.stats.segments_fetched == 0          # diff-only rejoin
    assert r3.stats.full_rebuilds == 0
    assert r3.watermark == w
    _check_replica_exact(r3)
    s.close()


def test_replica_hot_anchor_budget(tmp_path):
    """anchor_budget_bytes turns on replica-local materialization:
    anchors follow the replica's own traffic, under its own budget."""
    s, pub = _stream_writer(tmp_path)
    from repro_torch.core.engine import _snapshot_bytes
    per = _snapshot_bytes(s.store.current)
    replica = _replica(pub.transport(), tmp_path / "rep",
                       anchor_budget_bytes=2 * per, anchor_min_gap_ops=8)
    replica.sync()
    hot_t = max(2, replica.watermark // 2)
    qs = [Query("point", "global", "num_edges", t_k=hot_t)] * 50
    replica.evaluate_many(qs)            # histogram fills at hot_t
    replica.refresh_anchors()            # rebalance to local traffic
    anchors = list(replica.store.materialized.times)
    assert hot_t in anchors              # the hot time got its anchor
    assert len(anchors) <= 2             # never over local budget
    _check_replica_exact(replica)
    s.close()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


class _StubReplica:
    def __init__(self, name, watermark, answer=1.0):
        self.name = name
        self.watermark = watermark
        self.answer = answer
        self.dead = False
        self.inflight = 0
        self.calls = 0

    def status(self):
        if self.dead:
            raise ConnectionError("dead")
        return {"name": self.name, "watermark": self.watermark,
                "inflight": self.inflight}

    def evaluate_many(self, queries, plan="auto", **kw):
        if self.dead:
            raise ConnectionError("dead")
        self.calls += 1
        return [self.answer] * len(queries)


def test_router_watermark_routing_and_failover():
    fresh = _StubReplica("fresh", watermark=20, answer=2.0)
    stale = _StubReplica("stale", watermark=10, answer=1.0)
    router = QueryRouter(heartbeat_timeout=60.0)
    router.register("fresh", fresh)
    router.register("stale", stale)

    # only the fresh replica covers t=15
    assert router.evaluate_many([_q(15)]) == [2.0]
    assert fresh.calls == 1 and stale.calls == 0
    # nobody covers t=25
    with pytest.raises(WatermarkError):
        router.evaluate_many([_q(25)])
    # fresh dies: routing t=15 to it fails over, but no one else
    # covers — the call surfaces WatermarkError and fresh is marked
    # down for everything after
    fresh.dead = True
    with pytest.raises(WatermarkError):
        router.evaluate_many([_q(15)])
    assert router.failovers == 1
    assert not [r for r in router.replicas()
                if r["name"] == "fresh"][0]["alive"]
    # t<=10 keeps flowing to the stale survivor
    assert router.evaluate_many([_q(9)]) == [1.0]
    # fresh restarts: the next heartbeat readmits it, no re-registration
    fresh.dead = False
    assert router.heartbeat() == {"fresh": True, "stale": True}
    assert router.evaluate_many([_q(15)]) == [2.0]
    # everything dead -> ReplicaDown
    fresh.dead = stale.dead = True
    router.heartbeat()
    with pytest.raises(ReplicaDown):
        router.evaluate_many([_q(5)])


def test_router_watermark_error_is_one_class():
    """The serving layer's ``WatermarkError`` is the engine's, so a
    replica that refuses a batch past its watermark is retried
    elsewhere, never marked dead."""
    assert tingest.WatermarkError is WatermarkError

    class _Regressed(_StubReplica):
        def evaluate_many(self, queries, plan="auto", **kw):
            raise tingest.WatermarkError("behind")

    behind = _Regressed("behind", watermark=20)
    ok = _StubReplica("ok", watermark=20, answer=3.0)
    router = QueryRouter(heartbeat_timeout=60.0)
    router.register("behind", behind)
    router.register("ok", ok)
    assert router.evaluate_many([_q(15)]) == [3.0]
    assert router.failovers == 0
    assert all(r["alive"] for r in router.replicas())


def test_router_sheds_on_overload():
    r = _StubReplica("r", watermark=10)
    router = QueryRouter(max_inflight=2, heartbeat_timeout=60.0)
    router.register("r", r)
    r.inflight = 2                       # saturated (heartbeat view)
    router.heartbeat()
    with pytest.raises(OverloadError):
        router.evaluate_many([_q(5)])
    assert router.shed == 1
    r.inflight = 0
    router.heartbeat()
    assert router.evaluate_many([_q(5)]) == [1.0]


def test_router_over_live_replicas_bitexact(tmp_path):
    """Router + two real replicas at different watermarks: every
    answered query bit-matches the oracle at the ANSWERING replica's
    watermark (the acceptance clause)."""
    s = _writer(tmp_path)
    pub = s.publish_to(str(tmp_path / "pub"))
    units = proposal_units()
    for unit in units[:6]:
        s.ingest(unit)
    s.flush()
    r_stale = _replica(pub.transport(), tmp_path / "r0", name="r0")
    r_stale.sync()
    for unit in units[6:]:
        s.ingest(unit)
    s.flush()
    r_fresh = _replica(pub.transport(), tmp_path / "r1", name="r1")
    r_fresh.sync()
    assert r_stale.watermark < r_fresh.watermark

    router = GraphSession.open_router({"r0": r_stale, "r1": r_fresh})
    oracle = _oracle("dense")
    from repro.core.plans import Query as JQuery
    for t in range(1, r_fresh.watermark + 1):
        got = router.evaluate_many([_q(t)])
        ref = oracle.evaluate_many([JQuery("point", "global", "num_edges",
                                           t_k=t)])
        jtp._assert_bitequal(got, ref, ctx=f"routed t={t}")
    # the stale replica served what it covers (load spreading happened)
    assert r_stale.stats.queries_served > 0
    assert r_fresh.stats.queries_served > 0
    s.close()


def _wait(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_replica_poll_thread_and_router_heartbeats(tmp_path):
    """``start()`` syncs on a poll thread and ``start_heartbeats()``
    probes on another while the caller routes queries: the replica
    follows the writer swap by swap, every routed answer is exact, and
    ``stop()`` ends both threads."""
    s = _writer(tmp_path)
    pub = s.publish_to(str(tmp_path / "pub"))
    replica = _replica(pub.transport(), tmp_path / "rep").start(0.02)
    router = QueryRouter(heartbeat_timeout=60.0).start_heartbeats(0.02)
    router.register("r", replica)
    try:
        for i, unit in enumerate(proposal_units()):
            s.ingest(unit)
            if (i + 1) % SWAP_EVERY == 0:
                s.flush()
                _wait(lambda: router.status()["watermark"] == s.watermark,
                      f"the router never saw t={s.watermark}")
                _matches_oracle(router, "dense", 1, s.watermark,
                                ctx=f"routed@{s.watermark}")
    finally:
        threads = (replica._poll_thread, router._hb_thread)
        replica.stop()
        router.stop()
    assert not any(t.is_alive() for t in threads)
    assert replica.stats.syncs > 4 and replica.stats.full_rebuilds == 0
    s.close()


# ---------------------------------------------------------------------------
# mixed fleets: the two packages replicate each other
# ---------------------------------------------------------------------------


def _jax_replica_exact(replica) -> None:
    w = replica.watermark
    assert w >= 1
    qs = jtp._grid(1, w)
    jtp._assert_bitequal(replica.evaluate_many(qs),
                         jtp._oracle("dense").evaluate_many(qs),
                         ctx=f"jax replica@{w}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mixed_fleet_bitexact(tmp_path, writer):
    """A port replica of a JAX writer's publish root, and a JAX replica
    of a port writer's, each synced after every swap: every grid answer
    equals the reference oracle's, and catch-up never falls back to a
    full rebuild."""
    if writer == "jax":
        s = JSession.open(str(tmp_path / "w"), n_cap=N_CAP,
                          segment_min_ops=SEGMENT_MIN_OPS)
        replica = _replica(LocalDirTransport(str(tmp_path / "pub")),
                           tmp_path / "rep")
        exact = _check_replica_exact
    else:
        s = GraphSession.open(str(tmp_path / "w"), n_cap=N_CAP,
                              segment_min_ops=SEGMENT_MIN_OPS, device="cpu")
        replica = jrep.ReadReplica(
            jrep.LocalDirTransport(str(tmp_path / "pub")),
            str(tmp_path / "rep"))
        exact = _jax_replica_exact
    s.publish_to(str(tmp_path / "pub"))
    modes = []
    for i, unit in enumerate(proposal_units()):
        s.ingest([JOp(*o) for o in unit] if writer == "jax" else unit)
        if (i + 1) % SWAP_EVERY == 0:
            s.flush()
            modes.append(replica.sync()["mode"])
            assert replica.watermark == s.watermark
            exact(replica)
    s.flush()
    modes.append(replica.sync()["mode"])
    exact(replica)
    assert modes[0] == "initial" and set(modes[1:]) <= {"rotate",
                                                        "incremental"}
    assert replica.stats.full_rebuilds == 0
    s.close()


def test_same_fault_seed_same_sync_as_the_reference(tmp_path):
    """A port and a reference replica of one publish root, each behind
    a ``FaultyTransport`` with the same seed and rules and synced at the
    same points, take the same modes and count the same fetches,
    quarantines, retries and rebuilds."""
    s = _writer(tmp_path)
    s.publish_to(str(tmp_path / "pub"))

    def faulty(mod):
        inj = mod.FaultInjector(seed=41)
        inj.add("fetch", "drop", prob=0.15)
        inj.add("fetch", "torn", prob=0.15, frac=0.4)
        inj.add("fetch", "bit_flip", prob=0.15)
        return mod.FaultyTransport(
            mod.LocalDirTransport(str(tmp_path / "pub")), inj)

    kw = dict(seed=9, backoff_base=0.0005, backoff_max=0.002,
              max_retries=4)
    port = _replica(faulty(trep), tmp_path / "port", **kw)
    ref = jrep.ReadReplica(faulty(jrep), str(tmp_path / "ref"), **kw)
    runs = {"port": [], "ref": []}

    def sync_both():
        for name, r in (("port", port), ("ref", ref)):
            try:
                runs[name].append(r.sync()["mode"])
            except (ReplicaSyncError, jrep.ReplicaSyncError):
                runs[name].append("failed")

    for i, unit in enumerate(proposal_units()):
        s.ingest(unit)
        if (i + 1) % SWAP_EVERY == 0:
            s.flush()
            sync_both()
    s.flush()
    for _ in range(3):
        sync_both()
    assert runs["port"] == runs["ref"]
    assert "failed" in runs["port"] or port.stats.fetch_retries > 0
    keys = ("syncs", "sync_failures", "segments_fetched", "segments_reused",
            "bytes_fetched", "records_applied", "full_rebuilds",
            "quarantined", "fetch_retries")
    got, want = port.stats.asdict(), ref.stats.asdict()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["quarantined"] > 0
    assert port.watermark == ref.watermark == s.watermark
    _check_replica_exact(port)
    s.close()


# ---------------------------------------------------------------------------
# kill -9: replicas and the writer
# ---------------------------------------------------------------------------


def _run_replica_child(pub_root, rep_root, out, spec, nth, expect_kill):
    proc = subprocess.run(
        [sys.executable, HERE, "replica", pub_root, rep_root, out, spec,
         str(nth)],
        env=_child_env(), capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    if expect_kill:
        assert proc.returncode == -signal.SIGKILL, \
            (spec, proc.returncode, proc.stderr[-2000:])
    else:
        assert proc.returncode == 0, \
            (spec, proc.returncode, proc.stderr[-2000:])
        with open(out) as fh:
            return json.load(fh)


def _oracle_answers(t_hi: int) -> list[list[float]]:
    from repro.core.plans import Query as JQuery
    qs = [JQuery(**q) for q in grid(1, t_hi)]
    return [[float(x) for x in np.asarray(a).reshape(-1)]
            for a in _oracle("dense").evaluate_many(qs)]


@pytest.mark.parametrize("spec,nth", [("after_sync", 1), ("mid_sync", 1)],
                         ids=["after-sync", "mid-sync"])
def test_kill9_replica_rejoins_by_diff(tmp_path, spec, nth):
    """kill -9 a replica (post-sync or mid-sync), publish more epochs,
    restart it: the rejoin fetches only the new segments and the final
    answers bit-match the oracle."""
    s = _writer(tmp_path)
    pub_root = str(tmp_path / "pub")
    s.publish_to(pub_root)
    units = proposal_units()
    for unit in units[:6]:
        s.ingest(unit)
    s.flush()
    n_seg_half = len(s.store._segments)

    rep_root, out = str(tmp_path / "rep"), str(tmp_path / "out.json")
    _run_replica_child(pub_root, rep_root, out, spec, nth,
                       expect_kill=True)

    for unit in units[6:]:               # writer moves on past the death
        s.ingest(unit)
    s.flush()
    n_seg_full = len(s.store._segments)
    assert n_seg_full > n_seg_half

    payload = _run_replica_child(pub_root, rep_root, out, "none", 0,
                                 expect_kill=False)
    assert payload["watermark"] == s.watermark
    assert payload["answers"] == _oracle_answers(payload["watermark"])
    # rejoin by manifest diff ALONE: everything mirrored before the
    # kill is reused, only post-death segments cross the wire
    stats = payload["stats"]
    assert stats["full_rebuilds"] == 0
    if spec == "after_sync":
        assert stats["segments_reused"] >= n_seg_half
        assert stats["segments_fetched"] == n_seg_full - n_seg_half
    else:                                # mid-sync death: no manifest
        assert stats["segments_reused"] >= 1   # yet files were kept
    s.close()


def _spawn_writer(writer_root, pub_root, ms_per_unit=20):
    return subprocess.Popen(
        [sys.executable, HERE, "writer", writer_root, pub_root,
         str(ms_per_unit)],
        env=_child_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def _wait_for_watermark(pub_root, t_min, timeout=CHILD_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        m = tmf.read_manifest(pub_root)
        if m is not None and m["t_sealed"] >= t_min:
            return
        time.sleep(0.05)
    raise AssertionError(f"publish root never reached t={t_min}")


def test_kill9_writer_replica_keeps_serving(tmp_path):
    """kill -9 the WRITER mid-stream: the replica keeps serving its
    watermark exactly; the restarted writer recovers, resumes
    publishing, and the replica catches up to the full stream."""
    writer_root = str(tmp_path / "writer")
    pub_root = str(tmp_path / "pub")
    final_t = proposal_units()[-1][-1][3]

    proc = _spawn_writer(writer_root, pub_root)
    try:
        _wait_for_watermark(pub_root, 3)
        proc.send_signal(signal.SIGKILL)   # a real, uncatchable death
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()

    replica = _replica(LocalDirTransport(pub_root), tmp_path / "rep")
    replica.sync()
    w_dead = replica.watermark
    assert w_dead >= 3
    _check_replica_exact(replica)          # exact while the writer is dead
    replica.sync()                         # and syncing is a clean no-op

    proc = _spawn_writer(writer_root, pub_root, ms_per_unit=0)
    try:
        assert proc.wait(timeout=CHILD_TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    for _ in range(10):
        replica.sync()
        if replica.watermark >= final_t:
            break
    assert replica.watermark == final_t
    assert replica.watermark > w_dead
    _check_replica_exact(replica)
    assert replica.stats.full_rebuilds == 0   # diff catch-up, even here


def test_chaos_writer_kill_faulty_fetch_routed_queries(tmp_path):
    """The full chaos drill: a live writer child streams and publishes,
    two replicas poll through a fault-injecting transport, a router
    serves a query load the whole time, the writer is kill -9'd and
    restarted mid-run.  EVERY answered query must bit-match the
    from-scratch oracle (history <= any watermark is immutable, so the
    oracle is time-invariant) and the fleet must converge to the full
    stream."""
    from repro.core.plans import Query as JQuery
    writer_root = str(tmp_path / "writer")
    pub_root = str(tmp_path / "pub")
    final_t = proposal_units()[-1][-1][3]
    oracle = _oracle("dense")
    ref = {t: oracle.evaluate_many([JQuery("point", "global", "num_edges",
                                           t_k=t)])[0]
           for t in range(1, final_t + 1)}

    replicas = []
    for i in range(2):
        inj = FaultInjector(seed=31 + i)
        inj.add("fetch", "drop", prob=0.1)
        inj.add("fetch", "bit_flip", prob=0.1)
        replicas.append(_replica(
            FaultyTransport(LocalDirTransport(pub_root), inj),
            tmp_path / f"rep{i}", name=f"r{i}", seed=i,
            backoff_base=0.001, backoff_max=0.01, max_retries=8))
    router = QueryRouter(heartbeat_timeout=60.0)
    for r in replicas:
        router.register(r.name, r)

    answered = 0
    proc = _spawn_writer(writer_root, pub_root)
    try:
        _wait_for_watermark(pub_root, 3)
        killed = False
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while time.monotonic() < deadline:
            for r in replicas:
                try:
                    r.sync()
                except ReplicaSyncError:
                    pass                 # injected noise; keep serving
            router.heartbeat()
            top = max(r.watermark for r in replicas)
            if top >= 1:                 # probe the full served range
                for t in range(1, top + 1):
                    got = router.evaluate_many([_q(t)])[0]
                    assert np.array_equal(np.asarray(got),
                                          np.asarray(ref[t])), t
                    answered += 1
            if not killed and top >= 3:
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=60)
                proc = _spawn_writer(writer_root, pub_root, ms_per_unit=0)
                killed = True
            if killed and proc.poll() == 0 and top >= final_t:
                break
        assert killed
        assert proc.wait(timeout=CHILD_TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()

    for r in replicas:
        for _ in range(10):
            try:
                r.sync()
            except ReplicaSyncError:
                continue
            if r.watermark >= final_t:
                break
        assert r.watermark == final_t
        _check_replica_exact(r)
    assert answered > 0
    assert router.queries_routed == answered
