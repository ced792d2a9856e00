"""The whole slice: ``repro_torch.api.GraphSession`` against
``repro.api.GraphSession(path=None)`` on the same op stream — ingest in
flushed batches, ``query``, ``query_many``, ``sweep``, ``snapshot_at``,
``stats`` — on the dense, edge and auto layouts; a durable, indexed
session in both packages (equal roots, equal answers after a reopen);
``store_from_numpy`` carrying a ``repro`` store's state across; and the
keywords that lead off the single-device slice raising
``NotImplementedError``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import GraphSession as JSession  # noqa: E402
from repro.api import Query as JQuery  # noqa: E402
from repro.core.delta import ADD_EDGE, ADD_NODE  # noqa: E402
from repro.core.generate import EvolutionParams, generate_ops  # noqa: E402
from repro.core.materialize import MaterializationPolicy as JPolicy  # noqa: E402
from repro.core.store import TemporalGraphStore as JStore  # noqa: E402
from repro_torch.api import GraphSession, Query, WatermarkError  # noqa: E402
from repro_torch.convert import store_from_numpy  # noqa: E402
from test_torch_reconstruct import eq  # noqa: E402

N_CAP = 64
PARAMS = EvolutionParams(m_attach=3, lam_extra=1.0, lam_remove=1.0,
                         p_remove_node=0.02, events_per_unit=6)


def _ops(seed=3):
    return [(o.op, o.u, o.v, o.t)
            for o in generate_ops(48, PARAMS, seed=seed)]


def _chunks(ops, n=3):
    t_max = ops[-1][3]
    cuts = [t_max * k // n for k in range(n + 1)]
    return [[o for o in ops if lo < o[3] <= hi]
            for lo, hi in zip(cuts[:-1], cuts[1:])]


def _specs(tc):
    return [
        dict(kind="point", scope="node", measure="degree", t_k=tc // 3, v=5),
        dict(kind="diff", scope="node", measure="degree", t_k=tc // 4,
             t_l=3 * tc // 4, v=9),
        dict(kind="agg", scope="node", measure="degree", t_k=tc // 2,
             t_l=tc // 2 + 6, v=3, agg="mean"),
        dict(kind="point", scope="global", measure="num_edges", t_k=tc // 2),
        dict(kind="point", scope="global", measure="density", t_k=tc // 3),
        dict(kind="point", scope="global", measure="degree_distribution",
             t_k=tc // 2),
        dict(kind="diff", scope="global", measure="avg_degree", t_k=tc // 4,
             t_l=tc - 2),
        dict(kind="agg", scope="global", measure="density", t_k=tc // 2,
             t_l=tc // 2 + 4, agg="mean"),
        dict(kind="evolve", scope="global", measure="num_nodes", t_k=1,
             t_l=tc, stride=4),
    ]


@pytest.fixture(scope="module", params=["dense", "edge"])
def sessions(request):
    layout = request.param
    js = JSession(n_cap=N_CAP, layout=layout)
    ts = GraphSession(n_cap=N_CAP, layout=layout, device="cpu")
    for chunk in _chunks(_ops()):
        assert js.ingest(chunk) == ts.ingest(chunk)
        js.flush()
        ts.flush()
    return layout, js, ts


def test_query_many_matches_jax(sessions):
    layout, js, ts = sessions
    specs = _specs(js.t_cur)
    if layout == "dense":
        specs += [dict(kind="point", scope="global", measure="triangles",
                       t_k=js.t_cur // 2),
                  dict(kind="point", scope="node", measure="neighborhood2",
                       t_k=js.t_cur // 2, v=4)]
    a = js.query_many([JQuery(**s) for s in specs])
    b = ts.query_many([Query(**s) for s in specs])
    for x, y in zip(a, b):
        eq(x, y)


def test_query_sweep_snapshot_stats_match_jax(sessions):
    layout, js, ts = sessions
    tc = js.t_cur
    assert js.query("degree", t=tc // 2, v=3) == ts.query("degree",
                                                           t=tc // 2, v=3)
    assert js.query("num_edges", kind="diff", t_k=2, t_l=tc - 1) == \
        ts.query("num_edges", kind="diff", t_k=2, t_l=tc - 1)
    for kw in (dict(measure="avg_degree", t_lo=1, t_hi=tc, stride=3),
               dict(measure="degree", t_lo=2, t_hi=tc - 1, v=7),
               dict(measure="degree_distribution", t_lo=3, t_hi=tc,
                    stride=5)):
        eq(js.sweep(**kw), ts.sweep(**kw))
    for t in (1, tc // 2, tc):
        a, b = js.snapshot_at(t), ts.snapshot_at(t)
        eq(a.nodes, b.nodes)
        eq(a.adj if layout == "dense" else a.emask,
           b.adj if layout == "dense" else b.emask)
    sa, sb = js.stats(), ts.stats()
    keys = set(sa) - {"cache_hits", "cache_misses"}
    assert {k: sa[k] for k in keys} == {k: sb[k] for k in keys}


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_durable_indexed_session_matches_jax(tmp_path, layout):
    """The slice as a whole: ``GraphSession(path=..., indexed=True)`` in
    both packages over one op stream — equal answers, equal roots file
    by file — then ``close`` and ``GraphSession.open(path)`` in both,
    with equal answers again, equal to the in-memory session's."""
    import filecmp
    import os
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    js = JSession(path=roots["jax"], n_cap=N_CAP, layout=layout,
                  indexed=True, node_cap=16)
    ts = GraphSession(path=roots["port"], n_cap=N_CAP, layout=layout,
                      indexed=True, node_cap=16, device="cpu")
    mem = GraphSession(n_cap=N_CAP, layout=layout, device="cpu")
    for chunk in _chunks(_ops()):
        for s in (js, ts, mem):
            s.ingest(chunk)
            s.flush()
    specs = _specs(js.t_cur)
    specs += [dict(kind="diff", scope="node", measure="degree", t_k=2,
                   t_l=js.t_cur - 1, v=v) for v in range(0, 40, 3)]

    def answers():
        a = js.query_many([JQuery(**s) for s in specs])
        b = ts.query_many([Query(**s) for s in specs])
        c = mem.query_many([Query(**s) for s in specs])
        for x, y, z in zip(a, b, c):
            eq(x, y)
            eq(x, z)

    answers()
    assert any(k.indexed for k, *_ in ts.live.engine.last_group_stats)
    js.close()
    ts.close()
    for dirpath, _, files in os.walk(roots["jax"]):
        for f in files:
            a = os.path.join(dirpath, f)
            assert filecmp.cmp(a, a.replace(roots["jax"], roots["port"]),
                               shallow=False), f
    js = JSession.open(roots["jax"], indexed=True, node_cap=16)
    ts = GraphSession.open(roots["port"], indexed=True, node_cap=16,
                           device="cpu")
    assert ts.watermark == js.watermark == mem.watermark
    answers()


def test_swap_listeners_run_after_the_checkpoint(tmp_path):
    """A swap listener runs after the checkpoint and the engine flip: it
    sees the new watermark and a manifest that already names the rotated
    WAL; a listener that raises is collected, never raised."""
    from repro_torch.persist import read_manifest
    root = str(tmp_path / "g")
    s = GraphSession(path=root, n_cap=N_CAP, device="cpu")
    seen = []

    def listener(rec):
        seen.append((rec.t_served, s.watermark,
                     read_manifest(root)["wal_seq"]))

    def broken(rec):
        raise RuntimeError("publish failed")

    s.live.add_swap_listener(listener)
    s.live.add_swap_listener(broken)
    for chunk in _chunks(_ops()):
        s.ingest(chunk)
        s.flush()
    assert [w for w, _, _ in seen] == [w for _, w, _ in seen] == [
        c[-1][3] for c in _chunks(_ops())]
    assert [q for _, _, q in seen] == [2, 3, 4]
    assert len(s.live.listener_errors) == 3
    s.close()


def test_live_ingest_block_and_raise():
    """stale='block' sees its own writes; stale='raise' refuses queries
    past the watermark with a WatermarkError (a ValueError)."""
    js = JSession(n_cap=16)
    ts = GraphSession(n_cap=16, device="cpu")
    ops = [(ADD_NODE, i, i, 1) for i in range(4)] + [
        (ADD_EDGE, 0, 1, 2), (ADD_EDGE, 1, 2, 3), (ADD_EDGE, 0, 2, 3)]
    for s in (js, ts):
        s.ingest(ops)
    assert ts.query("num_edges", t=3) == js.query("num_edges", t=3) == 3
    strict = GraphSession(n_cap=8, stale="raise", device="cpu")
    strict.ingest([(ADD_NODE, 0, 0, 1)])
    strict.flush()
    with pytest.raises(ValueError):
        strict.query("num_nodes", t=99)
    with pytest.raises(WatermarkError):
        strict.snapshot_at(99)


@pytest.mark.parametrize("kw,match", [
    (dict(kind="window", measure="num_edges", t_k=1), "unknown query kind"),
    (dict(kind="point", scope="edgewise", measure="num_edges", t_k=1),
     "unknown scope"),
    (dict(measure="betweenness", t_k=1), "unknown global-scope measure"),
    (dict(kind="point", scope="node", measure="degree", t_k=1), "needs v="),
    (dict(kind="diff", measure="num_edges", t_k=5), "needs a time range"),
    (dict(kind="agg", measure="degree", v=0, t_k=5, t_l=3),
     "empty time range"),
    (dict(kind="evolve", measure="num_edges", t_k=1, t_l=9, stride=0),
     "stride must be >= 1"),
    (dict(kind="point", measure="num_edges", t_k=1, stride=4),
     "stride is an evolve parameter"),
    (dict(kind="agg", measure="degree", v=0, t_k=1, t_l=4, agg="median"),
     "unknown aggregate"),
])
def test_query_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        JQuery(**kw)
    with pytest.raises(ValueError, match=match):
        Query(**kw)


# ---------------------------------------------------------------------------
# store_from_numpy
# ---------------------------------------------------------------------------


def _export(st) -> dict:
    """What a ``repro`` store holds, as numpy arrays."""
    n = int(st.log_len)
    reg = st.edge_graph()
    n_reg = int(reg.n_edges_reg)
    state = {c: np.asarray(getattr(st, "_" + c))[:n]
             for c in ("op", "u", "v", "slot", "t")}
    state.update(n_cap=st.n_cap, layout=st.layout, t_cur=st.t_cur,
                 eu=np.asarray(reg.eu)[:n_reg],
                 ev=np.asarray(reg.ev)[:n_reg],
                 nodes=np.asarray(st.current.nodes))
    if st.layout == "dense":
        state["adj"] = np.asarray(st.current.adj)
    else:
        state["emask"] = np.asarray(st.current_edge_snapshot().emask)
    if st.materialized.times:
        state["mat_times"] = list(st.materialized.times)
        state["mat_nodes"] = [np.asarray(g.nodes)
                              for g in st.materialized.snapshots]
        state["mat_adj"] = [np.asarray(g.adj)
                            for g in st.materialized.snapshots]
    return state


@pytest.mark.parametrize("layout,policy", [("dense", None),
                                           ("edge", None),
                                           ("dense", "periodic")])
def test_store_from_numpy(layout, policy):
    st = JStore(N_CAP, layout=layout,
                policy=JPolicy(kind="periodic", period=10)
                if policy else None)
    ops = _ops(seed=11)
    for chunk in _chunks(ops, 6):
        st.ingest(chunk)
        st.advance_to(chunk[-1][3])
    # a pending tail past t_cur must carry across too
    st.ingest([(ADD_NODE, 60, 60, st.t_cur + 1)])
    port = store_from_numpy(_export(st), device="cpu")
    assert port.materialized.times == st.materialized.times
    assert port.stats() == st.stats()
    tc = st.t_cur
    specs = _specs(tc)
    a = st.evaluate_many([JQuery(**s) for s in specs])
    b = port.evaluate_many([Query(**s) for s in specs])
    for x, y in zip(a, b):
        eq(x, y)
    # both stores keep absorbing the same ops identically
    more = [(ADD_NODE, 61, 61, tc + 2), (ADD_EDGE, 60, 61, tc + 3)]
    assert st.ingest(more) == port.ingest(more)
    for s in (st, port):
        s.advance_to(tc + 3)
    eq(st.evaluate_many([JQuery("point", "global", "num_edges",
                                t_k=tc + 3)])[0],
       port.evaluate_many([Query("point", "global", "num_edges",
                                 t_k=tc + 3)])[0])


# ---------------------------------------------------------------------------
# Keywords that were off the slice: each now works on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,step", [
    (dict(mesh=("cpu",) * 4), "A12"),
])
def test_off_slice_keywords_raise(kw, step):
    """The keyword of ROADMAP ``step`` is ported: a session opened with
    it answers like one opened without it (a mesh of CPU devices here,
    every group forced sharded), and nothing raises."""
    from repro_torch.sharding import graph_mesh
    kw = {k: graph_mesh(v) if k == "mesh" else v for k, v in kw.items()}
    plain = GraphSession(n_cap=N_CAP, device="cpu")
    other = GraphSession(n_cap=N_CAP, device="cpu", **kw)
    for s in (plain, other):
        for chunk in _chunks(_ops()):
            s.ingest(chunk)
            s.flush()
    qs = [Query(**q) for q in _specs(plain.watermark)]
    for a, b in zip(other.live.evaluate_many(qs, shard="force"),
                    plain.live.evaluate_many(qs)):
        eq(b, a)
    assert None not in {m for *_, m in other.live.engine.last_group_stats}
    for a, b in zip(other.query_many(qs), plain.query_many(qs)):
        eq(b, a)


def test_replication_entry_points_work(tmp_path):
    """``publish_to`` / ``open_replica`` / ``open_router`` on the CPU: a
    durable session publishes every swap, a replica opened on its
    publish root answers like the writer at the writer's watermark, and
    a router in front of it does too; an in-memory session has nothing
    to publish."""
    with pytest.raises(ValueError, match="in-memory"):
        GraphSession(n_cap=8, device="cpu").publish_to(str(tmp_path / "x"))
    s = GraphSession(path=str(tmp_path / "w"), n_cap=N_CAP, device="cpu")
    pub = s.publish_to(str(tmp_path / "pub"))
    replica = GraphSession.open_replica(str(tmp_path / "pub"),
                                        str(tmp_path / "rep"), device="cpu")
    router = GraphSession.open_router({"rep": replica})
    assert replica.device.type == "cpu"
    for chunk in _chunks(_ops()):
        s.ingest(chunk)
        s.flush()
        replica.sync()
        router.heartbeat()
        assert replica.watermark == s.watermark == chunk[-1][3]
        qs = [Query(**q) for q in _specs(s.watermark)
              if max(q["t_k"], q.get("t_l") or 0) <= s.watermark]
        want = s.store.evaluate_many(qs)
        for got in (replica.evaluate_many(qs), router.evaluate_many(qs)):
            for g, w in zip(got, want):
                eq(np.asarray(w), np.asarray(g))
    assert len(pub.history) == 4         # the eager publish + 3 swaps
    assert replica.stats.full_rebuilds == 0
    with pytest.raises(WatermarkError):
        router.evaluate_many([Query("point", "global", "num_edges",
                                    t_k=s.watermark + 1)])
    s.close()
