"""The port's engine (``repro_torch.core.engine``) against
``repro.core.engine``: ``evaluate_many`` parity on the dense, edge and
auto layouts, every forced plan, plan choices, materialized anchors,
batch-composition and chunking invariance, and the segmented log
against ``repro``'s monolithic one.  Answers must match bit for bit,
dtype included; only ``pagerank`` carries a tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import queries as JQ  # noqa: E402
from repro.core.generate import EvolutionParams, generate_ops  # noqa: E402
from repro.core.materialize import MaterializationPolicy as JPolicy  # noqa: E402
from repro.core.plans import Query as JQuery  # noqa: E402
from repro.core.plans import applicable_plans  # noqa: E402
from repro.core.store import TemporalGraphStore as JStore  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import queries as TQ  # noqa: E402
from repro_torch.core.materialize import MaterializationPolicy  # noqa: E402
from repro_torch.core.plans import Query  # noqa: E402
from repro_torch.core.store import TemporalGraphStore  # noqa: E402
from test_torch_reconstruct import eq, port_graph  # noqa: E402

N_CAP = 64
PARAMS = EvolutionParams(m_attach=3, lam_extra=1.2, lam_remove=1.2,
                         p_remove_node=0.02, events_per_unit=6)


def _pair(layout="dense", policy=None, seed=5, segment_min_ops=64,
          n_chunks=3):
    ops = generate_ops(48, PARAMS, seed=seed)
    j = JStore(N_CAP, layout=layout,
               policy=JPolicy(**policy) if policy else None)
    t = TemporalGraphStore(N_CAP, layout=layout, device="cpu",
                           policy=MaterializationPolicy(**policy)
                           if policy else None,
                           segment_min_ops=segment_min_ops)
    t_max = ops[-1].t
    cuts = [t_max * k // n_chunks for k in range(n_chunks + 1)]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        chunk = [(o.op, o.u, o.v, o.t) for o in ops if lo < o.t <= hi]
        for s in (j, t):
            s.ingest(chunk)
            s.advance_to(hi)
            s.freeze_serving_state()
    return j, t


@pytest.fixture(scope="module")
def dense_pair():
    return _pair("dense")


@pytest.fixture(scope="module")
def edge_pair():
    return _pair("edge")


def _matrix(tc):
    """(kind, scope, measure) cells with exact-integer or fixed f32
    answers."""
    return [
        dict(kind="point", scope="node", measure="degree", t_k=tc // 3, v=5),
        dict(kind="diff", scope="node", measure="degree", t_k=tc // 4,
             t_l=3 * tc // 4, v=9),
        dict(kind="agg", scope="node", measure="degree", t_k=tc // 2,
             t_l=tc // 2 + 6, v=3, agg="mean"),
        dict(kind="agg", scope="node", measure="degree", t_k=tc // 2,
             t_l=tc // 2 + 6, v=3, agg="min"),
        dict(kind="agg", scope="node", measure="degree", t_k=tc // 3,
             t_l=tc // 3 + 9, v=12, agg="max"),
        dict(kind="point", scope="global", measure="num_edges", t_k=tc // 2),
        dict(kind="point", scope="global", measure="num_nodes", t_k=tc // 2),
        dict(kind="point", scope="global", measure="density", t_k=tc // 5),
        dict(kind="point", scope="global", measure="avg_degree",
             t_k=tc - 1),
        dict(kind="point", scope="global", measure="degree_distribution",
             t_k=tc // 2),
        dict(kind="diff", scope="global", measure="num_edges", t_k=tc // 4,
             t_l=3 * tc // 4),
        dict(kind="diff", scope="global", measure="density", t_k=tc // 4,
             t_l=tc // 2),
        dict(kind="agg", scope="global", measure="num_edges", t_k=tc // 2,
             t_l=tc // 2 + 4, agg="max"),
        dict(kind="agg", scope="global", measure="avg_degree", t_k=tc // 2,
             t_l=tc // 2 + 5, agg="mean"),
        dict(kind="evolve", scope="global", measure="density", t_k=2,
             t_l=tc, stride=3),
        dict(kind="evolve", scope="node", measure="degree", t_k=1,
             t_l=tc - 1, stride=2, v=4),
    ]


_DENSE_ONLY = [
    dict(kind="point", scope="global", measure="triangles", t_k=20),
    dict(kind="point", scope="global", measure="num_components", t_k=25),
    dict(kind="point", scope="global", measure="diameter", t_k=30),
    dict(kind="point", scope="node", measure="neighborhood2", t_k=30, v=6),
    dict(kind="point", scope="node", measure="induced_avg_degree", t_k=30,
         v=6),
    dict(kind="diff", scope="global", measure="triangles", t_k=10,
         t_l=40),
]


def _both(j, t, specs, **kw):
    a = j.evaluate_many([JQuery(**s) for s in specs], **kw)
    b = t.evaluate_many([Query(**s) for s in specs], **kw)
    for s, x, y in zip(specs, a, b):
        try:
            eq(x, y)
        except AssertionError as exc:
            raise AssertionError(f"{s}: {x!r} vs {y!r}") from exc


@pytest.mark.parametrize("layout", [None, "dense", "edge"])
def test_evaluate_many_parity_dense_store(dense_pair, layout):
    """auto (None), forced dense and forced edge on a dense store (which
    carries the slot registry, so the planner may pick either)."""
    j, t = dense_pair
    specs = _matrix(j.t_cur) + (_DENSE_ONLY if layout != "edge" else [])
    _both(j, t, specs, layout=layout)


def test_evaluate_many_parity_edge_store(edge_pair):
    j, t = edge_pair
    _both(j, t, _matrix(j.t_cur))


def test_every_forced_plan(dense_pair):
    j, t = dense_pair
    for s in _matrix(j.t_cur):
        if s["kind"] == "evolve":
            continue
        for plan in applicable_plans(JQuery(**s)):
            _both(j, t, [s], plan=plan)


def test_partial_and_windowed_variants(dense_pair):
    j, t = dense_pair
    tc = j.t_cur
    specs = [dict(kind="point", scope="node", measure="degree", t_k=tc // 3,
                  v=5),
             dict(kind="diff", scope="node", measure="degree", t_k=tc // 4,
                  t_l=3 * tc // 4, v=9),
             dict(kind="agg", scope="node", measure="degree", t_k=tc // 2,
                  t_l=tc // 2 + 3, v=7, agg="max")]
    _both(j, t, specs, plan="two_phase", partial_rows=True, layout="dense")
    _both(j, t, specs, plan="two_phase", windowed=True)


def test_plan_choices_match(dense_pair):
    j, t = dense_pair
    specs = _matrix(j.t_cur) + _DENSE_ONLY
    _, cj = j.engine().evaluate_many([JQuery(**s) for s in specs],
                                     return_choices=True)
    _, ct = t.engine().evaluate_many([Query(**s) for s in specs],
                                     return_choices=True)
    for a, b in zip(cj, ct):
        assert (a.plan, a.anchor_id, a.t_anchor, a.indexed, a.windowed,
                a.partial, a.layout, a.cost) == (
            b.plan, b.anchor_id, b.t_anchor, b.indexed, b.windowed,
            b.partial, b.layout, b.cost)


def test_materialized_anchors(dense_pair):
    j, t = _pair("dense", policy=dict(kind="periodic", period=12), seed=6,
                 n_chunks=8)
    assert j.materialized.times == t.materialized.times
    assert len(t.materialized.times) >= 2
    _both(j, t, _matrix(j.t_cur)[::2] + _DENSE_ONLY[:1])
    for tq in (3, j.t_cur - 1):
        eq(j.snapshot_at(tq).adj, t.snapshot_at(tq).adj)
        eq(j.snapshot_at(tq, windowed=True).adj,
           t.snapshot_at(tq, windowed=True).adj)


def test_batch_invariance(dense_pair):
    """A query's answer does not depend on what it is batched with."""
    _, t = dense_pair
    specs = _matrix(t.t_cur) + _DENSE_ONLY
    together = t.evaluate_many([Query(**s) for s in specs])
    order = np.random.default_rng(0).permutation(len(specs))
    shuffled = t.evaluate_many([Query(**specs[i]) for i in order])
    for k, i in enumerate(order):
        eq(together[i], shuffled[k])
        eq(together[i], t.evaluate_many([Query(**specs[i])])[0])


def test_chunking_does_not_change_answers(dense_pair, monkeypatch):
    """Agg groups reconstruct B × buckets snapshots in memory-sized
    chunks; one snapshot per chunk gives the same bits."""
    _, t = dense_pair
    tc = t.t_cur
    specs = [dict(kind="agg", scope="global", measure="triangles",
                  t_k=tc // 3, t_l=tc // 3 + 5, agg="max"),
             dict(kind="agg", scope="global", measure="num_edges",
                  t_k=tc // 2, t_l=tc // 2 + 7, agg="mean"),
             dict(kind="diff", scope="global", measure="num_components",
                  t_k=5, t_l=tc - 5)]
    qs = [Query(**s) for s in specs]
    whole = t.evaluate_many(qs, layout="dense")
    monkeypatch.setattr(TE, "_chunk", lambda g, q: 1)
    eng = t.engine()
    eng._snap_cache.clear()
    chunked = eng.evaluate_many(qs, layout="dense")
    for a, b in zip(whole, chunked):
        eq(a, b)


@pytest.mark.parametrize("ops_kind", ["stream", "duplicate_adds"])
def test_segmented_vs_monolithic(ops_kind):
    """The port's segmented log (tiny segments, many seals) answers like
    ``repro``'s monolithic store.  With duplicate addNode chunks most of
    the ingest is rejected, so fragmentation is only asserted when the
    accepted log is long enough to have been cut (ROADMAP C2)."""
    if ops_kind == "stream":
        ops = [(o.op, o.u, o.v, o.t)
               for o in generate_ops(40, PARAMS, seed=8)]
    else:
        ops = [(0, i % 6, i % 6, 1 + i // 3) for i in range(60)]
        ops += [(2, 0, 1, 30), (2, 1, 2, 31), (3, 0, 1, 33)]
    j = JStore(N_CAP, segmented=False)
    t = TemporalGraphStore(N_CAP, device="cpu", segment_min_ops=4)
    t_max = ops[-1][3]
    accepted = 0
    for k in range(1, 6):
        lo, hi = t_max * (k - 1) // 5, t_max * k // 5
        chunk = [o for o in ops if lo < o[3] <= hi]
        j.ingest(chunk)
        accepted += t.ingest(chunk)
        for s in (j, t):
            s.advance_to(hi)
            s.freeze_serving_state()
    if accepted >= 5 * t.segment_min_ops:
        assert len(t._segments) >= 2
    tc = t.t_cur
    specs = [dict(kind="point", scope="global", measure="num_edges",
                  t_k=tc // 2),
             dict(kind="point", scope="node", measure="degree", t_k=tc - 1,
                  v=1),
             dict(kind="diff", scope="global", measure="num_nodes", t_k=1,
                  t_l=tc),
             dict(kind="evolve", scope="global", measure="num_edges", t_k=1,
                  t_l=tc, stride=2)]
    _both(j, t, specs)
    eq(j.stats()["total_ops"], np.asarray(t.stats()["total_ops"]))


def test_dense_measures_on_snapshots(dense_pair):
    j, t = dense_pair
    for tq in (j.t_cur // 3,):
        g = j.snapshot_at(tq)
        tg = port_graph(g)
        for name, fn in JQ.GLOBAL_MEASURES.items():
            eq(fn(g), TQ.GLOBAL_MEASURES[name](tg))
        for name, fn in JQ.NODE_MEASURES.items():
            for v in (0, 7, 30):
                eq(fn(g, v), TQ.NODE_MEASURES[name](tg, v))
        for v in (0, 3, 30):
            eq(JQ.in_k_core(g, v, 3), TQ.in_k_core(tg, v, 3))
        eg = j.engine().edge_anchor(-1)[1]
        teg = port_graph(eg)
        for name, fn in JQ.EDGE_GLOBAL_MEASURES.items():
            eq(fn(eg), TQ.EDGE_GLOBAL_MEASURES[name](teg))


def test_pagerank_within_tolerance(dense_pair):
    """PageRank sums in a different order in XLA and torch: f32 with a
    stated rtol (20 power iterations of ~64-term dot products)."""
    j, _ = dense_pair
    g = j.snapshot_at(j.t_cur // 2)
    np.testing.assert_allclose(np.asarray(JQ.pagerank(g)),
                               TQ.pagerank(port_graph(g)).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_store_query_shim(dense_pair):
    j, t = dense_pair
    for s in _matrix(j.t_cur)[:9]:
        eq(j.query(JQuery(**s)), t.query(Query(**s)))


def test_off_slice_engine_arguments_raise(dense_pair):
    """``mesh=`` is on the slice: on a mesh of CPU devices the engine
    answers like the unmeshed call (forced sharded groups engaged), and
    only a mesh naming another device type than the state's raises."""
    from repro_torch.sharding import graph_mesh
    j, t = dense_pair
    specs = _matrix(t.t_cur)[:9]
    mesh = graph_mesh(["cpu"] * 4)
    got = t.engine().evaluate_many([Query(**s) for s in specs], mesh=mesh,
                                   shard="force")
    assert None not in {m for *_, m in t.engine().last_group_stats}
    want = j.evaluate_many([JQuery(**s) for s in specs])
    for a, b in zip(want, got):
        eq(a, b)
    with pytest.raises(ValueError, match="cuda"):
        t.engine().evaluate_many([Query(**specs[0])],
                                 mesh=graph_mesh(["cpu", "cuda"]))


def _indexed_specs(tc, v_small, v_big):
    """Node-scope degree queries on a node within ``node_cap`` ops and
    one past it (point → hybrid, diff → delta-only or hybrid, agg →
    hybrid agg), plus queries the index never serves."""
    specs = []
    for v in (v_small, v_big):
        specs += [
            dict(kind="point", scope="node", measure="degree", t_k=tc // 3,
                 v=v),
            dict(kind="point", scope="node", measure="degree", t_k=tc - 2,
                 v=v),
            dict(kind="diff", scope="node", measure="degree", t_k=tc // 4,
                 t_l=tc // 4 + 3, v=v),
            dict(kind="diff", scope="node", measure="degree", t_k=tc // 2,
                 t_l=tc - 1, v=v),
            dict(kind="agg", scope="node", measure="degree", t_k=tc // 2,
                 t_l=tc // 2 + 6, v=v, agg="max"),
        ]
    return specs + [
        dict(kind="point", scope="global", measure="num_edges", t_k=tc // 2),
        dict(kind="evolve", scope="node", measure="degree", t_k=1,
             t_l=tc - 1, stride=2, v=v_small)]


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_indexed_answers_and_choices_match(layout):
    """The node-centric index (paper §3.3.2): with the index built and a
    ``node_cap`` between two nodes' op counts, the planner's choices
    (``indexed`` included) and the answers equal ``repro``'s; the node
    past ``node_cap`` stays unindexed in both.  Forcing ``indexed=True``
    on every query gives ``repro``'s answers too."""
    j, t = _pair(layout)
    counts = np.diff(np.asarray(j.node_index().row_ptr))
    np.testing.assert_array_equal(
        counts, np.diff(t.node_index().row_ptr.numpy()))
    order = np.argsort(counts, kind="stable")
    v_small, v_big = int(order[len(order) // 2]), int(order[-1])
    node_cap = int(counts[v_small])
    assert counts[v_big] > node_cap
    specs = _indexed_specs(j.t_cur, v_small, v_big)
    a, cj = j.engine(indexed=True, node_cap=node_cap).evaluate_many(
        [JQuery(**s) for s in specs], return_choices=True)
    b, ct = t.engine(indexed=True, node_cap=node_cap).evaluate_many(
        [Query(**s) for s in specs], return_choices=True)
    for s, x, y, c1, c2 in zip(specs, a, b, cj, ct):
        eq(x, y)
        assert (c1.plan, c1.anchor_id, c1.t_anchor, c1.indexed,
                c1.windowed, c1.partial, c1.layout, c1.cost) == (
            c2.plan, c2.anchor_id, c2.t_anchor, c2.indexed, c2.windowed,
            c2.partial, c2.layout, c2.cost), s
    assert any(c.indexed for c in ct)
    big = [c for s, c in zip(specs, ct) if s.get("v") == v_big
           and s["kind"] != "evolve"]
    assert any(c.plan in ("hybrid", "delta_only") for c in big)
    assert not any(c.indexed for c in big)
    assert any(k.indexed for k, *_ in t.engine(
        indexed=True, node_cap=node_cap).last_group_stats)
    _both(j, t, specs, indexed=True)
    # the planner's cost ties go to hybrid: force the indexed delta-only
    diffs = [s for s in specs if s["kind"] == "diff"]
    _both(j, t, diffs, plan="delta_only", indexed=True)
    # the single-query shim through the index (plans.evaluate)
    for s in specs[:4]:
        eq(j.query(JQuery(**s), indexed=True),
           t.query(Query(**s), indexed=True))


def test_single_query_plans(dense_pair):
    """The scalar plan kernels of ``plans.py`` (index and window
    variants included) against ``repro.core.plans``."""
    from repro.core import index as JI
    from repro.core import plans as JP
    from repro_torch.core import index as TI
    from repro_torch.core import plans as TP
    j, t = dense_pair
    jd, td = j.delta(), t.delta()
    ji, ti = JI.build_node_index(jd, N_CAP), TI.build_node_index(td, N_CAP)
    tc, jc, cc = j.t_cur, j.current, t.current
    for v in (3, 9, 21):
        eq(JP.delta_only_degree_diff(jd, v, 4, tc - 2),
           TP.delta_only_degree_diff(td, v, 4, tc - 2))
        eq(JP.delta_only_degree_diff_indexed(jd, ji, v, 4, tc - 2, 64),
           TP.delta_only_degree_diff_indexed(td, ti, v, 4, tc - 2, 64))
        eq(JP.hybrid_point_degree(jc, jd, v, tc // 2, tc),
           TP.hybrid_point_degree(cc, td, v, tc // 2, tc))
        eq(JP.hybrid_point_degree_indexed(jc, jd, ji, v, tc // 2, tc, 64),
           TP.hybrid_point_degree_indexed(cc, td, ti, v, tc // 2, tc, 64))
        for agg in ("mean", "min", "max"):
            eq(JP.hybrid_agg_degree(jc, jd, v, tc // 3, tc // 3 + 5, 8,
                                    agg),
               TP.hybrid_agg_degree(cc, td, v, tc // 3, tc // 3 + 5, 8,
                                    agg))
        eq(JP.hybrid_agg_degree_windowed(jc, jd, v, tc // 3, tc // 3 + 5,
                                         tc, 8, 256),
           TP.hybrid_agg_degree_windowed(cc, td, v, tc // 3, tc // 3 + 5,
                                         tc, 8, 256))
    for s in _matrix(tc)[:6]:
        eq(JP.two_phase(jc, jd, tc, JQuery(**s), sequential=True),
           TP.two_phase(cc, td, tc, Query(**s), sequential=True))
        eq(JP.evaluate(jc, jd, tc, JQuery(**s)),
           TP.evaluate(cc, td, tc, Query(**s)))
