"""Multi-device serving in the port (``repro_torch.core.distributed``,
``repro_torch.sharding``) on the CPU: every graph test of
``tests/test_distributed.py`` on meshes of 4 and 8 ``"cpu"`` shards, in
process (one controller drives the mesh, as in the reference).

Each answer is held three ways, bit for bit (dtype included): the
port's sharded result (``shard="force"``), the port's single-device
result (``shard="never"``) and the JAX package's single-device
``evaluate_many`` on the same seed.  The modes that engage (``rows``,
``slots``, ``batch``) are asserted, so no fallback passes unseen.  The
block glue of B1 (row blocks) and B2 (slot blocks) is held against the
port's whole-graph result and JAX's ``reconstruct_dense`` /
``reconstruct_edge`` (the Pallas kernels do not run here).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.generate import EvolutionParams as JParams  # noqa: E402
from repro.core.generate import build_store as j_build  # noqa: E402
from repro.core.generate import generate_ops  # noqa: E402
from repro.core.plans import Query as JQuery  # noqa: E402
from repro.core.reconstruct import reconstruct_dense as j_recon_dense  # noqa: E402
from repro.core.reconstruct import reconstruct_edge as j_recon_edge  # noqa: E402
from repro.core.store import TemporalGraphStore as JStore  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import queries as TQ  # noqa: E402
from repro_torch.core.delta import delta_from_numpy  # noqa: E402
from repro_torch.core.generate import EvolutionParams, build_store  # noqa: E402
from repro_torch.core.plans import Query  # noqa: E402
from repro_torch.core.reconstruct import (as_times,  # noqa: E402
                                          reconstruct_dense,
                                          reconstruct_edge)
from repro_torch.core.store import TemporalGraphStore  # noqa: E402
from repro_torch.kernels.delta_apply import (bucket_ops,  # noqa: E402
                                             delta_apply_row_block)
from repro_torch.kernels.edge_delta_apply import (  # noqa: E402
    bucket_slot_ops, edge_delta_apply_slot_block)
from repro_torch.serving import LiveGraphStore  # noqa: E402
from repro_torch.sharding import (GraphMesh, graph_mesh,  # noqa: E402
                                 shard_rows, shard_slots)
from test_torch_reconstruct import eq  # noqa: E402

N = 96
SEED = 11
STREAM = dict(m_attach=3, lam_extra=1.0, lam_remove=1.5, p_remove_node=0.03)
MESHES = [4, 8]


def cpu_mesh(n_dev: int) -> GraphMesh:
    return graph_mesh(["cpu"] * n_dev)


def jq(q: Query) -> JQuery:
    return JQuery(q.kind, q.scope, q.measure, t_k=q.t_k, t_l=q.t_l, v=q.v,
                  agg=q.agg, stride=q.stride)


def modes(eng) -> set:
    return {m for *_, m in eng.last_group_stats}


def three_way(eng, jstore, qs, **kw):
    """The port's forced-sharded answers equal its single-device ones and
    the JAX package's single-device ones, bit for bit; returns the modes
    the sharded call engaged."""
    ref = eng.evaluate_many(qs, shard="never", **kw)
    assert modes(eng) == {None}, eng.last_group_stats
    got = eng.evaluate_many(qs, shard="force", **kw)
    engaged = modes(eng)
    assert None not in engaged, eng.last_group_stats
    jax = jstore.evaluate_many([jq(q) for q in qs], **kw)
    for q, a, b, c in zip(qs, got, ref, jax):
        eq(c, a)
        eq(c, b)
    return engaged


@pytest.fixture(scope="module")
def stores():
    """The reference tests' store (96 nodes, seed 11) in both packages."""
    params = STREAM
    t = build_store(N, EvolutionParams(**params), seed=SEED, device="cpu")
    j = j_build(N, JParams(**params), seed=SEED)
    assert t.t_cur == j.t_cur
    return t, j


def _mix(tc, avg=False):
    qs = [
        Query("point", "node", "degree", t_k=tc // 3, v=5),
        Query("diff", "node", "degree", t_k=tc // 4, t_l=3 * tc // 4, v=9),
        Query("agg", "node", "degree", t_k=tc // 2, t_l=tc // 2 + 6, v=3,
              agg="mean"),
        Query("point", "global", "num_edges", t_k=tc // 2),
        Query("point", "global", "num_nodes", t_k=tc // 2),
        Query("point", "global", "density", t_k=tc // 2),
        Query("diff", "global", "num_edges", t_k=tc // 4, t_l=3 * tc // 4),
        Query("agg", "global", "num_edges", t_k=tc // 2, t_l=tc // 2 + 4,
              agg="max"),
    ]
    if avg:
        qs.append(Query("point", "global", "avg_degree", t_k=tc // 2))
    return qs


# ---------------------------------------------------------------------------
# Mesh plumbing
# ---------------------------------------------------------------------------


def test_shards_refuse_an_uneven_split(stores):
    """Row and slot blocks are cut only where the axis splits evenly:
    an uneven split raises instead of dropping the trailing rows or
    slots, and the planner then names the batch axis."""
    t, _ = stores
    mesh = cpu_mesh(5)
    with pytest.raises(ValueError, match="does not split over 5"):
        shard_rows(t.current, mesh)
    with pytest.raises(ValueError, match="does not split over 5"):
        shard_slots(t.current_edge_snapshot(), mesh)
    planner = t.engine().planner
    two_phase = type("Key", (), dict(plan="two_phase", kind="point",
                                     measure="num_edges", partial=False))
    for layout in ("dense", "edge"):
        two_phase.layout = layout
        assert planner.shard_mode(two_phase, 5) == "batch"
        assert planner.shard_mode(two_phase, 4) == (
            "rows" if layout == "dense" else "slots")
        assert planner.shard_mode(two_phase, 1) is None


def test_mesh_is_a_value_and_refuses_other_device_types(stores):
    a, b = cpu_mesh(4), graph_mesh([torch.device("cpu")] * 4)
    assert a == b and hash(a) == hash(b) and a != cpu_mesh(8)
    assert {a: 1}[b] == 1 and a.size == 4 and a.first.type == "cpu"
    t, _ = stores
    with pytest.raises(ValueError, match="cuda"):
        t.engine(mesh=graph_mesh(["cpu", "cuda:0"]))
    with pytest.raises(ValueError, match="shard mode"):
        t.engine().evaluate_many([Query("point", "global", "num_edges",
                                        t_k=3)], mesh=a, shard="always")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            graph_mesh()


def test_each_shard_is_a_tensor_of_its_own(stores):
    t, _ = stores
    mesh = cpu_mesh(4)
    rows = shard_rows(t.current, mesh)
    assert len(rows) == 4 and rows[1].adj.shape == (N // 4, N)
    assert torch.equal(torch.cat([r.adj for r in rows]), t.current.adj)
    ptrs = {r.adj.data_ptr() for r in rows} | {t.current.adj.data_ptr()}
    assert len(ptrs) == 5
    g = t.current_edge_snapshot()
    slots = shard_slots(g, mesh)
    assert torch.equal(torch.cat([s.emask for s in slots]), g.emask)
    assert all(torch.equal(s.nodes, g.nodes) for s in slots)
    assert {s.nodes.data_ptr() for s in slots} & {g.nodes.data_ptr()} == set()


# ---------------------------------------------------------------------------
# The distributed primitives (the reference's scripts/smoke_dist.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", MESHES)
def test_distributed_primitives(n_dev):
    """Row-parallel reconstruction, psum'd global measures and batched
    point degrees equal the single-device port and the JAX package."""
    params = dict(m_attach=3, lam_extra=1.0, lam_remove=1.0)
    t = build_store(64, EvolutionParams(**params), seed=3, device="cpu")
    j = j_build(64, JParams(**params), seed=3)
    mesh = cpu_mesh(n_dev)
    rows = shard_rows(t.current, mesh)
    d, jd = t.delta(), j.delta()
    tq = t.t_cur // 2
    g_t = D.dist_reconstruct(mesh, rows, d, t.t_cur, tq)
    ref = reconstruct_dense(t.current, d, t.t_cur, tq)
    jref = j_recon_dense(j.current, jd, j.t_cur, tq)
    eq(np.asarray(jref.adj), torch.cat([b.adj for b in g_t]))
    eq(np.asarray(jref.nodes), torch.cat([b.nodes for b in g_t]))
    eq(ref.adj.numpy(), torch.cat([b.adj for b in g_t]))
    eq(np.asarray(j.current.num_edges()), D.dist_num_edges(mesh, rows))
    eq(np.asarray(j.current.degrees()), D.dist_degrees(mesh, rows))
    eq(TQ.degree_distribution(t.current, 16).numpy(),
       D.dist_degree_distribution(mesh, rows, 16))
    eq(TQ.triangle_count(t.current).numpy(), D.dist_triangles(mesh, rows))
    vs = np.arange(0, 16, dtype=np.int32)
    ts = np.linspace(2, t.t_cur, 16).astype(np.int32)
    out = D.dist_batch_point_degree(mesh, rows, d, vs, ts, t.t_cur)
    for i in range(16):
        gg = j_recon_dense(j.current, jd, j.t_cur, int(ts[i]))
        assert int(out[i]) == int(gg.degree(int(vs[i]))), i


# ---------------------------------------------------------------------------
# Sharded evaluate_many: bit parity with one device, in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", MESHES)
def test_sharded_evaluate_many_bit_parity_all_plans(stores, n_dev):
    """Forced {two_phase, delta_only, hybrid} groups, every query kind,
    node + global scopes: sharded == single device == JAX, and the rows
    and batch modes engage."""
    t, j = stores
    tc = t.t_cur
    mesh = cpu_mesh(n_dev)
    eng = t.place_on_mesh(mesh)
    assert eng.mesh == mesh
    qs = (_mix(tc)[:3] + [Query("agg", "node", "degree", t_k=tc // 2,
                                t_l=tc // 2 + 6, v=3, agg="min")]
          + _mix(tc)[3:]
          + [Query("point", "node", "neighborhood2", t_k=tc // 3, v=5)]) * 3
    engaged = three_way(eng, j, qs, plan="two_phase", layout="dense")
    assert "rows" in engaged, eng.last_group_stats
    deg = [q for q in qs if q.scope == "node" and q.measure == "degree"]
    diffs = [q for q in deg if q.kind == "diff"]
    for plan, sub in (("hybrid", deg), ("delta_only", diffs)):
        assert three_way(eng, j, sub, plan=plan) == {"batch"}
    three_way(eng, j, qs)


@pytest.mark.parametrize("n_dev", MESHES)
def test_sharded_variants_and_anchors_bit_parity(n_dev):
    """Indexed / windowed / materialized-anchor groups keep bit parity
    under sharding, and ``shard="auto"`` keeps every group of a large
    auto-planned batch, and of a small one, on one device."""
    params = STREAM
    t = build_store(N, EvolutionParams(**params), seed=SEED, device="cpu")
    j = j_build(N, JParams(**params), seed=SEED)
    tc = t.t_cur
    t_mid = tc // 2
    t.materialized.add(t_mid, t.snapshot_at(t_mid, use_materialized=False))
    j.materialized.add(t_mid, j.snapshot_at(t_mid, use_materialized=False))
    mesh = cpu_mesh(n_dev)
    eng = t.engine(indexed=True, mesh=mesh)
    j.engine(indexed=True)
    rng = np.random.default_rng(3)
    big = []
    for i in range(192):
        v = int(rng.integers(0, 90))
        t1 = int(rng.integers(1, tc))
        t2 = min(tc, t1 + int(rng.integers(0, 6)))
        kind = ("point", "diff", "agg")[i % 3]
        big.append(Query(kind, "node", "degree", t_k=t1,
                         t_l=None if kind == "point" else t2, v=v))
    ref = eng.evaluate_many(big, shard="never")
    got = eng.evaluate_many(big)
    assert modes(eng) == {None}, eng.last_group_stats
    forced = eng.evaluate_many(big, shard="force")
    assert None not in modes(eng), eng.last_group_stats
    jax = j.engine(indexed=True).evaluate_many([jq(q) for q in big])
    for a, b, c, d in zip(got, ref, jax, forced):
        eq(c, a)
        eq(c, b)
        eq(c, d)
    for kw in (dict(plan="two_phase", windowed=True),
               dict(plan="hybrid", indexed=True),
               dict(plan="delta_only", indexed=True)):
        sub = [q for q in big[:48]
               if q.kind == "diff" or kw.get("plan") != "delta_only"]
        ref = eng.evaluate_many(sub, shard="never", **kw)
        got = eng.evaluate_many(sub, mesh=mesh, shard="force", **kw)
        assert None not in modes(eng)
        jax = j.engine(indexed=True).evaluate_many([jq(q) for q in sub],
                                                   **kw)
        for a, b, c in zip(got, ref, jax):
            eq(c, a)
            eq(c, b)
    eng.evaluate_many(big[:3], mesh=mesh)
    assert modes(eng) == {None}, eng.last_group_stats


@pytest.mark.parametrize("n_dev", MESHES)
def test_slot_sharded_edge_layout_bit_parity(stores, n_dev):
    """Edge-layout two-phase groups sharded over the SLOT axis equal the
    single-device edge path, the dense path and JAX, for every kind ×
    slot-decomposable measure; edge hybrid / delta-only batch-shard."""
    t, j = stores
    tc = t.t_cur
    mesh = cpu_mesh(n_dev)
    eng = t.place_on_mesh(mesh)
    qs = _mix(tc, avg=True) * 3
    dense = eng.evaluate_many(qs, plan="two_phase", layout="dense",
                              shard="never")
    assert three_way(eng, j, qs, plan="two_phase", layout="edge") \
        == {"slots"}
    assert all(k.layout == "edge" for k, *_ in eng.last_group_stats)
    for a, b in zip(eng.evaluate_many(qs, plan="two_phase", layout="edge",
                                      shard="force"), dense):
        eq(b, a)
    deg = [q for q in qs if q.scope == "node" and q.measure == "degree"]
    for plan, sub in (("hybrid", deg),
                      ("delta_only", [q for q in deg if q.kind == "diff"])):
        assert three_way(eng, j, sub, plan=plan, layout="edge") == {"batch"}


@pytest.mark.parametrize("n_dev", MESHES)
def test_sharded_evolve_sweep_bit_parity(stores, n_dev):
    """Evolve groups: the slot-sharded sweep (the start state's integer
    partials summed, then B4 once) and the batch-sharded dense sweep
    equal the single-device sweep and JAX, which equal point queries."""
    t, j = stores
    tc = t.t_cur
    mesh = cpu_mesh(n_dev)
    eng = t.place_on_mesh(mesh)
    qs = [
        Query("evolve", "node", "degree", t_k=2, t_l=tc, v=5, stride=1),
        Query("evolve", "global", "num_edges", t_k=2, t_l=tc, stride=1),
        Query("evolve", "global", "density", t_k=3, t_l=tc - 1, stride=2),
        Query("evolve", "global", "avg_degree", t_k=2, t_l=tc, stride=1),
        Query("evolve", "global", "degree_distribution", t_k=2, t_l=tc,
              stride=3),
    ] * 2
    ref = eng.evaluate_many(qs, layout="edge", shard="never")
    for q, r in zip(qs[:5], ref[:5]):
        ts = list(range(q.t_k, q.t_l + 1, q.stride))
        pts = eng.evaluate_many(
            [Query("point", q.scope, q.measure, t_k=t_, v=q.v) for t_ in ts],
            layout="edge", shard="never")
        eq(np.stack(pts), r)
    assert three_way(eng, j, qs, layout="edge") == {"slots"}
    assert three_way(eng, j, qs, layout="dense") == {"batch"}


@pytest.mark.parametrize("n_dev", MESHES)
def test_live_serving_sharded_bit_parity(n_dev):
    """With ingest interleaved, every query at t ≤ t_served on a
    mesh-bound LiveGraphStore (sharded groups engaged) equals a
    from-scratch single-device store of the ops absorbed so far, and
    the JAX package's, at every watermark."""
    ops = generate_ops(N, JParams(**STREAM), seed=SEED)
    t_max = ops[-1].t
    cuts = [next(i for i, o in enumerate(ops) if o.t > t_max // frac)
            for frac in (3, 2)] + [len(ops)]
    live = LiveGraphStore(n_cap=N, mesh=cpu_mesh(n_dev), device="cpu")
    rng = np.random.default_rng(0)
    engaged, lo = set(), 0
    for cut in cuts:
        live.append([(o.op, o.u, o.v, o.t) for o in ops[lo:cut]])
        lo = cut
        live.swap()
        w = live.t_served
        qs = []
        for _ in range(24):
            t1 = int(rng.integers(1, w))
            v = int(rng.integers(0, N))
            t2 = min(w, t1 + int(rng.integers(0, 6)))
            qs += [Query("point", "node", "degree", t_k=t1, v=v),
                   Query("diff", "node", "degree", t_k=t1, t_l=t2, v=v),
                   Query("point", "global", "num_edges", t_k=t1),
                   Query("point", "global", "degree_distribution", t_k=t1)]
        got = live.evaluate_many(qs, shard="force")
        engaged |= modes(live.engine)
        oracle = TemporalGraphStore(N, device="cpu")
        oracle.ingest([(o.op, o.u, o.v, o.t) for o in ops[:cut]])
        oracle.advance_to(w)
        joracle = JStore(N)
        joracle.ingest(ops[:cut])
        joracle.advance_to(w)
        jax = joracle.evaluate_many([jq(q) for q in qs])
        for a, b, c in zip(got, oracle.evaluate_many(qs, shard="never"),
                           jax):
            eq(c, a)
            eq(c, b)
    assert engaged and None not in engaged, engaged


@pytest.mark.parametrize("n_dev", MESHES)
def test_segmented_vs_monolithic_sharded_bit_parity(n_dev):
    """A fragmented segmented store serving through forced-sharded
    groups equals a monolithic single-device store (and JAX's) over the
    same op stream — rows, slots and batch modes all engaged."""
    ops = generate_ops(N, JParams(**STREAM), seed=SEED)
    t_max = max(o.t for o in ops)
    cuts = [i * len(ops) // 4 for i in (1, 2, 3)] + [len(ops)]
    seg = TemporalGraphStore(N, segment_min_ops=8, device="cpu")
    mono = TemporalGraphStore(N, segmented=False, device="cpu")
    jmono = JStore(N, segmented=False)
    lo = 0
    for cut in cuts:
        t_adv = (t_max if cut == len(ops)
                 else max(o.t for o in ops[:cut]) - 1)
        chunk = [(o.op, o.u, o.v, o.t) for o in ops[lo:cut]]
        for s in (seg, mono, jmono):
            s.ingest(chunk)
            s.advance_to(max(t_adv, s.t_cur))
        seg.freeze_serving_state()
        lo = cut
    assert len(seg.delta_view().segments) >= 3
    tc = seg.t_cur
    mesh = cpu_mesh(n_dev)
    eng = seg.place_on_mesh(mesh)
    qs = _mix(tc) * 3
    engaged = set()

    def check(sub, **kw):
        got = eng.evaluate_many(sub, mesh=mesh, shard="force", **kw)
        engaged.update(modes(eng))
        ref = mono.evaluate_many(sub, shard="never", **kw)
        jax = jmono.evaluate_many([jq(q) for q in sub], **kw)
        for a, b, c in zip(got, ref, jax):
            eq(c, a)
            eq(c, b)

    for kw in (dict(plan="two_phase", layout="dense"),
               dict(plan="two_phase", layout="edge"), dict()):
        check(qs, **kw)
    deg = [q for q in qs if q.scope == "node" and q.measure == "degree"]
    check(deg, plan="hybrid")
    check([q for q in deg if q.kind == "diff"], plan="delta_only")
    assert {"rows", "slots", "batch"} <= engaged, engaged


# ---------------------------------------------------------------------------
# The block glue of B1 and B2 (the contract the row / slot meshes rely on)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kstores():
    """``tests/test_kernels.py``'s store (90 nodes, n_cap 128, seed 5) in
    both packages."""
    params = dict(m_attach=3, lam_extra=1.0, lam_remove=1.5,
                  p_remove_node=0.02)
    t = build_store(90, EvolutionParams(**params), seed=5, n_cap=128,
                    device="cpu")
    j = j_build(90, JParams(**params), seed=5, n_cap=128)
    return t, j


def _row_blocks(t, splits, tq):
    d = t.delta()
    nodes, adjs = [], []
    for row0, r in splits:
        nb, ab = delta_apply_row_block(
            t.current.nodes[row0:row0 + r], t.current.adj[row0:row0 + r], d,
            as_times([t.t_cur], None, "cpu"), as_times([tq], None, "cpu"),
            row0)
        nodes.append(nb[0])
        adjs.append(ab[0])
    return torch.cat(nodes), torch.cat(adjs)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_row_blocks_concatenate_to_full(kstores, n_shards):
    t, j = kstores
    rb = t.n_cap // n_shards
    for tq in [0, t.t_cur // 2]:
        nodes, adj = _row_blocks(t, [(r0, rb) for r0 in
                                     range(0, t.n_cap, rb)], tq)
        whole = reconstruct_dense(t.current, t.delta(), t.t_cur, tq)
        jref = j_recon_dense(j.current, j.delta(), j.t_cur, tq)
        eq(np.asarray(jref.adj), adj)
        eq(np.asarray(jref.nodes), nodes)
        eq(whole.adj.numpy(), adj)


def test_row_block_pad_band_excludes_next_shard(kstores):
    """A block of 48 rows pads to 64 (its last tile row): 30 ops on row
    50, the next block's, must bucket nothing into this block, and a
    non-uniform split (48, 80) must still stitch exactly — also 125-row
    blocks of N = 1000 over 8 shards."""
    k = 30
    d50 = delta_from_numpy(np.full(k, 2, np.int32), np.full(k, 50, np.int32),
                           np.arange(64, 64 + k, dtype=np.int32),
                           np.zeros(k, np.int32),
                           np.arange(1, k + 1, dtype=np.int32),
                           device="cpu")
    ent, tst = bucket_ops(d50, 128, 0, k, row0=0, n_rows=48)
    assert ent.shape[0] == 0 and tst.numel() == 1 * 2 + 1
    # the second block holds both mirrors: row 50 and rows 64..93
    ent, tst = bucket_ops(d50, 128, 0, k, row0=48, n_rows=80)
    assert ent.shape[0] == 2 * k and tst.numel() == 2 * 2 + 1
    t, j = kstores
    tq = t.t_cur // 2
    nodes, adj = _row_blocks(t, [(0, 48), (48, 80)], tq)
    jref = j_recon_dense(j.current, j.delta(), j.t_cur, tq)
    eq(np.asarray(jref.adj), adj)
    eq(np.asarray(jref.nodes), nodes)
    # N = 1000 over 8 shards: 125 rows a block
    big = build_store(900, EvolutionParams(m_attach=2), seed=4, n_cap=1000,
                      device="cpu")
    nodes, adj = _row_blocks(big, [(r0, 125) for r0 in range(0, 1000, 125)],
                             big.t_cur // 3)
    whole = reconstruct_dense(big.current, big.delta(), big.t_cur,
                              big.t_cur // 3)
    eq(whole.adj.numpy(), adj)
    eq(whole.nodes.numpy(), nodes)


def _slot_blocks(t, splits, tq):
    cur = t.current_edge_snapshot()
    d = t.delta()
    masks = []
    for slot0, w in splits:
        nb, em = edge_delta_apply_slot_block(
            cur.nodes, cur.emask[slot0:slot0 + w], d,
            as_times([t.t_cur], None, "cpu"), as_times([tq], None, "cpu"),
            slot0)
        masks.append(em[0])
    return nb[0], torch.cat(masks)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_slot_blocks_concatenate_to_full(kstores, n_shards):
    t, j = kstores
    e = t.current_edge_snapshot().e_cap
    w = e // n_shards
    jcur = j.current_edge_snapshot()
    for tq in [0, t.t_cur // 2]:
        nodes, emask = _slot_blocks(t, [(s0, w) for s0 in range(0, e, w)],
                                    tq)
        whole = reconstruct_edge(t.current_edge_snapshot(), t.delta(),
                                 t.t_cur, tq)
        jref = j_recon_edge(jcur, j.delta(), j.t_cur, tq)
        eq(np.asarray(jref.emask), emask)
        eq(np.asarray(jref.nodes), nodes)
        eq(whole.emask.numpy(), emask)


def test_slot_block_pad_band_excludes_next_shard(kstores):
    """30 ops on slot 50 belong to the second block of a (48, rest)
    split: the first block (its pad band 48..511) buckets none, and the
    non-uniform split stitches exactly; the entries of a block stay in
    (tile, time) order, so positions order one slot's ops as ranks do."""
    k = 30
    d50 = delta_from_numpy(np.full(k, 2, np.int32), np.zeros(k, np.int32),
                           np.arange(1, k + 1, dtype=np.int32),
                           np.full(k, 50, np.int32),
                           np.arange(1, k + 1, dtype=np.int32),
                           device="cpu")
    ent, tst = bucket_slot_ops(d50, 48, 0, k, slot0=0)
    assert ent.shape[0] == 0 and tst.tolist() == [0, 0]
    ent, tst = bucket_slot_ops(d50, 64, 0, k, slot0=48)
    assert ent.shape[0] == k and bool((ent[:, 1] >> 1 == 2).all())
    assert bool((ent[1:, 0] >= ent[:-1, 0]).all())
    t, j = kstores
    e = t.current_edge_snapshot().e_cap
    tq = t.t_cur // 2
    nodes, emask = _slot_blocks(t, [(0, 48), (48, e - 48)], tq)
    jref = j_recon_edge(j.current_edge_snapshot(), j.delta(), j.t_cur, tq)
    eq(np.asarray(jref.emask), emask)
    eq(np.asarray(jref.nodes), nodes)


# ---------------------------------------------------------------------------
# The session surface: GraphSession(mesh=), open_replica(mesh=), durability
# ---------------------------------------------------------------------------


def _session_ops():
    from repro_torch.core.generate import generate_ops as t_gen
    ops = t_gen(N, EvolutionParams(**STREAM), seed=SEED)
    t_max = ops[-1].t
    return [[(o.op, o.u, o.v, o.t) for o in ops
             if t_max * i // 3 < o.t <= t_max * (i + 1) // 3]
            for i in range(3)]


def _session_queries(tc):
    return [Query(**q) for q in (
        dict(kind="point", scope="node", measure="degree", t_k=tc // 3, v=5),
        dict(kind="diff", scope="node", measure="degree", t_k=tc // 4,
             t_l=3 * tc // 4, v=9),
        dict(kind="point", scope="global", measure="num_edges", t_k=tc // 2),
        dict(kind="agg", scope="global", measure="density", t_k=tc // 2,
             t_l=tc // 2 + 3, agg="mean"),
        dict(kind="point", scope="global", measure="degree_distribution",
             t_k=tc // 2))]


def _root_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_session_and_replica_mesh_answer_like_unmeshed(tmp_path, layout):
    """A durable ``GraphSession(mesh=)`` answers (forced sharded, auto,
    sweep, snapshot) like an unmeshed one and writes the same root bytes;
    ``open_replica(mesh=)`` on its root answers like an unmeshed replica."""
    mesh = cpu_mesh(4)
    sessions = {name: GraphSession(path=str(tmp_path / name), n_cap=N,
                                   e_cap=1024 if layout == "edge" else None,
                                   layout=layout, device="cpu",
                                   mesh=m, fsync=False)
                for name, m in (("plain", None), ("meshed", mesh))}
    for batch in _session_ops():
        for s in sessions.values():
            s.ingest(batch)
            s.flush()
    plain, meshed = sessions["plain"], sessions["meshed"]
    tc = plain.watermark
    qs = _session_queries(tc)
    for a, b in zip(meshed.live.evaluate_many(qs, shard="force"),
                    plain.live.evaluate_many(qs)):
        eq(b, a)
    assert None not in modes(meshed.live.engine)
    for a, b in zip(meshed.query_many(qs), plain.query_many(qs)):
        eq(b, a)
    eq(plain.sweep("num_edges", 2, tc, stride=3),
       meshed.sweep("num_edges", 2, tc, stride=3))
    g_a, g_b = plain.snapshot_at(tc // 2), meshed.snapshot_at(tc // 2)
    eq(g_a.nodes.numpy(), g_b.nodes)
    reps = {name: GraphSession.open_replica(
        str(tmp_path / "plain"), str(tmp_path / f"mirror_{name}"),
        device="cpu", mesh=m) for name, m in (("plain", None),
                                               ("meshed", mesh))}
    assert reps["meshed"]._engine.mesh == mesh
    for a, b in zip(reps["meshed"].evaluate_many(qs, shard="force"),
                    reps["plain"].evaluate_many(qs)):
        eq(b, a)
    assert None not in modes(reps["meshed"]._engine)
    for s in sessions.values():
        s.close()
    assert _root_bytes(str(tmp_path / "plain")) \
        == _root_bytes(str(tmp_path / "meshed"))
