"""The port's reconstruction layer against ``repro.core.reconstruct``:
dense LWW forward and backward (and partial rows), edge-slot LWW, the
paper's sequential replay, the degree series — plus each kernel's plain
version against the JAX oracle ``ref.py`` and the jnp ``bucket_*``
glue.  Inputs come from ``repro.core.generate`` (numpy seeds) and go
through both packages; ints and bools must be bit-exact.

The Pallas kernels themselves do not run under this jax (ROADMAP C1),
so the JAX side is always the XLA form or the jnp reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import reconstruct as R  # noqa: E402
from repro.core.generate import EvolutionParams, build_store  # noqa: E402
from repro.kernels.degree_series.ops import bucket_node_events as j_bne  # noqa: E402,E501
from repro.kernels.degree_series.ref import degree_series_ref as j_dsr  # noqa: E402,E501
from repro.kernels.delta_apply.ops import bucket_ops as j_bucket_ops  # noqa: E402
from repro.kernels.delta_apply.ref import delta_apply_ref as j_dar  # noqa: E402
from repro.kernels.edge_delta_apply.ops import bucket_slot_ops as j_bso  # noqa: E402,E501
from repro.kernels.edge_delta_apply.ref import edge_delta_apply_ref as j_ear  # noqa: E402,E501
from repro_torch.core import reconstruct as TR  # noqa: E402
from repro_torch.core.delta import delta_from_numpy  # noqa: E402
from repro_torch.core.graph import DenseGraph, EdgeGraph  # noqa: E402
from repro_torch.kernels import degree_series as DS  # noqa: E402
from repro_torch.kernels import delta_apply as DA  # noqa: E402
from repro_torch.kernels import edge_delta_apply as EA  # noqa: E402
from repro_torch.kernels.evolve_sweep import bucket_sweep_events  # noqa: E402,E501

PARAMS = EvolutionParams(m_attach=3, lam_extra=1.0, lam_remove=1.5,
                         p_remove_node=0.03, events_per_unit=5)


def port_delta(d):
    """A ``repro`` Delta as the port's (CPU) Delta, same capacity."""
    n = int(d.n_ops)
    cols = [np.asarray(getattr(d, c))[:n]
            for c in ("op", "u", "v", "slot", "t")]
    return delta_from_numpy(*cols, capacity=d.capacity, device="cpu")


def port_graph(g):
    """A ``repro`` DenseGraph / EdgeGraph as the port's (CPU) one."""
    def t(x):
        return torch.from_numpy(np.array(x))
    if hasattr(g, "adj"):
        return DenseGraph(nodes=t(g.nodes), adj=t(g.adj))
    return EdgeGraph(nodes=t(g.nodes), eu=t(g.eu), ev=t(g.ev),
                     emask=t(g.emask), n_edges_reg=int(g.n_edges_reg))


def eq(a, b):
    """Bit-exact: same dtype, shape and bits (floats compared as their
    integer bit patterns, so -0.0 != 0.0)."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def hist():
    st = build_store(48, PARAMS, seed=1, n_cap=64)
    return st, st.delta(), port_delta(st.delta())


def _times(st):
    return sorted({0, 1, st.t_cur // 4, st.t_cur // 2, 3 * st.t_cur // 4,
                   st.t_cur - 1, st.t_cur})


@pytest.mark.parametrize("anchor_frac", [1.0, 0.5, 0.0])
def test_reconstruct_dense_both_directions(hist, anchor_frac):
    st, d, td = hist
    t_a = int(st.t_cur * anchor_frac)
    g_a = R.reconstruct_dense(st.current, d, st.t_cur, t_a)
    tg_a = TR.reconstruct_dense(port_graph(st.current), td, st.t_cur, t_a)
    eq(g_a.adj, tg_a.adj)
    for tq in _times(st):        # forward and backward from the anchor
        a = R.reconstruct_dense(g_a, d, t_a, tq)
        b = TR.reconstruct_dense(tg_a, td, t_a, tq)
        eq(a.adj, b.adj)
        eq(a.nodes, b.nodes)


def test_reconstruct_dense_restrict_rows(hist):
    st, d, td = hist
    rng = np.random.default_rng(0)
    cur, tcur = st.current, port_graph(st.current)
    for tq in _times(st):
        rm = np.zeros(64, bool)
        rm[rng.integers(0, 48, size=3)] = True
        a = R.reconstruct_dense(cur, d, st.t_cur, tq,
                                row_mask=jnp.asarray(rm), restrict_rows=True)
        b = TR.reconstruct_dense(tcur, td, st.t_cur, tq,
                                 row_mask=torch.from_numpy(rm),
                                 restrict_rows=True)
        eq(a.adj, b.adj)
        eq(a.nodes, b.nodes)


def test_reconstruct_dense_many_equals_single(hist):
    st, _, td = hist
    tcur = port_graph(st.current)
    ts = _times(st)
    many = TR.reconstruct_dense_many(tcur, td, st.t_cur, ts)
    for i, t in enumerate(ts):
        one = TR.reconstruct_dense(tcur, td, st.t_cur, t)
        assert torch.equal(many.adj[i], one.adj)
        assert torch.equal(many.nodes[i], one.nodes)


def test_reconstruct_edge(hist):
    st, d, td = hist
    ec = st.current_edge_snapshot()
    tec = port_graph(ec)
    for tq in _times(st):
        a = R.reconstruct_edge(ec, d, st.t_cur, tq)
        b = TR.reconstruct_edge(tec, td, st.t_cur, tq)
        eq(a.emask, b.emask)
        eq(a.nodes, b.nodes)
        # and forward again from that snapshot
        a2 = R.reconstruct_edge(a, d, tq, st.t_cur // 2)
        b2 = TR.reconstruct_edge(b, td, tq, st.t_cur // 2)
        eq(a2.emask, b2.emask)


@pytest.mark.parametrize("t_anchor_frac", [1.0, 0.0])
def test_reconstruct_sequential(hist, t_anchor_frac):
    st, d, td = hist
    t_a = int(st.t_cur * t_anchor_frac)
    g_a = R.reconstruct_dense(st.current, d, st.t_cur, t_a)
    tg_a = port_graph(g_a)
    for tq in _times(st)[::2]:
        a = R.reconstruct_sequential(g_a, d, t_a, tq)
        b = TR.reconstruct_sequential(tg_a, td, t_a, tq)
        eq(a.adj, b.adj)
        eq(a.nodes, b.nodes)


@pytest.mark.parametrize("num_buckets", [1, 7, 16])
def test_degree_series(hist, num_buckets):
    st, d, td = hist
    tcur = port_graph(st.current)
    for t_k in (1, st.t_cur // 3, st.t_cur - 2):
        a = R.degree_series(st.current, d, t_k, t_k + num_buckets - 1,
                            num_buckets, st.t_cur)
        b = TR.degree_series(tcur, td, t_k, t_k + num_buckets - 1,
                             num_buckets, st.t_cur)
        eq(a, b)


def test_degree_series_on_edge_layout(hist):
    st, d, td = hist
    ec = st.current_edge_snapshot()
    a = R.degree_series(ec, d, 3, 10, 8, st.t_cur)
    b = TR.degree_series(port_graph(ec), td, 3, 10, 8, st.t_cur)
    eq(a, b)


def test_node_degree_series(hist):
    st, d, td = hist
    for v in (0, 5, 17):
        for t_k in (0, st.t_cur // 2):
            a = R.node_degree_series(st.current.degree(v), d, v, t_k, 8)
            b = TR.node_degree_series(int(st.current.degree(v)), td, v,
                                      t_k, 8)
            eq(a, b)


# ---------------------------------------------------------------------------
# Kernel plain versions vs the JAX oracle ref.py and the jnp bucket glue
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide():
    """A store whose node count spans several dense tiles (TILE = 64)."""
    st = build_store(100, PARAMS, seed=2, n_cap=128)
    return st, st.delta(), port_delta(st.delta())


def test_delta_apply_ref_matches_jax_ref(wide):
    st, d, td = wide
    cur = port_graph(st.current)
    ts = [0, st.t_cur // 3, st.t_cur // 2, st.t_cur]
    ents, starts = DA.bucket_ops(td, st.n_cap)
    ta = torch.full((len(ts),), st.t_cur, dtype=torch.int32)
    out = DA.delta_apply_ref(cur.adj, ents, starts, ta,
                             torch.tensor(ts, dtype=torch.int32), None,
                             DA.TILE)
    for i, t in enumerate(ts):
        eq(j_dar(st.current, d, st.t_cur, t).adj, out[i])
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(DA.delta_apply(cur.adj, ents, starts, ta,
                                      torch.tensor(ts, dtype=torch.int32)),
                       out)


@pytest.mark.parametrize("forward", [True, False])
def test_bucket_ops_matches_jax_glue(wide, forward):
    """Per tile, the port's in-window entries in rank order are exactly
    the jnp glue's block entries (ascending time forward, descending
    backward), with the value the TPU kernel would write."""
    st, d, td = wide
    n, tile = st.n_cap, DA.TILE
    t_lo, t_hi = st.t_cur // 4, 3 * st.t_cur // 4
    blocks, overflow = j_bucket_ops(d, n, t_lo, t_hi, tile, 512, forward)
    assert not bool(overflow)
    blocks = np.asarray(blocks)
    ents, starts = DA.bucket_ops(td, n, t_lo, t_hi)
    ents, starts = ents.numpy(), starts.numpy()
    tc = n // tile
    for tid in range(tc * tc):
        mine = ents[starts[tid]:starts[tid + 1]]
        if not forward:      # descending rank, mirror still second
            mine = mine[np.argsort(-(mine[:, 2] >> 1), kind="stable")]
        cell, key = mine[:, 0], mine[:, 2]
        val = (key & 1) if forward else 1 - (key & 1)
        got = np.stack([cell // tile, cell % tile, val], 1)
        blk = blocks[tid // tc, tid % tc]
        want = blk[blk[:, 3] > 0][:, :3]
        assert np.array_equal(got, want), tid


@pytest.fixture(scope="module")
def ragged():
    """N = 100: neither a multiple of the tile (64) nor of 16, so the
    last tiles are partial and rows are not 16-byte aligned."""
    st = build_store(90, PARAMS, seed=3, n_cap=100)
    return st, st.delta(), port_delta(st.delta())


@pytest.mark.parametrize("masked", [False, True])
def test_delta_apply_ref_ragged_per_query_anchor_matches_jax(ragged,
                                                             masked):
    """One batched call with a per-query [Q, N, N] anchor, windows both
    ways and (optionally) a per-query row_mask — the paths B1 takes
    besides its main one — against JAX's reconstruction of each query
    from its own anchor."""
    st, d, td = ragged
    n, tc = st.n_cap, st.t_cur
    t_a = [tc // 2, tc // 2, tc // 4, tc]
    t_q = [tc // 5, 3 * tc // 4, tc // 4, 1]      # back, fwd, empty, back
    anchors = [R.reconstruct_dense(st.current, d, tc, t) for t in t_a]
    rng = np.random.default_rng(5)
    rms = rng.random((len(t_a), n)) < 0.1
    rm = torch.from_numpy(rms) if masked else None
    ents, starts = DA.bucket_ops(td, n, 1, tc)
    out = DA.delta_apply_ref(
        torch.stack([port_graph(a).adj for a in anchors]), ents, starts,
        torch.tensor(t_a, dtype=torch.int32),
        torch.tensor(t_q, dtype=torch.int32), rm, DA.TILE)
    for i, (a, ta, tq) in enumerate(zip(anchors, t_a, t_q)):
        kw = (dict(row_mask=jnp.asarray(rms[i]), restrict_rows=True)
              if masked else {})
        eq(R.reconstruct_dense(a, d, ta, tq, **kw).adj, out[i])


def test_edge_delta_apply_ref_matches_jax(hist):
    st, d, td = hist
    ec = st.current_edge_snapshot()
    tec = port_graph(ec)
    ts = [0, st.t_cur // 2, st.t_cur]
    ents, starts = EA.bucket_slot_ops(td, tec.e_cap)
    out = EA.edge_delta_apply_ref(
        tec.emask, ents, starts,
        torch.full((3,), st.t_cur, dtype=torch.int32),
        torch.tensor(ts, dtype=torch.int32), EA.TILE)
    for i, t in enumerate(ts):
        eq(j_ear(ec, d, st.t_cur, t).emask, out[i])
    # glue: one tile (E = TILE) — the entries [t, local slot·2 + is_add]
    # in rank order == the jnp blocks' [local slot, is_add] rows, and
    # their times are the window's ops' times in delta order
    t_lo, t_hi = 2, st.t_cur - 3
    blocks, overflow = j_bso(d, EA.TILE, t_lo, t_hi, EA.TILE, 2048, True)
    assert not bool(overflow)
    blk = np.asarray(blocks)[0]
    ents, starts = EA.bucket_slot_ops(td, EA.TILE, t_lo, t_hi)
    ents = ents.numpy()
    got = np.stack([ents[:, 1] >> 1, ents[:, 1] & 1], 1)
    assert np.array_equal(got, blk[blk[:, 2] > 0][:, :2])
    dt, dslot = np.asarray(d.t), np.asarray(d.slot)
    win = ((dt > t_lo) & (dt <= t_hi) & (dslot < EA.TILE)
           & np.asarray(d.is_edge_op() & d.valid_mask()))
    assert np.array_equal(ents[:, 0], dt[win])
    assert list(starts.numpy()) == [0, len(ents)]


@pytest.fixture(scope="module")
def slots():
    """A store whose slot registry spans several 512-slot tiles (more
    than one block of eight)."""
    st = build_store(1200, PARAMS, seed=6, n_cap=1280)
    ec = st.current_edge_snapshot()
    assert ec.e_cap > 8 * EA.TILE
    return st, st.delta(), port_delta(st.delta()), ec


def _edge_kernel_model(anchor, ents, starts, t_a, t_q, e):
    """edge_delta_apply.cu warp by warp, in numpy: each 512-slot tile is
    one warp's, its entries ordered by time, and for every query the
    warp finds the run [a, b) of its tile's entries in the window by two
    searches on t; with an empty run it writes the anchor, else it
    keeps, per slot, the max (forward) or min (backward) positional key
    2·j + is_add of the run and writes the key's add bit (forward) or
    its complement (backward) where a key was kept.  ``anchor`` is [E]
    or [Q, E]."""
    q, tile = len(t_q), EA.TILE
    anchors = np.broadcast_to(anchor, (q, e))
    out = np.zeros((q, e), bool)
    for w in range(len(starts) - 1):
        j0, j1 = starts[w], starts[w + 1]
        t, code = ents[j0:j1, 0], ents[j0:j1, 1]
        key = 2 * np.arange(j0, j1) + (code & 1)
        cols = slice(w * tile, min(e, (w + 1) * tile))
        for qi in range(q):
            word = anchors[qi, cols].copy()
            fwd = t_q[qi] >= t_a[qi]
            lo, hi = min(t_a[qi], t_q[qi]), max(t_a[qi], t_q[qi])
            assert np.all(t[1:] >= t[:-1])                # time order
            a, b = np.searchsorted(t, [lo, hi], side="right")
            hit = np.zeros(t.size, bool)
            hit[a:b] = True                               # the run
            assert np.array_equal(hit, (t > lo) & (t <= hi))
            if a < b:
                init = -1 if fwd else 2 ** 31 - 1
                dec = np.full(tile, init, np.int64)
                (np.maximum if fwd else np.minimum).at(
                    dec, code[hit] >> 1, key[hit])
                dec = dec[:word.size]
                val = (dec & 1) == (1 if fwd else 0)
                word = np.where(dec != init, val, word)
            out[qi, cols] = word
    return out


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared-anchor", "per-query-anchors"])
@pytest.mark.parametrize("ragged", [False, True])
def test_edge_kernel_model_matches_jax(slots, shared, ragged):
    """B2's blocking — one pass per warp tile serving every query of the
    launch, forward and backward windows mixed, keys by position in the
    bucketed array, a shared or per-query anchor, E ragged or not —
    equals JAX's reconstruction of each query from its own anchor: the
    record of why positional keys decide LWW as ranks do.  It models
    edge_delta_apply.cu and does not run it; chip_smoke.py holds the
    CUDA code itself bit for bit."""
    st, d, td, ec = slots
    tc = st.t_cur
    e = ec.e_cap - 37 if ragged else ec.e_cap       # 37: not a multiple
    if shared:                                      # of 16 or the tile
        t_a = [tc // 2] * 4
    else:
        t_a = [tc // 2, tc // 3, tc, tc // 4]
    t_q = [tc // 5, 3 * tc // 4, 1, tc // 4]       # back/fwd/back/empty
    anchors = [R.reconstruct_edge(ec, d, tc, t) for t in sorted(set(t_a))]
    by_t = dict(zip(sorted(set(t_a)), anchors))
    a_np = np.stack([np.asarray(by_t[t].emask)[:e] for t in t_a])
    ents, starts = EA.bucket_slot_ops(td, e, 1, tc)
    ents, starts = ents.numpy().astype(np.int64), starts.numpy()
    assert len(starts) - 1 == -(-e // EA.TILE)
    got = _edge_kernel_model(a_np[0] if shared else a_np, ents, starts,
                             t_a, t_q, e)
    for i, (ta, tq) in enumerate(zip(t_a, t_q)):
        eq(np.asarray(R.reconstruct_edge(by_t[ta], d, ta, tq).emask)[:e],
           got[i])
    # the plain version reads the same entries the same way
    anchor_t = torch.from_numpy(a_np[0] if shared else a_np)
    plain = EA.edge_delta_apply_ref(
        anchor_t, torch.from_numpy(ents.astype(np.int32)),
        torch.from_numpy(starts), torch.tensor(t_a, dtype=torch.int32),
        torch.tensor(t_q, dtype=torch.int32), EA.TILE)
    eq(got, plain)


def test_degree_series_ref_matches_jax(hist):
    st, d, td = hist
    tcur = port_graph(st.current)
    t_k, nb = st.t_cur // 3, 8
    ev, starts = bucket_sweep_events(td, tcur.n_cap, t_k)
    out = DS.degree_series_ref(tcur.degrees(), ev, starts, t_k, nb, DS.TILE)
    eq(j_dsr(st.current, d, t_k, st.t_cur, nb), out)
    # glue: the sweep's events [t, local node·2 + is_add] with no upper
    # bound, their bucket min(t − t_k, B) computed as the kernel does,
    # give the jnp events [node, bucket, sign] of the (single) node
    # tile, in the same order
    blocks, overflow = j_bne(d, DS.TILE, t_k, nb, DS.TILE, 2048)
    assert not bool(overflow)
    blk = np.asarray(blocks)[0]
    e = ev.numpy()
    got = np.stack([e[:, 1] >> 1, np.minimum(e[:, 0] - t_k, nb),
                    (e[:, 1] & 1) * 2 - 1], 1)
    assert np.array_equal(got, blk[blk[:, 3] > 0][:, :3])


# ---------------------------------------------------------------------------
# Delta helpers and the delta indexes (temporal and node-centric)
# ---------------------------------------------------------------------------


def _eq_delta(a, b):
    for c in ("op", "u", "v", "slot", "t"):
        eq(getattr(a, c), getattr(b, c))
    assert int(a.n_ops) == b.n_ops


def test_delta_helpers(hist):
    from repro.core import delta as JD
    from repro_torch.core import delta as TD
    st, d, td = hist
    _eq_delta(JD.slice_delta(d, 5, 20), TD.slice_delta(td, 5, 20))
    _eq_delta(JD.slice_delta(d, 900, 901), TD.slice_delta(td, 900, 901))
    _eq_delta(JD.concat_deltas(JD.slice_delta(d, 0, 10),
                               JD.slice_delta(d, 10, 30)),
              TD.concat_deltas(TD.slice_delta(td, 0, 10),
                               TD.slice_delta(td, 10, 30)))
    _eq_delta(d.invert(), td.invert())
    eq(d.window_mask(3, 17) & d.valid_mask(),
       td.window_mask(3, 17) & td.valid_mask())
    assert [JD.pow2_capacity(n, 4) for n in (0, 1, 5, 64, 65)] == \
        [TD.pow2_capacity(n, 4) for n in (0, 1, 5, 64, 65)]


def test_indexes(hist):
    from repro.core import index as JI
    from repro_torch.core import index as TI
    st, d, td = hist
    ji = JI.build_node_index(d, st.n_cap)
    for ti in (TI.build_node_index(td, st.n_cap),
               TI.build_node_index_host(td, st.n_cap)):
        eq(ji.row_ptr, ti.row_ptr)
        eq(ji.op_idx, ti.op_idx)
    for lo, hi in ((0, 10), (7, st.t_cur), (st.t_cur - 3, st.t_cur)):
        assert int(JI.count_window_ops(d, lo, hi)) == \
            TI.count_window_ops(td, lo, hi)
        _eq_delta(JI.gather_window(d, lo, hi, 128),
                  TI.gather_window(td, lo, hi, 128))
    ti = TI.build_node_index(td, st.n_cap)
    for v in (0, 5, 33):
        _eq_delta(JI.gather_node_ops(d, ji, v, 32),
                  TI.gather_node_ops(td, ti, v, 32))


@pytest.mark.parametrize("cap", [4, 32])
def test_gather_nodes_ops_rows_match_jax(hist, cap):
    """The batched on-device gather: row b of the [B, cap] sub-delta is
    JAX's ``gather_node_ops`` of node vs[b], for nodes over the cap,
    within it and with no ops at all."""
    from repro.core import index as JI
    from repro_torch.core import index as TI
    st, d, td = hist
    ji = JI.build_node_index(d, st.n_cap)
    ti = TI.build_node_index(td, st.n_cap)
    counts = np.diff(np.asarray(ji.row_ptr))
    vs = np.asarray([0, 5, 33, int(counts.argmax()), int(counts.argmin()),
                     5], np.int32)
    assert counts[vs].max() > cap and counts[vs].min() < cap
    got = TI.gather_nodes_ops(td, ti, vs, cap)
    assert got.n_ops == cap and got.capacity == cap
    for b, v in enumerate(vs):
        want = JI.gather_node_ops(d, ji, int(v), cap)
        for c in ("op", "u", "v", "slot", "t"):
            eq(getattr(want, c), getattr(got, c)[b])
