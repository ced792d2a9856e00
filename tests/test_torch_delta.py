"""Delta invariants on the port — the counterparts of
``tests/test_delta.py`` (Definitions 2–5, Lemma 1, Theorem 1, the
store's closed-time-unit rules) — plus ``reconstruct_at`` on both
layouts and ``dense_from_numpy`` / ``edge_to_dense``.

The port's store ingests the ops of ``conftest.small_history`` (the
JAX package's generator, numpy-seeded); every snapshot is held to the
brute-force oracle (``tests/reference.py``) and, bit for bit, to the
JAX package's reconstruction of the same time; Lemma 1's op arrays must
equal ``repro.core.minimal_delta_between``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro_torch.core import (ADD_EDGE, ADD_NODE, REM_EDGE, REM_NODE,  # noqa: E402,E501
                              DenseGraph, EdgeGraph, delta_from_numpy,
                              dense_from_numpy, edge_to_dense,
                              minimal_delta_between, reconstruct_at,
                              reconstruct_dense, reconstruct_sequential,
                              slice_delta)
from repro_torch.core.index import count_window_ops, gather_window  # noqa: E402,E501
from repro_torch.core.store import Op, TemporalGraphStore  # noqa: E402


@pytest.fixture(scope="module")
def port_history(small_history):
    """The port's CPU store over the JAX store's accepted log, with the
    JAX store and the oracle."""
    jstore, bf = small_history
    ops = [Op(int(o), int(u), int(v), int(t)) for o, u, v, t in
           zip(jstore._op, jstore._u, jstore._v, jstore._t)]
    store = TemporalGraphStore(n_cap=jstore.n_cap, device="cpu")
    store.ingest(ops)
    store.advance_to(jstore.t_cur)
    assert store.t_cur == jstore.t_cur
    return store, jstore, bf


def _times(t_cur, parts):
    return range(0, t_cur + 1, max(t_cur // parts, 1))


def _held(g, bf, t, jg=None):
    """``g`` equals the oracle at ``t`` and, bit for bit, the JAX
    package's snapshot ``jg``."""
    assert np.array_equal(g.adj.numpy(), bf.adj(t)), t
    assert np.array_equal(g.nodes.numpy(), bf.node_mask(t)), t
    if jg is not None:
        assert np.array_equal(g.adj.numpy(), np.asarray(jg.adj)), t
        assert np.array_equal(g.nodes.numpy(), np.asarray(jg.nodes)), t


def test_invert_is_involution(port_history):
    store, jstore, _ = port_history
    d = store.delta()
    assert torch.equal(d.invert().invert().op, d.op)
    assert np.array_equal(d.invert().op.numpy(),
                          np.asarray(jstore.delta().invert().op))


def test_invert_swaps_add_rem():
    d = delta_from_numpy([ADD_NODE, REM_NODE, ADD_EDGE, REM_EDGE],
                         [0, 1, 2, 3], [0, 1, 3, 4], [0, 1, 0, 1],
                         [1, 2, 3, 4], device="cpu")
    inv = d.invert()
    assert inv.op.tolist()[:4] == [REM_NODE, ADD_NODE, REM_EDGE, ADD_EDGE]


def test_window_mask_half_open():
    args = ([ADD_NODE] * 4, [0, 1, 2, 3], [0, 1, 2, 3], [0, 1, 2, 3],
            [1, 2, 3, 4])
    d = delta_from_numpy(*args, device="cpu")
    m = d.window_mask(1, 3).numpy()
    assert m.tolist()[:4] == [False, True, True, False]
    assert np.array_equal(
        m, np.asarray(J.delta_from_numpy(*args).window_mask(1, 3)))


def test_padding_is_inert(port_history):
    store, _, bf = port_history
    d_tight = store.delta()
    d_padded = store.delta(capacity=d_tight.capacity * 2)
    t = store.t_cur // 2
    a = reconstruct_dense(store.current, d_tight, store.t_cur, t)
    b = reconstruct_dense(store.current, d_padded, store.t_cur, t)
    assert torch.equal(a.adj, b.adj) and torch.equal(a.nodes, b.nodes)
    _held(a, bf, t)


def test_completeness_every_time_unit(port_history):
    """Definition 4: Δ[t0,t'] ∘ SG_t0 = SG_t' for every t'."""
    store, jstore, bf = port_history
    d, jd = store.delta(), jstore.delta()
    n = store.n_cap
    empty = DenseGraph(nodes=torch.zeros((n,), dtype=torch.bool),
                       adj=torch.zeros((n, n), dtype=torch.bool))
    jempty = J.DenseGraph(nodes=jnp.zeros((n,), bool),
                          adj=jnp.zeros((n, n), bool))
    for t in _times(store.t_cur, 7):
        _held(reconstruct_dense(empty, d, 0, t), bf, t,
              J.reconstruct_dense(jempty, jd, 0, t))


def test_backward_reconstruction_theorem1(port_history):
    """Theorem 1: current snapshot + invertible delta suffice."""
    store, jstore, bf = port_history
    d, jd = store.delta(), jstore.delta()
    for t in _times(store.t_cur, 7):
        _held(reconstruct_dense(store.current, d, store.t_cur, t), bf, t,
              J.reconstruct_dense(jstore.current, jd, jstore.t_cur, t))


def test_forward_from_any_anchor(port_history):
    store, jstore, bf = port_history
    d, jd = store.delta(), jstore.delta()
    t_a = store.t_cur // 3
    anchor = reconstruct_dense(store.current, d, store.t_cur, t_a)
    janchor = J.reconstruct_dense(jstore.current, jd, jstore.t_cur, t_a)
    for t in [t_a + 1, store.t_cur // 2, store.t_cur]:
        _held(reconstruct_dense(anchor, d, t_a, t), bf, t,
              J.reconstruct_dense(janchor, jd, t_a, t))


def test_minimal_delta_lemma1(port_history):
    """Lemma 1: the minimal delta between two snapshots, applied to the
    first, yields the second — and contains no redundant ops; its op
    arrays are the reference's, in the reference's order."""
    store, _, bf = port_history
    t_a, t_b = store.t_cur // 4, 3 * store.t_cur // 4
    ma, aa = bf.node_mask(t_a), bf.adj(t_a)
    mb, ab = bf.node_mask(t_b), bf.adj(t_b)
    got = minimal_delta_between(ma, aa, mb, ab, t_b)
    want = J.minimal_delta_between(ma, aa, mb, ab, t_b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert np.array_equal(g, w)
    op, u, v, t = got
    assert len(op) and (t == t_b).all()
    nodes = ma.copy()
    adj = aa.copy()
    for o, uu, vv in zip(op, u, v):
        if o == ADD_NODE:
            assert not nodes[uu]  # minimality: genuine transition
            nodes[uu] = True
        elif o == REM_NODE:
            assert nodes[uu]
            nodes[uu] = False
            adj[uu, :] = adj[:, uu] = False
        elif o == ADD_EDGE:
            assert not adj[uu, vv]
            adj[uu, vv] = adj[vv, uu] = True
        else:
            assert adj[uu, vv]
            adj[uu, vv] = adj[vv, uu] = False
    assert np.array_equal(nodes, mb)
    assert np.array_equal(adj, ab)
    # and the empty delta between a snapshot and itself
    assert all(len(x) == 0 for x in minimal_delta_between(ma, aa, ma, aa,
                                                          t_a))


def test_slice_delta(port_history):
    store, jstore, _ = port_history
    d = store.delta()
    lo, hi = store.t_cur // 4, store.t_cur // 2
    s = slice_delta(d, lo, hi)
    t = s.t.numpy()[:s.n_ops]
    assert ((t > lo) & (t <= hi)).all()
    js = J.slice_delta(jstore.delta(), lo, hi)
    assert s.n_ops == int(js.n_ops)
    for c in ("op", "u", "v", "slot", "t"):
        assert np.array_equal(getattr(s, c).numpy()[:s.n_ops],
                              np.asarray(getattr(js, c))[:s.n_ops]), c


def test_sequential_matches_vectorized(port_history):
    store, _, bf = port_history
    d = store.delta()
    for t in _times(store.t_cur, 5):
        a = reconstruct_dense(store.current, d, store.t_cur, t)
        b = reconstruct_sequential(store.current, d, store.t_cur, t)
        assert torch.equal(a.adj, b.adj), t
        assert torch.equal(a.nodes, b.nodes), t
        _held(b, bf, t)


# ---------------------------------------------------------------------------
# Store time-unit boundary rules
# ---------------------------------------------------------------------------


def test_ingest_rejects_ops_at_closed_time_units():
    """Ops at or before t_cur are refused (immutable history), a batch
    must be time-ordered, and the accepted prefix of a failed batch
    stays visible."""
    s = TemporalGraphStore(n_cap=8, device="cpu")
    s.ingest([Op(ADD_NODE, 0, 0, 1), Op(ADD_NODE, 1, 1, 1)])
    s.advance_to(2)
    with pytest.raises(ValueError, match="immutable"):
        s.ingest([Op(ADD_EDGE, 0, 1, 2)])   # t == t_cur: closed unit
    with pytest.raises(ValueError, match="immutable"):
        s.ingest([Op(ADD_EDGE, 0, 1, 1)])   # t < t_cur still rejected
    assert s.stats()["total_ops"] == 2
    s.ingest([Op(ADD_EDGE, 0, 1, 3)])
    s.advance_to(3)
    assert int(s.current.num_edges()) == 1
    assert s.stats()["live_edges"] == 1
    with pytest.raises(ValueError, match="time-ordered"):
        s.ingest([Op(ADD_NODE, 5, 5, 7), Op(ADD_NODE, 6, 6, 5)])
    assert s.stats()["total_ops"] == 4
    assert int(s.delta().n_ops) == 4 and s.op_times_host()[-1] == 7


def test_advance_counts_only_ops_of_closed_units():
    """Only ops in (t_cur, t_next] count toward the materialization
    policy's op count; future-dated ops count once, when their unit
    closes."""
    s = TemporalGraphStore(n_cap=8, device="cpu")
    s.ingest([Op(ADD_NODE, i, i, 1) for i in range(4)]
             + [Op(ADD_EDGE, 0, 1, 2)]
             + [Op(ADD_EDGE, 1, 2, 9), Op(ADD_EDGE, 2, 3, 9)])  # future
    s.advance_to(2)
    assert s._ops_since_mat == 5
    s.advance_to(5)
    assert s._ops_since_mat == 5
    s.advance_to(9)
    assert s._ops_since_mat == 7
    assert int(s.current.num_edges()) == 3


def test_delta_capacity_below_n_ops_raises():
    for segmented in (True, False):
        s = TemporalGraphStore(n_cap=8, segmented=segmented, device="cpu")
        s.ingest([Op(ADD_NODE, i, i, 1) for i in range(6)])
        with pytest.raises(ValueError, match="capacity"):
            s.delta(capacity=4)
        d = s.delta(capacity=8)
        assert d.capacity == 8 and int(d.n_ops) == 6


def test_host_array_caches_invalidate_on_append():
    s = TemporalGraphStore(n_cap=8, device="cpu")
    s.ingest([Op(ADD_NODE, i, i, 1) for i in range(4)])
    a = s.op_times_host()
    assert s.op_times_host() is a and s._t is a  # cached, no re-convert
    assert s._op is s._op
    s.ingest([Op(ADD_EDGE, 0, 1, 2)])
    b = s.op_times_host()
    assert b is not a and b.shape[0] == a.shape[0] + 1


def test_gather_window_suffix_clamp_regression(port_history):
    """A window gathered at any capacity that holds it reconstructs as
    the full log does, for every anchor-side window."""
    store, _, _ = port_history
    d = store.delta()
    tc = store.t_cur
    for t in _times(tc, 7):
        n_win = int(count_window_ops(d, t, tc))
        for cap in {max(64, n_win), d.capacity // 2, d.capacity}:
            if cap < n_win or cap > d.capacity:
                continue
            w = gather_window(d, t, tc, cap)
            tw = w.t.numpy()[:int(w.n_ops)]
            assert int(w.n_ops) == n_win
            assert ((tw > t) & (tw <= tc)).all(), (t, cap)
            a = reconstruct_dense(store.current, w, tc, t)
            b = reconstruct_dense(store.current, d, tc, t)
            assert torch.equal(a.adj, b.adj), (t, cap)
            assert torch.equal(a.nodes, b.nodes), (t, cap)


# ---------------------------------------------------------------------------
# The names of repro.core the port lacked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_reconstruct_at_dispatches_on_layout(port_history, layout):
    """``reconstruct_at`` from the current snapshot of either layout,
    backward to every sampled time, equals the oracle and the JAX
    package's ``reconstruct_at``; the edge result converts back with
    ``edge_to_dense``."""
    store, jstore, bf = port_history
    d, jd = store.delta(), jstore.delta()
    anchor = store.current if layout == "dense" else store.edge_graph()
    janchor = jstore.current if layout == "dense" else jstore.edge_graph()
    for t in _times(store.t_cur, 5):
        g = reconstruct_at(anchor, d, store.t_cur, t)
        jg = J.reconstruct_at(janchor, jd, jstore.t_cur, t)
        if layout == "edge":
            assert isinstance(g, EdgeGraph)
            assert np.array_equal(g.emask.numpy(), np.asarray(jg.emask))
            g, jg = edge_to_dense(g), J.edge_to_dense(jg)
        _held(g, bf, t, jg)


def test_dense_from_numpy_matches_the_reference():
    nodes = np.array([True, True, False, True, True])
    edges = [(0, 1), (1, 3), (3, 3), (4, 0), (2, 4)]  # node 2 is not live
    g = dense_from_numpy(nodes, edges, n_cap=8, device="cpu")
    jg = J.dense_from_numpy(nodes, edges, n_cap=8)
    assert g.adj.dtype == torch.bool and g.adj.shape == (8, 8)
    assert np.array_equal(g.adj.numpy(), np.asarray(jg.adj))
    assert np.array_equal(g.nodes.numpy(), np.asarray(jg.nodes))
    assert int(g.num_edges()) == 4 and bool(g.validate()) is False
    assert bool(g.validate()) == bool(jg.validate())
    ok = dataclasses.replace(g, nodes=torch.ones(8, dtype=torch.bool))
    assert bool(ok.validate())
