"""Property-based tests (hypothesis) on the port — the five properties of
``tests/test_property.py``, each also held against the JAX package.

Strategy: random legal op histories (proposals; the stores reject
illegal transitions, so any sequence is admissible input) go into the
port's CPU store and the JAX package's store alike.  The port must
satisfy completeness, plan equivalence, partial-reconstruction
equivalence, invertibility, structural validity and edge-layout
equivalence for arbitrary query times and nodes, and every answer must
equal the JAX package's for the drawn history, bit for bit.

``derandomize=True`` and ``database=None``: every run draws the same
examples and nothing is written under ``.hypothesis/``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core.plans import Query as JQuery  # noqa: E402
from repro.core.store import Op as JOp  # noqa: E402
from repro.core.store import TemporalGraphStore as JStore  # noqa: E402
from repro_torch.core import (reconstruct_dense, reconstruct_edge,  # noqa: E402
                              reconstruct_sequential)
from repro_torch.core.delta import ADD_EDGE, ADD_NODE, REM_EDGE, REM_NODE  # noqa: E402,E501
from repro_torch.core.plans import Query  # noqa: E402
from repro_torch.core.store import Op, TemporalGraphStore  # noqa: E402

N = 12  # node universe — small keeps hypothesis fast on 1 CPU


def fixed(max_examples: int):
    return settings(max_examples=max_examples, deadline=None,
                    database=None, derandomize=True)


@st.composite
def histories(draw):
    """A random history of op proposals, as (op, u, v, t) tuples."""
    n_ops = draw(st.integers(min_value=4, max_value=60))
    ops = []
    t = 1
    for _ in range(n_ops):
        t += draw(st.integers(min_value=0, max_value=2))
        kind = draw(st.sampled_from([ADD_NODE, ADD_NODE, ADD_EDGE,
                                     ADD_EDGE, ADD_EDGE, REM_EDGE,
                                     REM_NODE]))
        u = draw(st.integers(min_value=0, max_value=N - 1))
        v = draw(st.integers(min_value=0, max_value=N - 1))
        ops.append((kind, u, v if kind in (ADD_EDGE, REM_EDGE) else u, t))
    return ops


def _build(ops):
    """The port's CPU store and the JAX package's, over the same ops."""
    store = TemporalGraphStore(n_cap=N, device="cpu")
    jstore = JStore(n_cap=N)
    t_max = max(o[3] for o in ops)
    store.ingest([Op(*o) for o in ops])
    jstore.ingest([JOp(*o) for o in ops])
    store.advance_to(t_max)
    jstore.advance_to(t_max)
    return store, jstore


def _same(g, jg):
    return (np.array_equal(g.adj.numpy(), np.asarray(jg.adj))
            and np.array_equal(g.nodes.numpy(), np.asarray(jg.nodes)))


def _bits(x):
    a = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
    return a.dtype.str, a.tobytes()


@given(histories(), st.integers(min_value=0, max_value=100))
@fixed(25)
def test_sequential_equals_vectorized_equals_edges(ops, t_raw):
    store, jstore = _build(ops)
    t = t_raw % (store.t_cur + 1)
    d = store.delta()
    a = reconstruct_dense(store.current, d, store.t_cur, t)
    b = reconstruct_sequential(store.current, d, store.t_cur, t)
    assert torch.equal(a.adj, b.adj) and torch.equal(a.nodes, b.nodes)
    e = reconstruct_edge(store.edge_graph(), d, store.t_cur, t)
    assert torch.equal(e.to_dense().adj, a.adj)
    assert torch.equal(e.nodes, a.nodes)
    assert _same(a, J.reconstruct_dense(jstore.current, jstore.delta(),
                                        jstore.t_cur, t))


@given(histories(), st.integers(min_value=0, max_value=N - 1),
       st.integers(min_value=0, max_value=100),
       st.integers(min_value=0, max_value=100))
@fixed(25)
def test_plans_agree(ops, v, ta_raw, tb_raw):
    store, jstore = _build(ops)
    t_k = min(ta_raw, tb_raw) % (store.t_cur + 1)
    t_l = max(t_k, max(ta_raw, tb_raw) % (store.t_cur + 1))
    q_point = Query("point", "node", "degree", t_k=t_k, v=v)
    r_two = int(store.query(q_point, plan="two_phase"))
    assert int(store.query(q_point, plan="hybrid")) == r_two
    assert int(store.query(q_point, plan="hybrid", indexed=True)) == r_two
    assert int(store.query(q_point, plan="two_phase",
                           partial_rows=True)) == r_two
    assert r_two == int(jstore.query(JQuery("point", "node", "degree",
                                            t_k=t_k, v=v),
                                     plan="two_phase"))

    q_diff = Query("diff", "node", "degree", t_k=t_k, t_l=t_l, v=v)
    d_two = int(store.query(q_diff, plan="two_phase"))
    assert int(store.query(q_diff, plan="delta_only")) == d_two
    assert int(store.query(q_diff, plan="delta_only", indexed=True)) == \
        d_two
    assert d_two == int(jstore.query(JQuery("diff", "node", "degree",
                                            t_k=t_k, t_l=t_l, v=v),
                                     plan="delta_only"))


@given(histories())
@fixed(15)
def test_roundtrip_back_then_forward(ops):
    """BackRec then ForRec returns the current snapshot (invertibility,
    Definition 5)."""
    store, jstore = _build(ops)
    d = store.delta()
    t = store.t_cur // 2
    back = reconstruct_dense(store.current, d, store.t_cur, t)
    forth = reconstruct_dense(back, d, t, store.t_cur)
    assert torch.equal(forth.adj, store.current.adj)
    assert torch.equal(forth.nodes, store.current.nodes)
    assert _same(back, J.reconstruct_dense(jstore.current, jstore.delta(),
                                           jstore.t_cur, t))


@given(histories())
@fixed(10)
def test_store_consistency(ops):
    """Current snapshot is structurally valid (symmetric adjacency,
    edges only between live nodes), and the JAX package's."""
    store, jstore = _build(ops)
    assert bool(store.current.validate())
    assert _same(store.current, jstore.current)
    assert store.stats() == jstore.stats()


@given(histories(), st.integers(min_value=0, max_value=100),
       st.integers(min_value=0, max_value=N - 1))
@fixed(20)
def test_dense_edge_layout_query_parity(ops, t_raw, v):
    """Random legal delta + random query → bit-identical results under
    forced dense and forced edge execution, for every edge-supported
    measure and every query kind, and the JAX package's."""
    store, jstore = _build(ops)
    t_k = t_raw % (store.t_cur + 1)
    t_l = min(store.t_cur, t_k + (t_raw % 5))
    spec = [dict(kind="point", scope="node", measure="degree", t_k=t_k,
                 v=v),
            dict(kind="diff", scope="node", measure="degree", t_k=t_k,
                 t_l=t_l, v=v),
            dict(kind="agg", scope="node", measure="degree", t_k=t_k,
                 t_l=t_l, v=v, agg="mean"),
            dict(kind="point", scope="global", measure="num_edges",
                 t_k=t_k),
            dict(kind="point", scope="global", measure="num_nodes",
                 t_k=t_k),
            dict(kind="point", scope="global", measure="density", t_k=t_k),
            dict(kind="point", scope="global", measure="avg_degree",
                 t_k=t_k),
            dict(kind="diff", scope="global", measure="num_edges", t_k=t_k,
                 t_l=t_l)]
    eng = store.engine()
    dense = [_bits(r) for r in eng.evaluate_many(
        [Query(**s) for s in spec], layout="dense")]
    edge = [_bits(r) for r in eng.evaluate_many(
        [Query(**s) for s in spec], layout="edge")]
    assert edge == dense
    want = [_bits(r) for r in jstore.engine().evaluate_many(
        [JQuery(**s) for s in spec], layout="dense")]
    assert dense == want
