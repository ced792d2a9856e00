"""The port's sweep executor (``repro_torch.kernels.evolve_sweep``)
against ``repro.kernels.evolve_sweep``: ``batch_evolve`` for every
SWEEP_MEASURE on both layouts, the signed nets, the degree-sweep
kernel's plain version and its event bucketing.  Sweep samples are
fixed f32 expressions of integers, so every comparison is bit-exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.generate import EvolutionParams, build_store  # noqa: E402
from repro.kernels.evolve_sweep import ops as JO  # noqa: E402
from repro.kernels.evolve_sweep.ref import evolve_ref as j_evolve_ref  # noqa: E402,E501
from repro.kernels.evolve_sweep.sweep import bucket_sweep_events as j_bse  # noqa: E402,E501
from repro_torch.kernels import evolve_sweep as TS  # noqa: E402
from test_torch_reconstruct import eq, port_delta, port_graph  # noqa: E402

PARAMS = EvolutionParams(m_attach=3, lam_extra=1.0, lam_remove=1.5,
                         p_remove_node=0.03, events_per_unit=5)


@pytest.fixture(scope="module")
def hist():
    st = build_store(48, PARAMS, seed=4, n_cap=64)
    return st, st.delta(), port_delta(st.delta())


def _group(st):
    tc = st.t_cur
    t_los = np.array([1, tc // 3, tc // 2], np.int32)
    widths = np.array([9, 5, 7], np.int32)
    vs = np.array([3, 11, 20], np.int32)
    return t_los, widths, vs


@pytest.mark.parametrize("layout", ["dense", "edge"])
@pytest.mark.parametrize("measure", list(TS.SWEEP_MEASURES))
@pytest.mark.parametrize("stride", [1, 3])
def test_batch_evolve_matches_jax(hist, layout, measure, stride):
    st, d, td = hist
    anchor = (st.current if layout == "dense"
              else st.current_edge_snapshot())
    t_los, widths, vs = _group(st)
    scope = "node" if measure == "degree" else "global"
    nb = 16
    a = JO.batch_evolve(anchor, d, d, st.t_cur, jnp.asarray(t_los),
                        jnp.asarray(widths), jnp.asarray(vs),
                        measure=measure, scope=scope, stride=stride,
                        num_buckets=nb)
    b = TS.batch_evolve(port_graph(anchor), td, td, st.t_cur, t_los, widths,
                        vs, measure=measure, scope=scope, stride=stride,
                        num_buckets=nb)
    eq(a, b)


def test_sweep_nets_match_jax(hist):
    st, d, td = hist
    lo, last, stride, nb = 4, st.t_cur - 3, 2, 32
    a = JO.sweep_nets(d, lo, last, stride, nb, st.n_cap)
    b = TS.sweep_nets(td, torch.tensor([lo], dtype=torch.int32),
                      torch.tensor([last], dtype=torch.int32), stride, nb,
                      st.n_cap)
    for x, y in zip(a, b):
        eq(x, y[0])


def test_sweep_series_plain_matches_jax_nets(hist):
    """The degree-sweep kernel's plain version == deg0 + cumsum of the
    XLA executor's degree nets, for several sweeps at once."""
    st, d, td = hist
    t_los, widths, _ = _group(st)
    stride, nb = 2, 16
    deg0 = port_graph(st.current).degrees()
    t_lo = torch.from_numpy(t_los)
    t_last = t_lo + (torch.from_numpy(widths) - 1) * stride
    ev, starts = TS.bucket_sweep_events(td, st.n_cap, int(t_lo.min()),
                                        int(t_last.max()))
    out = TS.sweep_series_ref(deg0.expand(3, -1).contiguous(), ev, starts,
                              t_lo, t_last, stride, nb, TS.TILE)
    for q in range(3):
        nets = JO.sweep_nets(d, int(t_lo[q]), int(t_last[q]), stride, nb,
                             st.n_cap)[0]
        want = np.asarray(st.current.degrees())[None] + np.cumsum(
            np.asarray(nets), 0, dtype=np.int32)
        eq(want, out[q])
    single = TS.sweep_degree_series(deg0, td, int(t_lo[0]), int(t_last[0]),
                                    stride, nb)
    assert torch.equal(single, out[0])


def test_bucket_sweep_events_match_jax_glue(hist):
    """The port's events are the jnp glue's, with the sample index left
    to the kernel: computing it from the carried time gives the jnp
    blocks' [node, sample, sign] rows in the same order."""
    st, d, td = hist
    lo, last, stride, nb = 3, st.t_cur - 2, 3, 64
    blocks, overflow = j_bse(d, TS.TILE, lo, last, stride, nb, TS.TILE,
                             2048)
    assert not bool(overflow)
    blk = np.asarray(blocks)[0]
    ev, _ = TS.bucket_sweep_events(td, st.n_cap, lo, last)
    ev = ev.numpy()
    k = np.clip((ev[:, 1] - lo + stride - 1) // stride, 0, nb - 1)
    got = np.stack([ev[:, 0], k, ev[:, 2]], 1)
    assert np.array_equal(got, blk[blk[:, 3] > 0][:, :3])


@pytest.mark.parametrize("layout", ["dense", "edge"])
def test_evolve_ref_matches_jax(hist, layout):
    st, d, td = hist
    anchor = (st.current if layout == "dense"
              else st.current_edge_snapshot())
    for measure, scope, v in (("num_edges", "global", None),
                              ("degree", "node", 7)):
        a = j_evolve_ref(anchor, d, st.t_cur, 2, st.t_cur - 1, 4, measure,
                         scope, v)
        b = TS.evolve_ref(port_graph(anchor), td, st.t_cur, 2,
                          st.t_cur - 1, 4, measure, scope, v)
        eq(a, b)
