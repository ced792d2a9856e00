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
from repro_torch.kernels import degree_series as DS  # noqa: E402
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
    to the kernel: computing it from the carried time, and node and sign
    from the packed ``local node·2 + is_add``, gives the jnp blocks'
    [node, sample, sign] rows in the same order."""
    st, d, td = hist
    lo, last, stride, nb = 3, st.t_cur - 2, 3, 64
    blocks, overflow = j_bse(d, TS.TILE, lo, last, stride, nb, TS.TILE,
                             2048)
    assert not bool(overflow)
    blk = np.asarray(blocks)[0]
    ev, _ = TS.bucket_sweep_events(td, st.n_cap, lo, last)
    ev = ev.numpy()
    k = np.clip((ev[:, 0] - lo + stride - 1) // stride, 0, nb - 1)
    got = np.stack([ev[:, 1] >> 1, k, (ev[:, 1] & 1) * 2 - 1], 1)
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


# ---------------------------------------------------------------------------
# The degree-sweep kernel's work list (sweep_work) and a model of sweep.cu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_sweep():
    """Three node tiles (TILE = 256), the last one partial."""
    st = build_store(600, PARAMS, seed=5, n_cap=640)
    td = port_delta(st.delta())
    ev, starts = TS.bucket_sweep_events(td, st.n_cap, 2, st.t_cur)
    return st, td, ev, starts


def _hub_delta(n_ops, n_cap, seed):
    """Edge ops of which 9 in 10 touch one of four hub nodes: the hubs'
    tile holds most events, as preferential attachment's first tile
    does.  Signs alternate per op; the sweep glue and plain version do
    not check legality."""
    from repro.core.delta import delta_from_numpy as j_dfn

    from repro_torch.core.delta import ADD_EDGE, REM_EDGE, delta_from_numpy
    rng = np.random.default_rng(seed)
    u = np.where(rng.random(n_ops) < 0.9, rng.integers(0, 4, n_ops),
                 rng.integers(0, n_cap, n_ops)).astype(np.int32)
    v = rng.integers(4, n_cap, n_ops).astype(np.int32)
    op = np.where(np.arange(n_ops) % 3 == 2, REM_EDGE, ADD_EDGE).astype(
        np.int32)
    t = (1 + np.arange(n_ops) // 16).astype(np.int32)
    slot = np.arange(n_ops, dtype=np.int32)
    return (j_dfn(op, u, v, slot, t),
            delta_from_numpy(op, u, v, slot, t, device="cpu"))


def _check_work(rows, starts, n_events):
    """The split tiles' chunks past their first, in tile and chunk
    order, then surplus rows up to the bound on rows, then the tiles'
    first chunks in tile order; each tile's run of events cut into
    contiguous chunks of at most CHUNK events that cover it exactly
    once, a split tile's rows carrying its tile as their slot."""
    rows = rows.numpy()
    chunk = TS.sweep.CHUNK
    ts = starts.numpy().astype(np.int64)
    counts = np.diff(ts)
    tiles = counts.size
    extra = n_events // chunk
    assert rows.shape == (extra + tiles, 4)
    assert np.array_equal(rows[extra:, 0], np.arange(tiles))   # firsts
    assert np.array_equal(rows[extra:, 1], ts[:-1])
    real = rows[:extra, 0] >= 0
    n_real = int(real.sum())
    assert real[:n_real].all()                      # surplus after them
    assert (rows[n_real:extra] == [-1, 0, 0, -1]).all()
    assert np.all(np.diff(rows[:n_real, 0]) >= 0)   # tile order
    rows = np.concatenate([rows[extra:], rows[:n_real]])
    assert np.all(rows[:, 2] - rows[:, 1] <= chunk)
    split = 0
    for tile in range(tiles):
        mine = rows[rows[:, 0] == tile]
        assert len(mine) == max(1, -(-counts[tile] // chunk))
        assert mine[0, 1] == ts[tile] and mine[-1, 2] == ts[tile + 1]
        assert np.array_equal(mine[1:, 1], mine[:-1, 2])  # no gap, no overlap
        if len(mine) > 1:
            assert np.all(mine[:, 3] == tile)
            assert np.all(mine[:, 2] > mine[:, 1])        # none empty
            split += 1
        else:
            assert mine[0, 3] == -1
    assert split <= min(tiles, n_events // (chunk + 1))
    return split


@pytest.mark.parametrize("chunk", [1, 7, 100, TS.CHUNK])
def test_sweep_work_covers_every_event_once(wide_sweep, chunk, monkeypatch):
    _, _, ev, starts = wide_sweep
    monkeypatch.setattr(TS.sweep, "CHUNK", chunk)
    split = _check_work(TS.sweep_work(starts, ev.shape[0]), starts,
                        ev.shape[0])
    if chunk < int(np.diff(starts.numpy()).max()):
        assert split > 0


def test_sweep_work_splits_a_hub_tile():
    """A store whose four hubs hold most events: at the kernel's own
    chunk size their tile takes several blocks, none past CHUNK, and
    the plain version over those events still equals JAX's nets."""
    n_cap, n_ops = 1024, 12000
    jd, td = _hub_delta(n_ops, n_cap, seed=3)
    ev, starts = TS.bucket_sweep_events(td, n_cap, 0, n_ops)
    counts = np.diff(starts.numpy())
    assert counts[0] > TS.CHUNK
    work = TS.sweep_work(starts, ev.shape[0])
    assert _check_work(work, starts, ev.shape[0]) == 1
    rows = work.numpy()
    assert (rows[:, 0] == 0).sum() > 1
    assert rows[0, 0] == rows[0, 3] == 0        # tile 0's second chunk
    lo, last, stride, nb = 3, 600, 10, 64
    deg0 = torch.zeros((1, n_cap), dtype=torch.int32)
    out = TS.sweep_series_ref(deg0, ev, starts, torch.tensor([lo]),
                              torch.tensor([last]), stride, nb, TS.TILE)
    nets = JO.sweep_nets(jd, lo, last, stride, nb, n_cap)[0]
    eq(np.cumsum(np.asarray(nets), 0, dtype=np.int32), out[0])


def _wrap32(x):
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _kernel_model(deg0, ev, starts, t_lo, t_last, stride, nb, rows,
                  backward=False):
    """series.cuh block by block, in numpy: each work row adds its events
    into a net packed two samples to an int32 word (while B/2 × 256 ×
    4 bytes fit in 226 KB) or into an int32 net, a split tile's chunks
    are summed into one global net and the block that brings the
    tile's event counter to its count runs the running sum from deg0;
    surplus rows do nothing.  Forward (sweep.cu) an event counts from
    bucket clip(ceil((t − lo)/stride), 0, B − 1) on; ``backward``
    (degree_series.cu) it counts at and below bucket min(ceil((t −
    lo)/stride), B) − 1, and the running sum runs down from the top,
    subtracting."""
    q, n = deg0.shape
    tile_n = TS.TILE
    packed = (nb + 1) // 2 * tile_n * 4 <= 226 * 1024
    e = ev.numpy().astype(np.int64)
    out = np.zeros((q, nb, n), np.int64)
    for qi in range(q):
        lo, last = int(t_lo[qi]), int(t_last[qi])
        gnet, seen = {}, {}
        for tile, j0, j1, slot in rows.numpy():
            if tile < 0:
                continue
            t, code = e[j0:j1, 0], e[j0:j1, 1]
            win = (t > lo) & (t <= last)
            k = (t[win] - lo + stride - 1) // stride
            k = np.minimum(k, nb) - 1 if backward else np.clip(k, 0, nb - 1)
            node = code[win] >> 1
            sign = np.where(code[win] & 1, 1, -1)
            if packed:
                words = np.zeros(((nb + 1) // 2, tile_n), np.int64)
                np.add.at(words, (k >> 1, node),
                          np.where(k & 1, sign * 65536, sign))
                words = _wrap32(words)
                low = ((words & 0xffff) ^ 0x8000) - 0x8000
                net = np.stack([low, (words - low) >> 16], 1).reshape(
                    -1, tile_n)[:nb]
            else:
                net = np.zeros((nb, tile_n), np.int64)
                np.add.at(net, (k, node), sign)
            if slot >= 0:
                gnet[tile] = gnet.get(tile, 0) + net
                seen[tile] = seen.get(tile, 0) + (j1 - j0)
                if seen[tile] != starts[tile + 1] - starts[tile]:
                    continue
                net = gnet[tile]
            cols = slice(tile * tile_n, min(n, (tile + 1) * tile_n))
            w = cols.stop - cols.start
            base = deg0[qi, cols].numpy().astype(np.int64)
            if backward:
                out[qi, :, cols] = base - np.cumsum(net[::-1, :w],
                                                    0)[::-1]
            else:
                out[qi, :, cols] = base + np.cumsum(net[:, :w], 0)
    return _wrap32(out).astype(np.int32)


@pytest.mark.parametrize("nb", [64, 5, 512], ids=["packed", "odd", "global"])
@pytest.mark.parametrize("chunk", [50, TS.CHUNK])
def test_kernel_model_matches_plain(wide_sweep, nb, chunk, monkeypatch):
    """The kernel's algorithm (chunks, packed nets, the global combine)
    equals JAX's nets summed from deg0 for three sweeps of different
    windows: a record of why the packed halves and the chunked combine
    are exact.  It models sweep.cu and does not run it; the card's
    bit-exact check in chip_smoke.py holds the CUDA code itself."""
    st, _, ev, starts = wide_sweep
    rng = np.random.default_rng(nb)
    deg0 = rng.integers(0, 9, (3, st.n_cap)).astype(np.int32)
    tc = st.t_cur
    t_lo = np.array([2, tc // 3, tc // 2], np.int32)
    stride = 2
    t_last = t_lo + np.array([nb, 9, 1], np.int32) * stride
    monkeypatch.setattr(TS.sweep, "CHUNK", chunk)
    rows = TS.sweep_work(starts, ev.shape[0])
    got = _kernel_model(torch.from_numpy(deg0), ev, starts.numpy(), t_lo,
                        t_last, stride, nb, rows)
    for qi in range(3):
        nets = JO.sweep_nets(st.delta(), int(t_lo[qi]), int(t_last[qi]),
                             stride, nb, st.n_cap)[0]
        eq(got[qi], deg0[qi] + np.cumsum(np.asarray(nets), 0,
                                         dtype=np.int32))


# ---------------------------------------------------------------------------
# The hybrid plan's degree series (degree_series.cu): the same code run
# backward over the sweep's events with no upper time bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [64, 5, 512], ids=["packed", "odd", "global"])
@pytest.mark.parametrize("chunk", [50, TS.CHUNK])
def test_degree_series_kernel_model_matches_jax(wide_sweep, nb, chunk,
                                                 monkeypatch):
    """B3's algorithm — B4's chunks, packed nets and global combine, run
    backward (reverse running sum, subtracting) with every op past the
    series in the tail bucket — equals JAX's ``degree_series`` (with
    B = 5 nearly every event is in the tail)."""
    from repro.core import reconstruct as R
    st, td, _, _ = wide_sweep
    t_k = st.t_cur // 3
    ev, starts = TS.bucket_sweep_events(td, st.n_cap, t_k)
    monkeypatch.setattr(TS.sweep, "CHUNK", chunk)
    rows = TS.sweep_work(starts, ev.shape[0])
    if chunk == 50:
        assert (rows[:, 3] >= 0).any()                    # split tiles
    deg = port_graph(st.current).degrees()
    got = _kernel_model(deg.view(1, -1), ev, starts.numpy(), [t_k],
                        [2 ** 31 - 1], 1, nb, rows, backward=True)[0]
    want = R.degree_series(st.current, st.delta(), t_k, t_k + nb - 1, nb,
                           st.t_cur)
    eq(want, got)
    eq(want, DS.degree_series_kernel(deg, ev, starts, t_k, nb))


def test_degree_series_splits_a_hub_tile():
    """The hub store: tile 0 holds more than CHUNK events, so B3's work
    list cuts it into several blocks, none past CHUNK, and the series
    (from zero degrees) still equals JAX's."""
    from repro.core import reconstruct as R
    from repro.core.graph import DenseGraph as JDense
    n_cap, n_ops = 1024, 12000
    jd, td = _hub_delta(n_ops, n_cap, seed=5)
    t_k, nb = 40, 16
    ev, starts = TS.bucket_sweep_events(td, n_cap, t_k)
    counts = np.diff(starts.numpy())
    assert counts[0] > TS.CHUNK
    rows = TS.sweep_work(starts, ev.shape[0])
    assert _check_work(rows, starts, ev.shape[0]) == 1
    real = rows[rows[:, 0] >= 0].numpy()
    assert (real[:, 0] == 0).sum() > 1
    assert (real[:, 2] - real[:, 1]).max() <= TS.CHUNK
    zero = JDense(nodes=jnp.ones((n_cap,), bool),
                  adj=jnp.zeros((n_cap, n_cap), bool))
    want = R.degree_series(zero, jd, t_k, t_k + nb - 1, nb, n_ops)
    deg = torch.zeros((n_cap,), dtype=torch.int32)
    eq(want, DS.degree_series_kernel(deg, ev, starts, t_k, nb))
    eq(want, _kernel_model(deg.view(1, -1), ev, starts.numpy(), [t_k],
                           [2 ** 31 - 1], 1, nb, rows, backward=True)[0])


@pytest.mark.parametrize("cuts", [[0, 160, 320, 480, 640], [0, 200, 457, 640]],
                         ids=["quarters", "ragged"])
def test_degree_series_node_blocks_match_jax(wide_sweep, cuts):
    """B3's node-block glue (``bucket_sweep_events(row0=)``,
    ``degree_series_rows``) against the JAX package's jnp
    ``bucket_node_events(row0=, n_valid=)``: each block's events per
    tile, and their [local node, bucket, sign] rows in order, are the
    jnp blocks'; the blocks' series, concatenated along nodes, equal the
    whole graph's (the port's and JAX's ``degree_series``)."""
    from repro.core import reconstruct as R
    from repro.kernels.degree_series.ops import bucket_node_events
    st, td, _, _ = wide_sweep
    t_k, nb = st.t_cur // 3, 16
    deg = port_graph(st.current).degrees()
    parts = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        r = hi - lo
        pad = -(-r // TS.TILE) * TS.TILE
        blocks, overflow = bucket_node_events(
            st.delta(), pad, t_k, nb, TS.TILE, 4096, row0=lo, n_valid=r)
        assert not bool(overflow)
        blocks = np.asarray(blocks)
        ev, starts = TS.bucket_sweep_events(td, r, t_k, row0=lo)
        assert np.array_equal(np.diff(starts.numpy()),
                              blocks[..., 3].sum(1))
        ev = ev.numpy()
        got = np.stack([ev[:, 1] >> 1, np.clip(ev[:, 0] - t_k, 0, nb),
                        (ev[:, 1] & 1) * 2 - 1], 1)
        want = np.concatenate([b[b[:, 3] > 0][:, :3] for b in blocks])
        assert np.array_equal(got, want)
        parts.append(DS.degree_series_rows(deg[lo:hi].contiguous(), td, t_k,
                                           nb, row0=lo))
    whole = R.degree_series(st.current, st.delta(), t_k, t_k + nb - 1, nb,
                            st.t_cur)
    eq(whole, torch.cat(parts, 1))
    eq(whole, DS.degree_series_rows(deg, td, t_k, nb))
