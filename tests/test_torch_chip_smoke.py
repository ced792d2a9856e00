"""``chip_smoke.py``'s kernel comparison, read on CPU tensors.

Every kernel case of ``chip_smoke.py`` passes through ``_compare``: a
kernel output that is NaN or infinite where the plain value is finite
must read as an infinite difference, never as none (Python's ``max``
and ``float(t.max())`` let a NaN through as a pass)."""
import importlib.util
import math
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def bf16_rule(out):
    """B5's bf16 per-element rule, as ``chip_smoke.attention_case``."""
    return 2.0 ** -7 * out.float().abs() + 2.0 ** -12


PLAIN = torch.tensor([[0.5, -1.25], [0.0, 3.0]], dtype=torch.bfloat16)


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("tol", [bf16_rule, None],
                         ids=["per-element", "bit-exact"])
def test_compare_fails_non_finite_kernel_output(bad, tol):
    kernel = PLAIN.clone()
    kernel[1, 0] = bad
    err, share = chip_smoke._compare(kernel, PLAIN, tol)
    assert err == math.inf and share == math.inf


def test_compare_reads_equal_outputs_as_zero():
    """Equal outputs read 0 even where the allowed difference is 0, and
    one bf16 ulp of the plain value reads at most the whole rule."""
    assert chip_smoke._compare(PLAIN, PLAIN.clone(),
                               lambda out: torch.zeros_like(out.float())
                               ) == (0.0, 0.0)
    ulp = PLAIN.clone()
    ulp[0, 0] = 0.5 + 2.0 ** -8           # the next bf16 above 0.5
    err, share = chip_smoke._compare(ulp, PLAIN, bf16_rule)
    assert err == 2.0 ** -8 and 0 < share <= 1


# ---------------------------------------------------------------------------
# The design counts printed on B1's and B4's kernel lines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_store():
    from repro_torch.core.store import TemporalGraphStore
    ops = chip_smoke.make_ops(300, 7)
    st = TemporalGraphStore(320, layout="dense", device="cpu")
    st.ingest([(o.op, o.u, o.v, o.t) for o in ops])
    st.advance_to(ops[-1].t)
    return st


def test_delta_apply_design_counts_match_bucket_ops(small_store):
    """Tiles without an in-window entry, per query, are the tiles that a
    bucketing of that query's window alone leaves empty."""
    from repro_torch.core.reconstruct import window_of
    from repro_torch.kernels.delta_apply import bucket_ops
    st = small_store
    tc = st.t_cur
    tq = torch.tensor([tc // 5, tc // 2, tc - 1, tc], dtype=torch.int32)
    ta = torch.tensor([tc, tc, tc // 3, tc], dtype=torch.int32)
    d = st.delta_view().window_delta(1, tc)
    ent, tst = bucket_ops(d, st.n_cap, *window_of(ta, tq))
    got = chip_smoke.delta_apply_design(ent, tst, ta, tq)
    counts = (tst[1:] - tst[:-1])
    assert got["tiles"] == counts.numel() == 25
    assert got["entries_per_tile_max"] == int(counts.max())
    assert got["entries_per_tile_mean"] == float(counts.double().mean())
    want = []
    for a, q in zip(ta.tolist(), tq.tolist()):
        _, one = bucket_ops(d, st.n_cap, min(a, q), max(a, q))
        want.append(int(((one[1:] - one[:-1]) == 0).sum()))
    assert got["tiles_without_window_entry"] == want
    assert want[3] == 25 and got["tile_queries_without_window_entry"] \
        == sum(want)


def test_sweep_design_counts_match_work_list(small_store, monkeypatch):
    from repro_torch.kernels.evolve_sweep import (bucket_sweep_events,
                                                  sweep, sweep_work)
    st = small_store
    ev, tst = bucket_sweep_events(st.delta_view().window_delta(1, st.t_cur),
                                  st.n_cap, 1, st.t_cur)
    monkeypatch.setattr(sweep, "CHUNK", 64)
    rows = sweep_work(tst, ev.shape[0])
    got = chip_smoke.sweep_design(tst, ev.shape[0])
    real = rows[rows[:, 0] >= 0]
    sizes = real[:, 2] - real[:, 1]
    assert got["tiles"] == 2 and got["chunk"] == 64
    assert got["events_per_tile_max"] == int((tst[1:] - tst[:-1]).max())
    assert got["blocks_per_query"] == real.shape[0] > 2
    assert got["rows_per_query"] == rows.shape[0] >= real.shape[0]
    assert got["heaviest_block_events"] == int(sizes.max()) <= 64
    assert got["split_tiles"] == int(real[:, 3].max()) + 1 == 2
