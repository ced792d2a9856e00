"""The port's serving driver (``repro_torch.launch.serve``) against
``repro.launch.serve``, and the port's ``repro_torch.core`` surface
against ``repro.core``.

The driver runs at ``--nodes 200 --queries 32 --device cpu`` on a mesh
of one ``"cpu"`` shard and of four.  The reference's steps run on one
CPU device from the same seed: ``build_store``, ``shard_graph``,
``dist_batch_point_degree`` over the same query batch, and
``serve_batch`` over the same five mixed queries.  The point degrees
and the mixed answers must be bit-equal (same dtype, shape and bits),
and the driver's printed lines must read as the reference's.
"""
import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as JC  # noqa: E402
from repro.core import distributed as JD  # noqa: E402
from repro.core.generate import EvolutionParams as JParams  # noqa: E402
from repro.core.generate import build_store as j_build_store  # noqa: E402
from repro.core.plans import Query as JQuery  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.graph import EdgeGraph  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.sharding import graph_mesh, shard_rows, shard_slots  # noqa: E402,E501

ARGV = ["--nodes", "200", "--queries", "32", "--seed", "0",
        "--device", "cpu"]


def eq(a, b):
    """Bit-exact: same dtype, shape and bits."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), (a, b)


@pytest.fixture(scope="module")
def reference():
    """The reference driver's steps on one CPU device."""
    args = serve.parse_args(ARGV)
    rng = np.random.default_rng(args.seed)
    store = j_build_store(args.nodes, JParams(m_attach=4, lam_extra=1.0,
                                              lam_remove=1.0),
                          seed=args.seed)
    mesh = JD.graph_mesh()
    g = JD.shard_graph(store.current, mesh)
    vs = rng.integers(0, args.nodes, args.queries).astype(np.int32)
    ts = rng.integers(1, store.t_cur, args.queries).astype(np.int32)
    deg = JD.dist_batch_point_degree(mesh, g, store.delta(),
                                     jnp.asarray(vs), jnp.asarray(ts),
                                     store.t_cur)
    mixed = [JQuery(**dataclasses.asdict(q))
             for q in serve.mixed_queries(store.t_cur, vs, ts)]
    return dict(store=store, vs=vs, ts=ts, degrees=np.asarray(deg),
                answers=jserve.serve_batch(store, mixed))


@pytest.mark.parametrize("shards", [1, 4])
def test_driver_matches_the_reference(reference, shards):
    out = serve.main(ARGV, mesh=graph_mesh(["cpu"] * shards))
    assert out["mesh"].size == shards
    eq(out["vs"], reference["vs"])
    eq(out["ts"], reference["ts"])
    eq(out["degrees"], reference["degrees"])
    assert len(out["answers"]) == len(reference["answers"]) == 5
    for got, want in zip(out["answers"], reference["answers"]):
        eq(got, want)
    assert out["store"].stats() == reference["store"].stats()
    for k in ("build_s", "batch_s", "mixed_s"):
        assert out[k] >= 0.0


def _numbers_blanked(text: str) -> list[str]:
    """The printed lines with the times blanked (what differs run to
    run); every other character must match."""
    return [re.sub(r"in [0-9.]+ ?(m?s)|\([0-9]+ us/query\)", "in T", ln)
            for ln in text.strip().splitlines()]


def test_printed_lines_match_the_reference(monkeypatch, capsys):
    serve.main(ARGV)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + ARGV[:6])
    jserve.main()
    theirs = capsys.readouterr().out
    assert _numbers_blanked(ours) == _numbers_blanked(theirs)
    assert len(ours.strip().splitlines()) == 3


def test_default_mesh_is_the_device_once():
    out = serve.main(["--nodes", "40", "--queries", "4", "--device",
                      "cpu"])
    assert out["mesh"].devices == (torch.device("cpu"),)


def test_core_exports_the_reference_names():
    """``repro_torch.core`` exports every name ``repro.core`` imports
    from its modules (the submodule names ``dir()`` also yields are not
    part of it)."""
    def names(pkg):
        mods = {n for n in pkg.__all__
                if type(getattr(pkg, n)).__name__ == "module"}
        return set(pkg.__all__) - mods
    want = names(JC)
    assert len(want) >= 48
    assert names(TC) == want


def test_shard_graph_is_shard_rows_and_shard_edge_graph_shard_slots():
    store = serve.main(["--nodes", "48", "--queries", "4", "--device",
                        "cpu"])["store"]
    mesh = graph_mesh(["cpu"] * 4)
    for a, b in zip(D.shard_graph(store.current, mesh),
                    shard_rows(store.current, mesh)):
        assert torch.equal(a.adj, b.adj) and torch.equal(a.nodes, b.nodes)
        assert a.adj.shape == (12, 48)
    eg = store.edge_graph()
    assert isinstance(eg, EdgeGraph)
    e = 4 * (eg.e_cap // 4)
    eg = dataclasses.replace(eg, eu=eg.eu[:e], ev=eg.ev[:e],
                             emask=eg.emask[:e])
    for a, b in zip(D.shard_edge_graph(eg, mesh), shard_slots(eg, mesh)):
        assert torch.equal(a.emask, b.emask) and torch.equal(a.eu, b.eu)
        assert a.emask.shape == (e // 4,)
