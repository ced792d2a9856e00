"""Historical-query serving driver (the paper's workload) — counterpart
of ``repro/launch/serve.py``.

Builds a temporal graph store from the synthetic evolving-graph
generator, shards the current snapshot over the mesh's devices, and
serves batches of mixed historical queries with the plan matrix of
paper Table 2 (+ the distributed batched hybrid plan for point-degree
queries).  On the card the global queries run the two-phase plan, whose
reconstruction is the dense LWW kernel.

  python -m repro_torch.launch.serve --nodes 2000 --queries 64
  python -m repro_torch.launch.serve --device cpu   # the plain versions

The reference takes its device from JAX's default; here ``--device``
(default ``cuda``) names it, and the mesh is every visible card (or the
CPU once).  The step times are read on the host clock after the
device has finished the step.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import distributed as D
from repro_torch.core.generate import EvolutionParams, build_store
from repro_torch.core.plans import Query
from repro_torch.obs import clock


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(store, queries: list[Query], *, indexed: bool = True):
    """Each query through ``store.query`` (the node index for degree
    queries), answers as host numpy values."""
    out = []
    for q in queries:
        out.append(store.query(q, indexed=indexed and q.measure == "degree"))
    return [x.cpu().numpy() for x in out]


def mixed_queries(t_cur: int, vs, ts) -> list[Query]:
    """The five mixed plan-matrix queries the driver serves (point /
    diff / agg node degree, a point and a diff global measure)."""
    return [
        Query("point", "node", "degree", t_k=int(ts[0]), v=int(vs[0])),
        Query("diff", "node", "degree", t_k=int(t_cur * 0.25),
              t_l=int(t_cur * 0.75), v=int(vs[1])),
        Query("agg", "node", "degree", t_k=int(t_cur * 0.5),
              t_l=int(t_cur * 0.5) + 8, v=int(vs[2]), agg="mean"),
        Query("point", "global", "num_edges", t_k=int(t_cur * 0.5)),
        Query("diff", "global", "avg_degree", t_k=int(t_cur * 0.3),
              t_l=int(t_cur * 0.9)),
    ]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, mesh=None) -> dict:
    """Run the driver; ``mesh`` (a ``GraphMesh``) defaults to every
    visible card, or the CPU once.  Returns the store, the query batch
    (``vs``, ``ts``), the point degrees (``degrees``, host int32), the
    mixed queries and their answers (``mixed``, ``answers``) and the
    step times in seconds (``build_s``, ``batch_s``, ``mixed_s``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if mesh is None:
        mesh = D.graph_mesh() if dev.type == "cuda" else \
            D.graph_mesh([dev])

    rng = np.random.default_rng(args.seed)
    t0 = clock.now()
    store = build_store(args.nodes,
                        EvolutionParams(m_attach=4, lam_extra=1.0,
                                        lam_remove=1.0), seed=args.seed,
                        device=dev)
    _sync(dev)
    build_s = clock.now() - t0
    print(f"built store in {build_s:.1f}s:", store.stats())

    g = D.shard_graph(store.current, mesh)
    d = store.delta()

    # batched distributed point-degree queries (hybrid plan)
    vs = rng.integers(0, args.nodes, args.queries).astype(np.int32)
    ts = rng.integers(1, store.t_cur, args.queries).astype(np.int32)
    t0 = clock.now()
    deg = D.dist_batch_point_degree(mesh, g, d, vs, ts, store.t_cur)
    deg = deg.cpu().numpy()
    batch_s = clock.now() - t0
    print(f"served {args.queries} point-degree queries in "
          f"{batch_s*1e3:.1f} ms "
          f"({batch_s/args.queries*1e6:.0f} us/query)")

    # mixed single queries through the plan matrix
    mixed = mixed_queries(store.t_cur, vs, ts)
    t0 = clock.now()
    res = serve_batch(store, mixed)
    mixed_s = clock.now() - t0
    print(f"mixed plans in {mixed_s*1e3:.1f} ms:",
          [np.round(np.asarray(r), 3).tolist() for r in res])
    return dict(store=store, mesh=mesh, vs=vs, ts=ts, degrees=deg,
                mixed=mixed, answers=res, build_s=build_s,
                batch_s=batch_s, mixed_s=mixed_s)


if __name__ == "__main__":
    main()
