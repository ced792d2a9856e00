"""The port's side of ``persist_harness``: its stream constants, the
proposal stream from the port's generator and the standard query grid,
importing only ``repro_torch`` — what the kill -9 children of
``test_torch_persist.py`` and ``test_torch_replica.py`` run on (the
harness itself generates with ``repro``).
``test_torch_persist.py::test_stream_matches_harness`` holds the two
streams equal.
"""
N_CAP = 48
N_NODES = 32
SEED = 11
SWAP_EVERY = 3
SEGMENT_MIN_OPS = 8
STREAM = dict(m_attach=3, lam_extra=1.0, lam_remove=1.0,
              p_remove_node=0.02, events_per_unit=6)


def proposal_units() -> list[list[tuple]]:
    """``persist_harness.proposal_units`` from the port's generator, as
    ``(op, u, v, t)`` tuples."""
    from repro_torch.core.generate import EvolutionParams, generate_ops
    ops = generate_ops(N_NODES, EvolutionParams(**STREAM), seed=SEED)
    units: dict[int, list] = {}
    for o in ops:
        units.setdefault(o.t, []).append((o.op, o.u, o.v, o.t))
    return [units[t] for t in sorted(units)]


def grid(t_lo: int, t_hi: int) -> list[dict]:
    """``test_persist._grid`` as ``Query`` keyword dicts: global counts,
    node degrees, a diff range at every unit of [t_lo, t_hi], and the
    degree distribution."""
    qs = []
    for t in range(t_lo, t_hi + 1):
        qs.append(dict(kind="point", scope="global", measure="num_edges",
                       t_k=t))
        qs.append(dict(kind="point", scope="global", measure="num_nodes",
                       t_k=t))
        for v in (0, 3, 7):
            qs.append(dict(kind="point", scope="node", measure="degree",
                           t_k=t, v=v))
        if t > t_lo:
            qs.append(dict(kind="diff", scope="node", measure="degree",
                           t_k=t_lo, t_l=t, v=1))
    qs.append(dict(kind="point", scope="global",
                   measure="degree_distribution", t_k=t_hi))
    return qs
