"""Placement of a step's inputs on a mesh — the three helpers of
``repro/launch/dryrun.py`` that mesh training and serving need.

``batch_sharding`` splits every batch leaf's first axis over the
``batch`` axes where it divides; ``state_sharding`` places a training
state (or a model) by ``sharding.PARAM_RULES``; ``cache_sharding``
places decode caches by the reference's cache rules
(``sharding.cache_spec``).  Each returns ``{leaf name: NamedSharding}``
(names as ``checkpoint.io.leaves`` gives them; a cache's as
``cache_leaves``); ``sharding.place`` puts a tensor there and
``runtime.elastic.place_tree`` a whole tree.

The dry-run itself (``run_cell``, ``main``: lower every architecture ×
shape on the production meshes, with the roofline's terms) is not
ported yet.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch import not_ported
from repro_torch.sharding import (NamedSharding, cache_spec, mesh_context,
                                  named_shardings, resolve)


def batch_sharding(tree, mesh) -> dict:
    from repro_torch.checkpoint.io import leaves
    with mesh_context(mesh):
        out = {}
        for name, leaf in leaves(tree):
            shape = np.shape(leaf)
            out[name] = NamedSharding(mesh, (resolve("batch", shape[0]),)
                                      + (None,) * (len(shape) - 1))
        return out


def state_sharding(state, mesh) -> dict:
    return named_shardings(state, mesh)


def cache_leaves(caches):
    """(name, name within its group, leaf) for every tensor of decode
    caches as ``models.api.prefill`` returns them (one dict a group, or
    a decoder layer: ``0/l0/k``, ``0/l0/pos_map``, ``3/xk``)."""
    from repro_torch.checkpoint.io import leaves
    for g, group in enumerate(caches):
        for rel, leaf in leaves(group):
            yield f"{g}/{rel}", rel, leaf


def cache_sharding(tree, mesh) -> dict:
    """Decode caches' placement (the reference's ``cache_sharding`` on
    its stacked caches, ``sharding.cache_spec`` with the group entry
    dropped): ``{leaf name: NamedSharding}`` for the leaves of
    ``cache_leaves``, as ``runtime.elastic.place_tree`` takes it."""
    with mesh_context(mesh):
        return {name: NamedSharding(mesh, cache_spec(rel, np.shape(leaf)))
                for name, rel, leaf in cache_leaves(tree)}


def run_cell(*args, **kwargs):
    not_ported("the multi-pod dry-run (launch/dryrun.py::run_cell)", "A18")


def main(argv=None):
    not_ported("the multi-pod dry-run (launch/dryrun.py::main)", "A18")


if __name__ == "__main__":
    sys.exit(main())
