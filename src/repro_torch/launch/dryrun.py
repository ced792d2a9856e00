"""Placement of a training step's inputs on a mesh — the two helpers of
``repro/launch/dryrun.py`` that a mesh train step needs.

``batch_sharding`` splits every batch leaf's first axis over the
``batch`` axes where it divides; ``state_sharding`` places a training
state by ``sharding.PARAM_RULES``.  Both return ``{leaf name:
NamedSharding}`` (names as ``checkpoint.io.leaves`` gives them);
``sharding.place`` puts a tensor there.

The dry-run itself (``run_cell``, ``main``: lower every architecture ×
shape on the production meshes, with the roofline's terms) and the
decode caches' placement (``cache_sharding``) are not ported yet.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch import not_ported
from repro_torch.sharding import (NamedSharding, mesh_context, named_shardings,
                                  resolve)


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


def cache_sharding(tree, mesh):
    not_ported("cache_sharding (prefill and decode on a mesh)", "A17")


def run_cell(*args, **kwargs):
    not_ported("the multi-pod dry-run (launch/dryrun.py::run_cell)", "A18")


def main(argv=None):
    not_ported("the multi-pod dry-run (launch/dryrun.py::main)", "A18")


if __name__ == "__main__":
    sys.exit(main())
