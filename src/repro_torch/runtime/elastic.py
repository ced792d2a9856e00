"""Elastic scaling: reshard a training state onto a different mesh —
counterpart of ``repro/runtime/elastic.py``.

Checkpoints are logical (host arrays keyed by leaf name —
``checkpoint/io.py``), so a restore onto a new mesh is: load → place
with the new mesh's shardings (``sharding.named_shardings`` re-resolves
the logical axes against the new axis sizes, dropping what no longer
divides).  A leaf already on a mesh is gathered first, so the same call
moves a state between meshes.
"""
from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from repro_torch.sharding import named_shardings, place


def place_tree(tree, sh: dict, prefix: str = "", *, local: bool = False):
    """``tree`` (a state, a batch, decode caches: modules, dataclasses,
    dicts, lists, tensors) with every tensor placed per ``sh`` ({leaf
    name: NamedSharding}, as ``sharding.named_shardings`` or
    ``launch.dryrun.batch_sharding`` / ``cache_sharding`` give it; a
    list's items named by index); a module is copied with new
    parameters.  ``local``: each process keeps its chunk of its own
    tensors (``sharding.place``)."""
    if isinstance(tree, nn.Module):
        memo = {id(p): nn.Parameter(
                    place(p.detach(), s.mesh, s.spec, local=local),
                    requires_grad=p.requires_grad)
                for name, p in tree.named_parameters()
                for s in (sh[prefix + name],)}
        return copy.deepcopy(tree, memo)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: place_tree(getattr(tree, f.name), sh,
                               f"{prefix}{f.name}/", local=local)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: place_tree(v, sh, f"{prefix}{k}/", local=local)
                for k, v in tree.items()}
    if isinstance(tree, list):     # decode caches, one dict a group
        return [place_tree(v, sh, f"{prefix}{i}/", local=local)
                for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor):
        s = sh[prefix[:-1]]
        return place(tree, s.mesh, s.spec, local=local)
    return tree


def reshard_state(state, mesh):
    """``state`` with every tensor placed per the param rules on
    ``mesh`` (a new state; ``state`` is left as it was)."""
    return place_tree(state, named_shardings(state, mesh))


def reshard_from_checkpoint(store, step, template, mesh):
    state = store.restore(step, template)
    return reshard_state(state, mesh)
