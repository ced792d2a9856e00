"""State <-> disk (npz of named arrays) — counterpart of
``repro/checkpoint/io.py``, and the npz format is the reference's:
one array per leaf, bfloat16 leaves stored as their uint16 bit
patterns under ``<name>::bf16``.

A state is a tree of dicts, ``dataclasses`` (``TrainState``,
``AdamWState``, ``QTensor``), ``nn.Module``s, tensors, numpy arrays and
Python ints.  Leaf names join the path with ``/``; a module contributes
its ``named_parameters`` names (``params/groups.0.l0.attn.wq``), a
Python int is stored as an int32 scalar.  The JAX package names the
same leaves by its tree paths, with every group stacked on one axis;
``repro_torch.convert`` maps one naming onto the other.

bfloat16 goes through 16-bit integer views in both directions (numpy
has no bfloat16, and ``ml_dtypes`` is not used).

A state on a mesh (DTensor leaves) is written gathered — every process
of the mesh must take part, each gets the whole arrays — and a
template's DTensor leaf is filled by placing the loaded array as that
leaf is placed.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from repro_torch.optim.adamw import stack_key

BF16 = "::bf16"


def leaves(tree, prefix: str = ""):
    """(name, leaf) for every leaf of ``tree``, in a fixed order."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), f"{prefix}{f.name}/")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def stacked_copy(key: str) -> bool:
    """Whether the npz entry ``key`` repeats another entry: a later
    slice's copy of the one int8 scale of a leaf the JAX package stacks
    (``opt/m/<stack>.<i>.<rest>/scale``, i > 0, for a prefix of
    ``optim.adamw.STACKED``; the optimizer quantizes a stacked leaf's
    slices against one absmax).  The delta store counts such an entry
    once, as the JAX package does its stacked leaf."""
    segs = key.split("/")
    if segs[:1] != ["opt"] or segs[-1] != "scale" or len(segs) != 4:
        return False
    return stack_key(segs[2]) != segs[2] and segs[2].split(".")[1] != "0"


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a loaded array) on ``like``'s device, or placed as ``like``
    is on its mesh."""
    if _is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.sharding import mesh_device
        mesh = like.device_mesh
        return distribute_tensor(t.to(mesh_device(mesh)), mesh,
                                 like.placements)
    return t.to(like.device)


def raw_arrays(tree) -> dict[str, np.ndarray]:
    """``tree``'s leaves as the npz stores them: ``name`` → array, or
    ``name::bf16`` → uint16 bits for a bfloat16 tensor."""
    out = {}
    for name, leaf in leaves(tree):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        out[name + (BF16 if bf16 else "")] = to_numpy(leaf)
    return out


def to_tensor(key: str, arr: np.ndarray) -> torch.Tensor:
    """An npz entry as a tensor (``::bf16`` bits back to bfloat16)."""
    if key.endswith(BF16):
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_pytree(tree, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **raw_arrays(tree))


def load_raw(path: str) -> dict[str, np.ndarray]:
    """The npz's entries as stored (``::bf16`` names kept)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_arrays(path: str) -> dict[str, torch.Tensor]:
    """Flat {name: tensor} (bf16 round-trip restored)."""
    return {k[:-len(BF16)] if k.endswith(BF16) else k: to_tensor(k, a)
            for k, a in load_raw(path).items()}


def _take(tensors: dict, name: str, like) -> torch.Tensor:
    if name not in tensors:
        raise KeyError(f"checkpoint missing {name}")
    t = tensors[name]
    if isinstance(like, torch.Tensor):
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} != "
                             f"{tuple(like.shape)} {like.dtype}")
    return t


def fill(template, tensors: dict[str, torch.Tensor], prefix: str = ""):
    """``template``'s structure holding ``tensors`` (names as
    ``leaves`` gives them): module parameters are overwritten in place,
    every other container is rebuilt with tensors on the template
    leaves' devices and ints as ints.  Shapes and dtypes must match."""
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for name, p in template.named_parameters():
                p.copy_(_placed_like(_take(tensors, prefix + name, p), p))
        return template
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: fill(getattr(template, f.name), tensors,
                         f"{prefix}{f.name}/")
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: fill(v, tensors, f"{prefix}{k}/")
                for k, v in template.items()}
    name = prefix[:-1]
    t = _take(tensors, name, template)
    if isinstance(template, torch.Tensor):
        return _placed_like(t, template)
    if isinstance(template, (bool, int)):
        return int(t)
    return t.numpy()


def load_into(template, path: str):
    """Load the arrays at ``path`` into the structure of ``template``."""
    return fill(template, load_arrays(path))
