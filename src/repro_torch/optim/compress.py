"""Gradient compression for the data-parallel all-reduce — counterpart
of ``repro/optim/compress.py``, the same arithmetic.

int8 symmetric quantization with *error feedback*: the quantization
residual is carried to the next step so the compressed reduction stays
unbiased over time.  ``torch.round`` rounds half to even, as
``jnp.round`` does.

``compressed_psum`` is the reference's ``shard_map`` body: each process
holds its own gradients (plain tensors) and the sum runs over the
process group of one dimension of the mesh in scope — an
``all_reduce(MAX)`` of each leaf's scale, then an int32
``all_reduce(SUM)``.  As in the reference, a leaf that is all zero on a
process has scale 1.0 there, and the max makes every process quantize
that leaf against at least 1.0.  Nothing in the trainer calls it
(``TrainConfig.grad_compression`` is carried, as in the reference).
"""
from __future__ import annotations

import torch


def int8_compress(x: torch.Tensor):
    a = x.abs().max() / 127.0
    a = torch.where(a > 0, a, torch.ones_like(a))
    q = torch.clamp(torch.round(x / a), -127, 127).to(torch.int8)
    return q, a.float()


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, err: torch.Tensor):
    """Returns (q, scale, new_err). grad+err is quantized; the residual
    becomes the next step's error feedback."""
    g = grad.float() + err
    q, scale = int8_compress(g)
    new_err = g - int8_decompress(q, scale)
    return q, scale, new_err


def _map2(fn, a, b):
    if isinstance(a, dict):
        outs = {k: _map2(fn, a[k], b[k]) for k in a}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    return fn(a, b)


def compressed_psum(grads, errs, axis_name: str):
    """Sum int8-compressed ``grads`` (a tensor or a dict of them, this
    process's) over mesh dimension ``axis_name`` of the mesh in scope.
    Per-leaf scales are max-reduced first so that dequantization is
    consistent across processes.  Returns (sums, new errs)."""
    import torch.distributed as dist

    from repro_torch.sharding import current_mesh
    group = current_mesh().get_group(axis_name)

    def one(g, e):
        _, scale, _ = compress_with_feedback(g, e)
        # shared scale: use the max across participants
        smax = scale.clone()
        dist.all_reduce(smax, dist.ReduceOp.MAX, group=group)
        # requantize against shared scale to keep the sum exact in int32
        ge = g.float() + e
        gq = torch.clamp(torch.round(ge / smax), -127, 127).to(torch.int32)
        total = gq.clone()
        dist.all_reduce(total, dist.ReduceOp.SUM, group=group)
        out = total.float() * smax
        new_e = ge - gq.float() * smax
        return out, new_e

    return _map2(one, grads, errs)
