"""Wrapper of the flash-attention forward kernel
(``flash_attention.cu``): operand checks, the launch on the current
stream, and a ``torch.autograd.Function`` whose backward is the plain
version through autograd (the JAX package's ``custom_vjp``; there is no
backward kernel, on the TPU either).

The kernel reads q/k/v through their strides (the head dim must be
unit-stride) and masks ragged sequence edges itself, so ``[B, S, H, D]``
activations go in as ``.transpose(1, 2)`` views without copies or
padding.  The bfloat16 instance copies rows in 16-byte pieces, so it
needs 16-byte aligned operands with strides of whole 8-element pieces;
a layout it cannot take raises here (nothing is copied to make it
fit).

The kernel is built for the head dims in ``HEAD_DIMS``.  Any other head
dim up to the largest (kimi-k2's 112) runs at the next one: q, k and v
get zero columns (``pad_head_dim``) and the output's extra columns are
sliced off.  The caller's ``scale`` is explicit, the zero columns add
nothing to q·kᵀ, and the kept columns of P·V are those of the unpadded
product; the backward, through the plain version on the saved unpadded
q, k and v, is the unpadded function's.

The launch is the operator ``torch.ops.repro_torch.flash_attention_fwd``
(a ``torch.library`` schema with a CUDA implementation, the leanest
dispatch that still takes a fake one): its fake implementation gives
the output's shape and dtype, so a step on fake CUDA tensors (the dry-run,
``launch/dryrun.py``) traces through the kernel without launching it,
and its flop formula is the plain version's count at the same shapes
(every masked score included, as ``attention_ref`` computes them)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128, 256)     # the instances flash_attention.cu has
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    kv_len: int | None = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] → [B, Hq, Sq, D].

    Query row i is position i, key j position j; ``kv_len`` masks keys
    at and past it.  CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, kv_len=kv_len)
    return _FlashAttention.apply(q, k, v, causal, window, scale, kv_len)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale, kv_len)
        return flash_attention_fwd(q, k, v, causal, window, scale, kv_len)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale, kv_len = ctx.args
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = attention_ref(q, k, v, causal=causal, window=window,
                                scale=scale, kv_len=kv_len)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def pad_head_dim(*ts: torch.Tensor) -> list[torch.Tensor]:
    """``ts`` [..., D] with zero columns up to the least of HEAD_DIMS that
    holds D (unchanged when D is one of them); raises above the largest."""
    d = ts[0].shape[-1]
    to = next((h for h in HEAD_DIMS if h >= d), None)
    if to is None:
        raise ValueError(f"head_dim {d} > {HEAD_DIMS[-1]}, the largest "
                         "the kernel takes")
    return [F.pad(t, (0, to - d)) if to != d else t for t in ts]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-D [B, H, S, D], got shape "
                         f"{tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a unit-stride head dim")


def flash_attention_fwd(q, k, v, causal: bool, window: int | None,
                        scale: float, kv_len: int | None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (no autograd)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         "kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    build.check_same_device(q=q, k=k, v=v)
    return torch.ops.repro_torch.flash_attention_fwd.default(
        q, k, v, bool(causal), window, float(scale), kv_len)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int? window, float scale, int? kv_len) -> Tensor")


def _launch(q, k, v, causal, window, scale, kv_len):
    d = q.shape[-1]
    q, k, v = pad_head_dim(q, k, v)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            build.check_aligned(name, t, 8)
    out = torch.empty_like(q)           # keeps q's (transposed) strides
    if out.numel() == 0:
        return out[..., :d]
    n_keys = k.shape[2] if kv_len is None else max(0, min(int(kv_len),
                                                          k.shape[2]))
    build.ext().flash_attention(q, k, v, out, causal, int(window or 0),
                                n_keys, scale, build.stream_handle(q.device))
    build.LAUNCHES["flash_attention"] += 1
    return out[..., :d]


_LIB.impl("flash_attention_fwd", _launch, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_fwd")
def _(q, k, v, causal, window, scale, kv_len):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs):
    """``attention_ref``'s two products, q·kᵀ and p·v, over every score
    (masked ones included): 2 · 2 · B · Hq · Sq · Skv · D."""
    b, hq, sq, d = q_shape
    return 4 * b * hq * sq * k_shape[2] * d
