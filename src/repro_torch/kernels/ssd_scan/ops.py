"""Wrapper of the chunked SSD scan kernel (``ssd_scan.cu``): operand
checks, the scratch its chunk-parallel steps share (the chunk states,
overwritten by the states entering each chunk; the in-chunk cumsum of
a·dt, kept in float64; C·Bᵀ within each chunk, once for all heads), the
launches on the current stream, and a ``torch.autograd.Function``
whose backward is the plain ``ssd_chunked`` through autograd, recomputed
from the saved inputs (the JAX package differentiates its jnp scan;
there is no backward kernel there either).  Takes the
model's own layout — the kernel forms dt·x and a·dt itself and reads
B/C once per batch, so nothing is transposed, broadcast to heads or
padded here (the caller pads the sequence to a chunk multiple with
dt = 0, as ``models/ssm.py::apply_ssm`` does).

The launches are the operator ``torch.ops.repro_torch.ssd_scan_fwd`` (a
``torch.library`` schema with a CUDA implementation, the leanest
dispatch that still takes a fake one): its fake implementation gives
the outputs' shapes and dtypes, so a step on fake CUDA tensors (the
dry-run, ``launch/dryrun.py``) traces through the kernel without
launching it, and its flop formula is the plain ``ssd_chunked``'s
count at the same shapes."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

MAX_HEADDIM = 64     # == PMAX in ssd_scan.cu
MAX_STATE = 128      # == NMAX in ssd_scan.cu


def ssd_scan(x, dt, a, b, c, chunk: int, state0=None):
    """``ssd_chunked``'s contract: x [B, S, H, P], dt [B, S, H], a [H],
    b/c [B, S, N], state0 [B, H, P, N] or None (zeros) → (y [B, S, H,
    P], final state [B, H, P, N]), all float32, S a multiple of
    ``chunk``.  CPU tensors run the plain version; CUDA tensors launch
    the kernel, differentiable in x, dt, a, b, c and state0."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, b, c, chunk, state0)
    return _SSDScan.apply(x, dt, a, b, c, chunk, state0)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk, state0):
        ctx.save_for_backward(x, dt, a, b, c, state0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd_scan_fwd(x, dt, a, b, c, chunk, state0)

    @staticmethod
    def backward(ctx, g_y, g_state):
        saved = [t for t in ctx.saved_tensors if t is not None]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in saved]
            outs = ssd_chunked(*ins[:5], ctx.chunk,
                               ins[5] if len(ins) > 5 else None)
            pairs = [(o, g) for o, g in zip(outs, (g_y, g_state))
                     if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        dx, ddt, da, db, dc = grads[:5]
        return (dx, ddt, da, db, dc, None,
                grads[5] if len(grads) > 5 else None)


def ssd_scan_fwd(x, dt, a, b, c, chunk: int, state0=None):
    """Launch the kernel on CUDA tensors (no autograd)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    build.check_cuda("x", x, torch.float32, 4)
    build.check_cuda("dt", dt, torch.float32, 3)
    build.check_cuda("a", a, torch.float32, 1)
    build.check_cuda("b", b, torch.float32, 3)
    build.check_cuda("c", c, torch.float32, 3)
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b.shape) != (bsz, s, n) or c.shape != b.shape):
        raise ValueError(f"ssd_scan shapes do not match: x {tuple(x.shape)}"
                         f" dt {tuple(dt.shape)} a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} c {tuple(c.shape)}")
    if p > MAX_HEADDIM or n > MAX_STATE or p % 4 or n % 4:
        raise ValueError(f"ssd_scan.cu takes a head dim <= {MAX_HEADDIM} "
                         f"and a state <= {MAX_STATE}, both multiples of 4, "
                         f"got {p} and {n}")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    if state0 is not None:
        build.check_cuda("state0", state0, torch.float32, 4)
        if tuple(state0.shape) != (bsz, h, p, n):
            raise ValueError(f"state0 must be [{bsz}, {h}, {p}, {n}]")
    build.check_same_device(x=x, dt=dt, a=a, b=b, c=c,
                            **({} if state0 is None else {"state0": state0}))
    return torch.ops.repro_torch.ssd_scan_fwd.default(x, dt, a, b, c,
                                                      int(chunk), state0)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan_fwd(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, "
            "int chunk, Tensor? state0) -> (Tensor, Tensor)")


def _launch(x, dt, a, b, c, chunk, state0):
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    s0 = (torch.empty(0, dtype=torch.float32, device=x.device)
          if state0 is None else state0)
    for name, t in (("x", x), ("b", b), ("c", c), ("state0", s0)):
        build.check_aligned(name, t)
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    chunks = torch.empty((bsz, h, s // chunk, p, n), dtype=torch.float32,
                         device=x.device)
    cum = torch.empty((bsz, h, s), dtype=torch.float64, device=x.device)
    ext = build.ext()
    cb = torch.empty((bsz, s // chunk, chunk, ext.ssd_scan_cb_stride(chunk)),
                     dtype=torch.float32, device=x.device)
    ext.ssd_scan(x, dt, a, b, c, s0, y, state, chunks, cum, cb, chunk,
                 build.stream_handle(x.device))
    build.LAUNCHES["ssd_scan"] += 1
    return y, state


_LIB.impl("ssd_scan_fwd", _launch, "CUDA")


@torch.library.register_fake("repro_torch::ssd_scan_fwd")
def _(x, dt, a, b, c, chunk, state0):
    bsz, _, h, p = x.shape
    return torch.empty_like(x), x.new_empty((bsz, h, p, b.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, *args,
           out_shape=None, **kwargs):
    """``ssd_chunked``'s products (the counter counts its ``bmm``s; the
    elementwise ones are free): the float64 cumsum as a product with the
    [Q, Q] ones matrix, C·Bᵀ, the intra-chunk sum, the chunk states and
    the carried state's read-out, with Q = ``chunk`` and nc = S / Q."""
    bsz, s, h, p = x_shape
    n, q = b_shape[-1], chunk
    nc = s // q
    return 2 * bsz * nc * (q * q * h + q * q * n + h * q * q * p
                           + 2 * h * p * n * q)
