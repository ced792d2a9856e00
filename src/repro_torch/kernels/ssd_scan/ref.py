"""Plain PyTorch versions of the SSD scan: the per-step recurrence (the
oracle) and the chunked dual form (the CPU path and the card's oracle
for ``ssd_scan.cu``).  ``repro_torch.models.ssm`` serves both under the
JAX package's names; they live here, beside the kernel, so that the
kernel package needs nothing of the model package.

Shapes: x [b, s, nh, P]; dt [b, s, nh]; a [nh]; B, C [b, s, N] (one
group); state [b, nh, P, N].  Everything float32 (or, for a float64
reference, everything float64).
"""
from __future__ import annotations

import torch


def ssd_sequential(x, dt, a, B, C, state0=None):
    """Oracle: the per-step recurrence.  Returns y [b, s, nh, P] and the
    final state [b, nh, P, N]."""
    b, s, nh, p = x.shape
    n = B.shape[-1]
    h = (torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device)
         if state0 is None else state0)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a[None, :])[..., None, None]
        upd = (dt[:, t, :, None, None] * x[:, t, :, :, None]
               * B[:, t, None, None, :])
        h = h * decay + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]))
    return torch.stack(ys, 1), h


def ssd_chunked(x, dt, a, B, C, chunk: int, state0=None):
    """Chunked SSD (dual form).  Same signature as ``ssd_sequential``;
    the sequence length must be a multiple of ``chunk``."""
    b, s, nh, p = x.shape
    n = B.shape[-1]
    q = chunk
    assert s % q == 0, (s, q)
    nc = s // q

    xc = x.reshape(b, nc, q, nh, p)
    dtc = dt.reshape(b, nc, q, nh)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)

    # a·dt, its within-chunk cumsum and every exponent formed from it in
    # float64, each rounded to the input's type once before the exp, as
    # ssd_scan.cu forms them: float32 cums lose most of cum_i − cum_j's
    # digits to cancellation (cum reaches −10^3 at mamba2-130m), which
    # dominated the float32 scan's error.  The cumsum is a product with
    # the lower-triangular ones matrix: ``torch.cumsum`` of floats has
    # no deterministic CUDA form (``torch.use_deterministic_algorithms``
    # refuses it), and the backward of training recomputes this scan
    tri64 = torch.tril(torch.ones((q, q), dtype=torch.float64,
                                  device=x.device))
    cum = torch.einsum("ij,bcjh->bcih", tri64,          # [b,nc,q,nh] ≤ 0
                       dtc.double() * a.double()[None, None, None, :])

    def exp(t):
        return torch.exp(t.to(x.dtype))

    # intra-chunk: y_ij = C_i·B_j · exp(cum_i − cum_j) · dt_j · x_j, j ≤ i
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)   # [b,nc,q,q]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,i,j,nh]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    # mask BEFORE exp: upper-triangle seg is positive-large
    decay = exp(torch.where(tri, seg, 0.0)) * tri
    lmat = cb[..., None] * decay                   # [b,nc,i,j,nh]
    dx = dtc[..., None] * xc                       # [b,nc,q,nh,p]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", lmat, dx)

    # chunk states: S_c = Σ_j exp(cum_last − cum_j) dt_j x_j ⊗ B_j
    last = cum[:, :, -1:, :]                       # [b,nc,1,nh]
    decay_to_end = exp(last - cum)                 # [b,nc,q,nh]
    sc = torch.einsum("bcjh,bcjhp,bcjn->bchpn", decay_to_end * dtc, xc, Bc)

    # inter-chunk recurrence over the nc chunks
    chunk_decay = exp(last[:, :, 0, :])            # [b,nc,nh]
    h = (torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device)
         if state0 is None else state0)
    h_ins = []                                     # state entering chunk
    for c in range(nc):
        h_ins.append(h)
        h = h * chunk_decay[:, c, :, None, None] + sc[:, c]
    h_in = torch.stack(h_ins, 1)                   # [b,nc,nh,p,n]

    # carried state: exp(cum_i) · C_i · h_in (the scale is applied after
    # the sum over N, so no [b,nc,q,nh,p,N] temporary is formed)
    y_inter = (torch.einsum("bcin,bchpn->bcihp", Cc, h_in)
               * exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(b, s, nh, p)
    return y, h
