"""Mamba2 (SSD — state-space duality) blocks, attention-free sequence
mixing — counterpart of ``repro/models/ssm.py``.

The SSD recurrence per head (state N = cfg.ssm_state, headdim P):

    h_t = exp(a·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t        (h: [P, N])
    y_t = C_t · h_t + D · x_t

Prefill runs the chunked dual form through ``kernels.ssd_scan``: on the
card the hand-written kernel, on the CPU ``ssd_chunked``.  Decode is the
O(1) recurrence on a carried (conv_state, ssm_state) cache, plain
PyTorch.  ``ssd_sequential`` (per-step) is the oracle for
``ssd_chunked``; both are plain and live beside the kernel.

On a mesh the block runs under ``local_map`` on each process's batch
rows with every head whole (``_on_rows``).  The reference leaves it
to GSPMD, with ``in_proj`` and ``conv`` split on the model axis; those
splits cut through z / xBC / dt and through the xs and B / C channels,
so a model shard holds no whole head.  Its caches sit where the
reference's ``cache_sharding`` puts them: conv and state split by batch
where it divides, the state's heads over ``model``.  Prefill returns the
local scan's final state and conv tail there; a decode step regathers
the state's heads over ``model``, steps each process's rows with whole
heads and splits the state again.  (The other layout, a step on split
heads, would sum the gated norm's squares over ``model`` — it reduces
over all of ``d_inner`` — and split ``in_proj`` / ``conv`` / ``out_proj``
by head, which the parameters' own placement does not do.)
"""
from __future__ import annotations

import dataclasses
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan, ssd_sequential
from repro_torch.models.layers import _normal, at_least_f32, params_module
from repro_torch.sharding import (batch_cache_spec, current_mesh,
                                  on_local_shards, place, spec,
                                  ssm_state_spec)

__all__ = ["SSMCache", "apply_ssm", "decode_ssm", "init_ssm",
           "init_ssm_cache", "ssd_chunked", "ssd_sequential"]


def init_ssm(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    d = cfg.d_model
    d_in = cfg.d_inner()
    nh = cfg.ssm_nheads()
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n  # x, B, C go through the causal conv
    # in_proj emits [z (d_in), x (d_in), B (n), C (n), dt (nh)]
    d_proj = 2 * d_in + 2 * n + nh
    f32 = dict(dtype=torch.float32, device=device)
    return params_module(
        in_proj=_normal(gen, (d, d_proj), d ** -0.5, dtype, device),
        conv=_normal(gen, (cfg.ssm_conv, conv_dim), cfg.ssm_conv ** -0.5,
                     dtype, device),
        A_log=torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        D=torch.ones((nh,), **f32),
        dt_bias=torch.zeros((nh,), **f32),
        norm_scale=torch.ones((d_in,), dtype=dtype, device=device),
        out_proj=_normal(gen, (d_in, d), d_in ** -0.5, dtype, device))


@dataclasses.dataclass
class SSMCache:
    conv: torch.Tensor   # [B, conv_w − 1, conv_dim]
    state: torch.Tensor  # [B, nh, P, N] (float32)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device) -> SSMCache:
    conv_dim = cfg.d_inner() + 2 * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_nheads(), cfg.ssm_headdim,
                           cfg.ssm_state), dtype=torch.float32,
                          device=device))


def _split_proj(proj, cfg: ModelConfig):
    d_in = cfg.d_inner()
    n = cfg.ssm_state
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * n]
    dt = proj[..., d_in + d_in + 2 * n:]
    assert dt.shape[-1] == cfg.ssm_nheads()
    return z, xbc, dt


def _causal_conv(xbc, conv_w, prev=None):
    """Depthwise causal conv over [B, S, C] with kernel [W, C].  The taps
    are summed in the input dtype, left to right, as in the JAX
    package."""
    w = conv_w.shape[0]
    pad = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[2])) \
        if prev is None else prev
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i:i + xbc.shape[1]] * conv_w[i][None, None]
              for i in range(w))
    new_prev = xp[:, xp.shape[1] - (w - 1):]
    return F.silu(out), new_prev


def _gated_norm(y, z, scale, dtype):
    """Mamba2's gated RMSNorm: norm(y · silu(z)) · scale."""
    y = y * F.silu(z)
    yf = at_least_f32(y)
    return (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
            ).to(dtype) * scale


# the block's parameters, in the order ``_on_rows`` passes them
_PARAMS = ("in_proj", "conv", "A_log", "D", "dt_bias", "norm_scale",
           "out_proj")


def apply_ssm(p: nn.Module, x: torch.Tensor, cfg: ModelConfig,
              cache: SSMCache | None = None, return_cache: bool = False):
    """Full-sequence Mamba2 block. x: [B, S, d] → [B, S, d]."""
    if current_mesh() is None:
        return _apply_ssm(p, x, cfg, cache, return_cache)
    return _on_rows(lambda q, xl, c: _apply_ssm(q, xl, cfg, c, return_cache),
                    p, x, cache, return_cache)


def _on_rows(step, p: nn.Module, x: torch.Tensor, cache: SSMCache | None,
             return_cache: bool):
    """``step(params, x, cache)`` → (out, cache) (``_apply_ssm`` or
    ``_decode_ssm``) under ``local_map`` on the mesh in scope: x and the
    output split by batch as the reference's ``shard(out, "batch",
    None, None)`` resolves, the block's parameters replicated (their
    gradients summed over the batch split by ``on_local_shards``), each
    process's rows with every head whole; a cache read or returned has
    those rows and every head.  A returned cache is placed by the
    reference's cache rules (``sharding.batch_cache_spec`` for conv,
    ``ssm_state_spec`` for the state: its heads split again over
    ``model``)."""
    mesh = current_mesh()
    rows = spec("batch", None, None, dims=x.shape)
    conv_sp, state_sp = (rows[0], None, None), (rows[0], None, None, None)
    ws = [getattr(p, n) for n in _PARAMS]
    held = () if cache is None else (cache.conv, cache.state)

    def local(xl, *rest):
        c = SSMCache(*rest[:len(held)]) if held else None
        out, new = step(types.SimpleNamespace(**dict(zip(
            _PARAMS, rest[len(held):]))), xl, c)
        return (out, new.conv, new.state) if return_cache else out

    in_sps = (rows, *((conv_sp, state_sp) if held else ()),
              *((None,) * w.dim() for w in ws))
    if not return_cache:
        return on_local_shards(local, rows, in_sps, x, *held, *ws), None
    out, conv, state = on_local_shards(local, [rows, conv_sp, state_sp],
                                       in_sps, x, *held, *ws)
    return out, SSMCache(
        place(conv, mesh, batch_cache_spec(tuple(conv.shape))),
        place(state, mesh, ssm_state_spec(tuple(state.shape))))


def _apply_ssm(p, x: torch.Tensor, cfg: ModelConfig,
               cache: SSMCache | None, return_cache: bool):
    """``apply_ssm`` on tensors of one device."""
    b, s, _ = x.shape
    d_in = cfg.d_inner()
    nh, pd, n = cfg.ssm_nheads(), cfg.ssm_headdim, cfg.ssm_state
    proj = x @ p.in_proj
    z, xbc, dt = _split_proj(proj, cfg)
    conv_out, conv_state = _causal_conv(
        xbc, p.conv, None if cache is None else cache.conv)
    xs = conv_out[..., :d_in].reshape(b, s, nh, pd)
    Bs = conv_out[..., d_in:d_in + n]
    Cs = conv_out[..., d_in + n:]
    dt = F.softplus(at_least_f32(dt) + p.dt_bias[None, None])
    a = -torch.exp(p.A_log)

    state0 = None if cache is None else cache.state
    # pad the sequence to a chunk multiple; padded steps carry dt = 0 so
    # they leave the SSM state untouched (exp(0·a) = 1, update = 0)
    q = min(cfg.ssm_chunk, s) if s % min(cfg.ssm_chunk, s) == 0 \
        else cfg.ssm_chunk
    pad = (-s) % q
    xsf = F.pad(at_least_f32(xs), (0, 0, 0, 0, 0, pad))
    dtp = F.pad(dt, (0, 0, 0, pad))
    Bp = F.pad(at_least_f32(Bs), (0, 0, 0, pad))
    Cp = F.pad(at_least_f32(Cs), (0, 0, 0, pad))
    y, h = ssd_scan(*(t.contiguous() for t in (xsf, dtp, a, Bp, Cp)), q,
                    state0)
    y = y[:, :s]
    y = y + p.D[None, None, :, None] * at_least_f32(xs)
    y = _gated_norm(y.reshape(b, s, d_in).to(x.dtype), z, p.norm_scale,
                    x.dtype)
    out = y @ p.out_proj
    if return_cache:
        return out, SSMCache(conv=conv_state, state=h)
    return out, None


def decode_ssm(p: nn.Module, x: torch.Tensor, cfg: ModelConfig,
               cache: SSMCache):
    """One-token step. x: [B, 1, d]. O(1) in context length.  Returns
    (out, cache) with the cache's tensors replaced.  On a mesh each
    process steps its batch rows with every head whole: the state,
    placed with its heads split over ``model`` (``ssm_state_spec``), is
    gathered over ``model`` for the step and split again after it
    (``_on_rows``; the layout the module docstring gives)."""
    if current_mesh() is None:
        return _decode_ssm(p, x, cfg, cache)
    out, new = _on_rows(lambda q, xl, c: _decode_ssm(q, xl, cfg, c),
                        p, x, cache, True)
    cache.conv, cache.state = new.conv, new.state
    return out, cache


def _decode_ssm(p, x: torch.Tensor, cfg: ModelConfig, cache: SSMCache):
    """``decode_ssm`` on tensors of one device."""
    b = x.shape[0]
    d_in = cfg.d_inner()
    nh, pd, n = cfg.ssm_nheads(), cfg.ssm_headdim, cfg.ssm_state
    proj = x @ p.in_proj
    z, xbc, dt = _split_proj(proj, cfg)
    conv_out, conv_state = _causal_conv(xbc, p.conv, cache.conv)
    xs = conv_out[..., :d_in].reshape(b, 1, nh, pd)[:, 0]
    Bs = conv_out[:, 0, d_in:d_in + n]
    Cs = conv_out[:, 0, d_in + n:]
    dt = F.softplus(at_least_f32(dt) + p.dt_bias[None, None])[:, 0]
    a = -torch.exp(p.A_log)

    decay = torch.exp(dt * a[None, :])[..., None, None]
    upd = (dt[..., None, None] * at_least_f32(xs)[..., None]
           * at_least_f32(Bs)[:, None, None, :])
    h = cache.state * decay + upd
    y = torch.einsum("bhpn,bn->bhp", h, at_least_f32(Cs))
    y = y + p.D[None, :, None] * at_least_f32(xs)
    y = _gated_norm(y.reshape(b, 1, d_in).to(x.dtype), z, p.norm_scale,
                    x.dtype)
    cache.conv, cache.state = conv_state, h
    return y @ p.out_proj, cache
