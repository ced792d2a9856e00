"""Mixture-of-experts FFN with sparse (gather / scatter) dispatch —
counterpart of ``repro/models/moe.py`` (``_apply_moe_dense`` off a mesh,
``apply_moe_sharded`` / ``_local_moe`` on one).

Top-k routing with a fixed per-expert capacity: the (token, choice)
pairs are sorted by expert, each gets a slot ``(expert, position within
the expert)``, and pairs past the capacity are dropped (their weight is
not renormalized away: a dropped pair contributes nothing).  The
arithmetic follows the reference step by step, so that the two packages
route alike and agree bit for bit where their products do:

* the router is a float32 product (TF32 stays off on the card);
* top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
  does: the first k of a stable descending sort (``torch.topk`` promises
  no order among ties on CUDA);
* the slot order is a stable ``argsort`` by expert and a left
  ``searchsorted``; a dropped pair's slot is the one overflow row
  ``E·cap``, which is kept and sliced off (never an out-of-range index);
* the experts run one at a time in the input dtype (bounding the
  ``[cap, d_ff]`` intermediates);
* the combine sums each token's k weighted contributions in ascending
  expert order, one add at a time in the input dtype, starting from
  zero — the order the reference's scatter-add takes them in on the
  CPU.  ``index_add_`` is not used: its order is nondeterministic on
  CUDA.

Every step is allowed under ``torch.use_deterministic_algorithms(True)``
and differentiable through autograd (the indices carry no gradient).

On a mesh ``apply_moe`` takes ``apply_moe_sharded``, as the reference
does whenever a mesh is in scope: expert parallelism under ``local_map``.
Each process routes its own batch rows over every expert at the
capacity of those rows, runs only the experts it holds
(``moe_partial``, the reference's ``_local_moe`` without its ``psum``),
and the parts are summed over the expert (and expert-ff) axes.  The
reference's ``REPRO_MOE_DENSE`` switch to the single-device path on a
mesh is not ported (DTensor has no sharded scatter for it to fall back
on).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import _normal, at_least_f32, ffn, \
    params_module
from repro_torch.sharding import (_mesh_axis_sizes, axes_of, current_mesh,
                                  grad_summed_over, on_local_shards, place,
                                  resolve, shard_index, sum_over)


class MoE(nn.Module):
    """The MoE FFN's parameters (the JAX param dict's keys): ``wg``
    (float32 ``[d, E]``), ``w_up`` and ``w_gate`` (``[E, d, f]``;
    ``w_gate`` for swiglu / geglu only) and ``w_down`` (``[E, f, d]``).
    Calling it runs ``apply_moe``, so a forward hook on it sees every
    MoE call's input."""

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return apply_moe(self, x, cfg)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             device) -> MoE:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    si, so = d ** -0.5, f ** -0.5
    p = dict(wg=_normal(gen, (d, e), si, torch.float32, device),
             w_up=_normal(gen, (e, d, f), si, dtype, device),
             w_down=_normal(gen, (e, f, d), so, dtype, device))
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = _normal(gen, (e, d, f), si, dtype, device)
    return params_module(MoE(), **p)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: the reference's Python
    float arithmetic, padded to a multiple of 8 (at least 8)."""
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


class Route(NamedTuple):
    """One MoE call's routing of ``T`` tokens.  ``order``, ``keep`` and
    ``slot`` are over the ``T·k`` (token, choice) pairs sorted stably by
    expert; pair ``i`` of the sorted list is token ``order[i] // k``."""
    logits: torch.Tensor    # [T, E] float32 router logits
    topi: torch.Tensor      # [T, k] chosen experts, best first
    weights: torch.Tensor   # [T, k] float32 softmax over the k chosen
    order: torch.Tensor     # [T·k] pair indices (t·k + choice), by expert
    keep: torch.Tensor      # [T·k] the pair fits its expert's capacity
    slot: torch.Tensor      # [T·k] expert·cap + position, or E·cap
    cap: int


def route(p: nn.Module, xt: torch.Tensor, cfg: ModelConfig) -> Route:
    """Route the tokens ``xt`` ``[T, d]`` to their top-k experts."""
    return route_by(p.wg, xt, cfg)


def route_by(wg: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig) -> Route:
    """``route`` with the router weight ``wg`` ``[d, E]`` given."""
    logits = at_least_f32(xt) @ wg
    topi = torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, :cfg.top_k]
    return route_to(logits, topi, cfg)


def route_to(logits: torch.Tensor, topi: torch.Tensor,
             cfg: ModelConfig) -> Route:
    """The routing of tokens with router ``logits`` ``[T, E]`` to the
    experts ``topi`` ``[T, k]`` (best first): the softmax over the k
    chosen logits, the slot order and the capacity cut."""
    t, k = topi.shape
    e = cfg.n_experts
    weights = torch.softmax(torch.gather(logits, -1, topi), dim=-1)
    e_flat = topi.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    seg_start = torch.searchsorted(
        e_sorted, torch.arange(e, dtype=e_sorted.dtype,
                               device=logits.device), right=False)
    pos_in_e = torch.arange(t * k, device=logits.device) - seg_start[e_sorted]
    cap = capacity(cfg, t)
    keep = pos_in_e < cap
    slot = torch.where(keep, e_sorted * cap + pos_in_e,
                       torch.full_like(pos_in_e, e * cap))
    return Route(logits, topi, weights, order, keep, slot, cap)


def apply_moe(p: nn.Module, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, d] → [B, S, d]; on a mesh ``apply_moe_sharded``."""
    if current_mesh() is not None:
        return apply_moe_sharded(p, x, cfg)
    return apply_routed(p, x, route(p, x.reshape(-1, x.shape[-1]), cfg),
                        cfg)


def apply_routed(p: nn.Module, x: torch.Tensor, r: Route,
                 cfg: ModelConfig) -> torch.Tensor:
    """The experts and the combine for ``x`` [B, S, d] routed by ``r``."""
    b, s, d = x.shape
    return experts(x.reshape(b * s, d), r, p.w_up, getattr(p, "w_gate", None),
                   p.w_down, cfg.mlp_kind).view(b, s, d)


def experts(xt: torch.Tensor, r: Route, w_up, w_gate, w_down,
            kind: str) -> torch.Tensor:
    """Dispatch, expert FFNs and combine of the tokens ``xt`` [T, d]
    routed by ``r``, over the experts whose weights are given (their
    first dimension; ``r``'s slots index ``[experts · cap + 1]``)."""
    n_e, d = w_up.shape[0], xt.shape[1]
    k, cap = r.topi.shape[1], r.cap
    # dispatch: a scatter into [n_e·cap + 1, d]; only pairs not kept
    # share an index (the overflow row, sliced off), and they carry zeros
    buf = xt.new_zeros((n_e * cap + 1, d))
    buf[r.slot] = xt[r.order // k] * r.keep[:, None].to(xt.dtype)
    he = buf[:n_e * cap].view(n_e, cap, d)

    # the experts, one at a time; a zero row stands for the overflow row
    flat = torch.cat(
        [ffn(he[i], w_up[i], w_down[i], kind,
             None if w_gate is None else w_gate[i]) for i in range(n_e)]
        + [xt.new_zeros((1, d))])
    return combine(flat, r)


def local_route(r: Route, e0: int, e_loc: int) -> Route:
    """``r`` restricted to the experts ``e0 .. e0 + e_loc − 1`` (one
    process's): a kept pair of theirs takes the slot ``(e − e0)·cap +
    pos`` of the local buffer; every other pair is not kept and takes
    the overflow row ``e_loc·cap``."""
    e_sorted = r.topi.reshape(-1)[r.order]
    mine = r.keep & (e_sorted >= e0) & (e_sorted < e0 + e_loc)
    slot = torch.where(mine, r.slot - e0 * r.cap,
                       torch.full_like(r.slot, e_loc * r.cap))
    return r._replace(keep=mine, slot=slot)


def moe_partial(x_loc: torch.Tensor, wg, w_up, w_gate, w_down,
                cfg: ModelConfig, e0: int, e_loc: int) -> torch.Tensor:
    """One process's part of the MoE output of its tokens ``x_loc``
    [T_loc, d] (the reference's ``_local_moe`` without its ``psum``; no
    collective): the tokens routed over every expert at the capacity of
    the ``T_loc`` local tokens, only the experts ``e0 .. e0 + e_loc − 1``
    run (``w_up`` / ``w_gate`` / ``w_down`` hold theirs).  The parts
    of the processes holding the other experts sum to the output."""
    r = local_route(route_by(wg, x_loc, cfg), e0, e_loc)
    return experts(x_loc, r, w_up, w_gate, w_down, cfg.mlp_kind)


def apply_moe_sharded(p: nn.Module, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Expert parallelism on the mesh in scope (the reference's
    ``apply_moe_sharded``): the tokens split by batch (``dp``), the
    expert weights by expert (``ep``) and expert-ff (``ff``) axes and
    never gathered there, ``moe_partial`` on each process's shards, and
    the parts summed over ``red = ep + ff``.  The output is replicated
    over ``red``, so the gradients of the tokens and the router, which
    every process there reads for its own experts' part, are summed
    over ``red`` too (``grad_summed_over``); ``on_local_shards`` sums
    over the batch split."""
    mesh = current_mesh()
    sizes = _mesh_axis_sizes()
    b, s, d = x.shape
    dp = axes_of(resolve("batch", b * s))
    ep = tuple(a for a in axes_of(resolve("expert", cfg.n_experts))
               if a not in dp)
    e_loc = cfg.n_experts // math.prod(sizes[a] for a in ep)
    ff = tuple(a for a in axes_of(resolve("moe_ff", cfg.d_ff))
               if a not in dp and a not in ep)
    groups = [mesh.get_group(a) for a in ep + ff]
    e0 = shard_index(mesh, ep) * e_loc
    rows, ep_, ff_ = dp or None, ep or None, ff or None
    w_gate = getattr(p, "w_gate", None)

    def local(xl, wg, w_up, w_down, w_gate=None):
        xl, wg = grad_summed_over(xl, groups), grad_summed_over(wg, groups)
        return sum_over(moe_partial(xl, wg, w_up, w_gate, w_down, cfg, e0,
                                    e_loc), groups)

    args = (x.reshape(b * s, d), p.wg, p.w_up, p.w_down)
    sps = ((rows, None), (None, None), (ep_, None, ff_), (ep_, ff_, None))
    if w_gate is not None:
        args, sps = args + (w_gate,), sps + ((ep_, None, ff_),)
    out = on_local_shards(local, (rows, None), sps, *args)
    if dp and b % math.prod(sizes[a] for a in dp):
        # the tokens split where the batch does not (a prefill of fewer
        # prompts than the batch axes): the rows regathered to unflatten
        out = place(out, mesh, (None, None))
    return out.reshape(b, s, d)


def combine(flat: torch.Tensor, r: Route) -> torch.Tensor:
    """The experts' output rows ``flat`` (``[E·cap + 1, d]``, the last a
    zero row) back to the tokens: each token's k weighted contributions
    summed in ascending expert order (the order the sorted list holds
    them in), one add at a time in ``flat``'s dtype, from zero."""
    t, k = r.topi.shape
    inv = torch.argsort(r.order)                 # pair → sorted position
    by_expert = torch.argsort(r.topi, dim=-1)    # the k chosen are distinct
    pos = inv[(torch.arange(t, device=flat.device)[:, None] * k
               + by_expert).reshape(-1)]
    w = (r.weights.reshape(-1)[r.order] * r.keep)[pos].to(flat.dtype)
    contrib = (flat[r.slot[pos]] * w[:, None]).view(t, k, -1)
    out = flat.new_zeros((t, flat.shape[1]))
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_flops_per_token(cfg: ModelConfig) -> int:
    """Active-param matmul FLOPs per token (fwd), for roofline ratios."""
    n_mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return 2 * cfg.top_k * n_mats * cfg.d_model * cfg.d_ff
