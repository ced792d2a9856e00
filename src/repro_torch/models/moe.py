"""Mixture-of-experts FFN with sparse (gather / scatter) dispatch —
counterpart of the single-device path of ``repro/models/moe.py``
(``_apply_moe_dense``).

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
  ``[cap, d_ff]`` intermediates), at the capacity of the whole batch;
* the combine sums each token's k weighted contributions in ascending
  expert order, one add at a time in the input dtype, starting from
  zero — the order the reference's scatter-add takes them in on the
  CPU.  ``index_add_`` is not used: its order is nondeterministic on
  CUDA.

Every step is allowed under ``torch.use_deterministic_algorithms(True)``
and differentiable through autograd (the indices carry no gradient).

The reference's ``apply_moe_sharded`` / ``_local_moe`` (expert
parallelism under ``shard_map``), which it takes whenever a mesh is in
scope, are not ported yet: ``apply_moe`` raises on a mesh (ROADMAP
A17).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch import not_ported
from repro_torch.config import ModelConfig
from repro_torch.models.layers import _normal, at_least_f32, ffn, \
    params_module
from repro_torch.sharding import current_mesh


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
    logits = at_least_f32(xt) @ p.wg
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
    """x: [B, S, d] → [B, S, d]."""
    if current_mesh() is not None:
        not_ported("apply_moe_sharded (expert parallelism)", "A17")
    return apply_routed(p, x, route(p, x.reshape(-1, x.shape[-1]), cfg),
                        cfg)


def apply_routed(p: nn.Module, x: torch.Tensor, r: Route,
                 cfg: ModelConfig) -> torch.Tensor:
    """The experts and the combine for ``x`` [B, S, d] routed by ``r``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, r.topi.shape[1]
    xt = x.reshape(b * s, d)
    cap = r.cap
    # dispatch: a scatter into [E·cap + 1, d]; only dropped pairs share
    # an index (the overflow row, sliced off), and they carry zeros
    buf = x.new_zeros((e * cap + 1, d))
    buf[r.slot] = xt[r.order // k] * r.keep[:, None].to(x.dtype)
    he = buf[:e * cap].view(e, cap, d)

    # the experts, one at a time; a zero row stands for the overflow row
    w_gate = getattr(p, "w_gate", None)
    flat = torch.cat(
        [ffn(he[i], p.w_up[i], p.w_down[i], cfg.mlp_kind,
             None if w_gate is None else w_gate[i]) for i in range(e)]
        + [x.new_zeros((1, d))])
    return combine(flat, r).view(b, s, d)


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
