"""Attention: GQA/MQA, causal/full/sliding-window, self/cross, with KV
caches for decode (ring buffer under SWA) — counterpart of
``repro/models/attention.py``.

Full-sequence attention — self-attention, the encoder's bidirectional
attention and cross-attention (``kv_x``) — goes through
``kernels.flash_attention``: on the card the hand-written kernel, on
the CPU its plain version.  There is no ``impl`` switch; the device
decides.  The one-token decode step is plain PyTorch (``_sdpa``), as it
is XLA in the JAX package.  The JAX package's ``_sdpa_flash_xla`` exists
only so that JAX lowers on the CPU; the kernel computes the same
function and it is not ported.

dtypes follow JAX's promotion: the projections run in the promoted
dtype of activation and weight (``layers.mm``), and where q, k and v
differ (a bfloat16 decoder's queries against float32 encoder keys) the
kernel runs in their promoted dtype and its output is cast to q's, as
``_sdpa`` computes in float32 and returns q's dtype.

On a mesh (``sharding.mesh_context``) q, k and v are annotated as the
reference annotates them — batch over the ``batch`` axes, heads over
``model``, each where it divides — and the kernel runs under
``local_map`` on each process's shards (``_flash_on_mesh``): a
hand-written kernel has no DTensor sharding rule.  Where q's heads are
split and k / v's are not (GQA with fewer kv heads than the ``model``
axis), each process takes the kv heads of its own q heads.  The out
projection runs under ``local_map`` too (``_out``: each process's
heads' part summed over ``model``), and so does a decode step's
cross-attention against an encoder-decoder's whole cross caches
(``cross_decode``).

Decode writes the new key/value row into the cache tensors in place
(PyTorch's idiom; the JAX package returns fresh arrays) and returns the
same cache object.  On a mesh a prefill's cache and every decode step's
sit at ``sharding.kv_cache_spec``'s placements (the reference's
``cache_sharding``): the batch split where it divides, else the KV
sequence split over ``kv_seq``, whose blocks' softmax parts a decode
step combines by log-sum-exp over the mesh (``_decode_on_mesh``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import _normal, mm, params_module, rope
from repro_torch.sharding import (all_reduce_over, axes_of,
                                  batch_cache_spec, current_mesh,
                                  kv_cache_spec, local_range,
                                  on_local_shards, place, placements, shard,
                                  shard_index, spec, split_dims, sum_over)


def init_attention(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    s = d ** -0.5
    return params_module(
        wq=_normal(gen, (d, hq, hd), s, dtype, device),
        wk=_normal(gen, (d, hkv, hd), s, dtype, device),
        wv=_normal(gen, (d, hkv, hd), s, dtype, device),
        wo=_normal(gen, (hq, hd, d), (hq * hd) ** -0.5, dtype, device))


@dataclasses.dataclass
class KVCache:
    """k/v: [B, S_cap, Hkv, hd]; pos_map: absolute position of each cache
    row (−1 = empty) — ring-buffer SWA caches and full caches share one
    masking rule."""
    k: torch.Tensor
    v: torch.Tensor
    pos_map: torch.Tensor  # i32[S_cap]

    @property
    def cap(self) -> int:
        return self.k.shape[1]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device, heads: int | None = None) -> KVCache:
    """An empty cache of ``heads`` kv heads (default all of ``cfg``'s)."""
    cap = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, cap, heads or cfg.n_kv_heads, cfg.hd())
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos_map=torch.full((cap,), -1, dtype=torch.int32, device=device))


def _mask(qpos, kpos, causal: bool, window: int | None):
    """qpos: [Sq], kpos: [Skv] (−1 = invalid) → bool [Sq, Skv]."""
    m = kpos[None, :] >= 0
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def _sdpa(q, k, v, mask, scale):
    """q: [B,Sq,Hq,hd], k/v: [B,Skv,Hkv,hd], mask: [Sq,Skv]."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    m = mask[None, None, None]
    p = torch.where(m, torch.softmax(torch.where(m, s, float("-inf")),
                                     dim=-1), 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, hd).to(q.dtype)


def _project(x, w):
    """[B, S, d] @ [d, H, hd] → [B, S, H, hd] (contiguous).  On a mesh,
    under ``local_map`` with the output placed as the reference's
    ``shard(.., "batch", None, "model", None)``: x split by batch, w by
    heads, d whole on each process.  (DTensor left to itself may split
    the product's H · hd columns where H does not divide, which no view
    can unflatten.)"""
    if current_mesh() is None:
        return _project_local(x, w)
    sy = spec("batch", None, "model", None, dims=(*x.shape[:-1],
                                                  *w.shape[1:]))
    return on_local_shards(_project_local, sy, ((sy[0], None, None),
                                                (None, sy[2], None)), x, w)


def _project_local(x, w):
    d, h, hd = w.shape
    return mm(x, w.reshape(d, h * hd)).view(*x.shape[:-1], h, hd)


def _out(o, wo):
    """[B, S, H, hd] @ [H, hd, d] → [B, S, d].  On a mesh, under
    ``local_map``: o placed as the reference's ``shard(.., "batch", None,
    "model", None)`` resolves it, wo split by the same heads and whole
    along d, each process's heads' part summed over the axes that split
    them (``sum_over``).  (DTensor left to itself may split the H · hd
    rows of wo's gradient over ``model`` where H does not divide it,
    which no view can unflatten.)"""
    mesh = current_mesh()
    if mesh is None:
        return _out_local(o, wo)
    so = spec("batch", None, "model", None, dims=o.shape)
    groups = [mesh.get_group(a) for a in axes_of(so[2])
              if mesh.size(mesh.mesh_dim_names.index(a)) > 1]
    return on_local_shards(lambda ol, wl: sum_over(_out_local(ol, wl),
                                                   groups),
                           (so[0], None, None), (so, (so[2], None, None)),
                           o, wo)


def _out_local(o, wo):
    h, hd, d = wo.shape
    return mm(o.reshape(*o.shape[:-2], h * hd), wo.reshape(h * hd, d))


def _flash(q, k, v, causal: bool, window: int | None, scale: float):
    """The kernel on [B, S, H, hd] activations (seen as [B, H, S, hd]),
    in the promoted dtype of q, k and v; the output in q's dtype."""
    if current_mesh() is not None:
        return _flash_on_mesh(q, k, v, causal, window, scale)
    return _flash_local(q, k, v, causal, window, scale)


def kv_heads_for(q0: int, n_q: int, group: int) -> torch.Tensor:
    """The kv head of each of q heads ``q0 .. q0 + n_q - 1`` (GQA: q
    head h reads kv head ``h // group``)."""
    return torch.arange(q0, q0 + n_q) // group


def own_kv_heads(k, v, q0: int, n_q: int, group: int):
    """k / v [B, S, Hkv, hd] (every kv head) cut to the kv head of each
    of q heads ``q0 .. q0 + n_q - 1``, one a q head: what a process
    whose q heads the ``model`` axis splits reads where k / v's heads
    are whole."""
    idx = kv_heads_for(q0, n_q, group).to(k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _flash_on_mesh(q, k, v, causal, window, scale):
    """``_flash`` under ``local_map``: q / k / v [B, S, H, hd] placed as
    the reference's ``shard(.., "batch", None, "model", None)`` resolves
    them, the kernel on each process's shards, the output placed as
    q."""
    return _on_q_heads(
        lambda ql, kl, vl: _flash_local(ql, kl, vl, causal, window, scale),
        q, k, v, spec("batch", None, "model", None, dims=k.shape))


def _on_q_heads(fn, q, k, v, skv: tuple):
    """``fn(q, k, v)`` on each process's shards (``local_map``): q placed
    as the reference's ``shard(.., "batch", None, "model", None)``
    resolves it, k / v by ``skv``, the output as q.  Where q's heads are
    split and k / v's are not, each process reads the kv heads of its
    own q heads (``own_kv_heads``)."""
    mesh = current_mesh()
    hq, hkv = q.shape[2], k.shape[2]
    sq = spec("batch", None, "model", None, dims=q.shape)
    heads = axes_of(sq[2])
    split_q_only = heads and not axes_of(skv[2])

    def local(ql, kl, vl):
        if split_q_only:
            kl, vl = own_kv_heads(kl, vl, shard_index(mesh, heads)
                                  * ql.shape[2], ql.shape[2], hq // hkv)
        return fn(ql, kl, vl)

    return on_local_shards(local, sq, (sq, skv, skv), q, k, v)


def _flash_local(q, k, v, causal, window, scale):
    """``_flash`` on tensors of one device."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    o = flash_attention(q.to(dt).transpose(1, 2), k.to(dt).transpose(1, 2),
                        v.to(dt).transpose(1, 2), causal, window, scale)
    return o.transpose(1, 2).to(q.dtype)


def attention(p: nn.Module, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True, positions: torch.Tensor | None = None,
              kv_x: torch.Tensor | None = None, use_rope: bool = True,
              make_cache: bool = False, cache_cap: int | None = None):
    """Full-sequence attention (train / prefill / encoder / cross).
    ``positions`` (default ``arange(S)``) feed rope; the attention itself
    sees token i at position i.  ``kv_x`` switches to cross-attention:
    keys and values from the encoder sequence ``kv_x`` [B, S_enc, d], no
    rope, no causal mask, no window.  Returns (out, cache | None)."""
    b, s, _ = x.shape
    hd = cfg.hd()
    src = x if kv_x is None else kv_x
    q = shard(_project(x, p.wq), "batch", None, "model", None)
    k = shard(_project(src, p.wk), "batch", None, "model", None)
    v = shard(_project(src, p.wv), "batch", None, "model", None)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    if use_rope and kv_x is None and cfg.pos_kind == "rope":
        q = rope(q, positions[None, :], cfg.rope_theta)
        k = rope(k, positions[None, :], cfg.rope_theta)

    cross = kv_x is not None
    o = _flash(q, k, v, causal and not cross, None if cross else cfg.window,
               hd ** -0.5)
    out = shard(_out(o, p.wo), "batch", None, None)

    cache = None
    if make_cache:
        cap = cache_cap or s
        cache = (_fill_cache(k, v, positions, cfg, cap)
                 if current_mesh() is None
                 else _cache_on_mesh(k, v, positions, cfg, cap))
    return out, cache


def _fill_cache(k, v, positions, cfg: ModelConfig, cap: int) -> KVCache:
    """The decode cache of a prefill's keys / values [B, S, Hkv, hd] at
    ``positions`` [S]: the first rows, or (SWA, S past the cache) the
    last ``cap`` keys at slot pos % cap, on tensors of one device."""
    b, s = k.shape[:2]
    cache = init_cache(cfg, b, cap, k.dtype, k.device, heads=k.shape[2])
    ccap = cache.cap
    slots = torch.arange(ccap, dtype=torch.int32, device=k.device)
    if cfg.window is None or s <= ccap:
        take = min(s, ccap)
        cache.k[:, :take] = k[:, :take]
        cache.v[:, :take] = v[:, :take]
        cache.pos_map = torch.where(slots < take, slots, -1)
    else:
        # SWA ring buffer: keep the last `ccap` keys at slot pos % cap
        last = positions[-1].to(torch.int32)
        idx = ((slots + (last + 1)) % ccap).long()  # absolute order
        src = torch.arange(s - ccap, s, device=k.device)
        cache.k[:, idx] = k[:, src]
        cache.v[:, idx] = v[:, src]
        cache.pos_map = torch.zeros_like(cache.pos_map)
        cache.pos_map[idx] = positions[src].to(torch.int32)
    return cache


def _cache_on_mesh(k, v, positions, cfg: ModelConfig, cap: int) -> KVCache:
    """``_fill_cache`` on each process's shards of k / v (batch and
    heads as the prefill placed them, every row of the sequence), then
    each leaf placed by the reference's cache rules (``sharding``'s
    ``kv_cache_spec``; ``batch_cache_spec`` for ``pos_map``): where the
    batch does not divide, the rows split over ``kv_seq`` after the
    ring's permutation, so its slots land on whichever shard holds
    them."""
    mesh = current_mesh()
    sk = spec("batch", None, "model", None, dims=k.shape)

    def local(kl, vl):
        c = _fill_cache(kl, vl, positions, cfg, cap)
        return c.k, c.v, c.pos_map

    ck, cv, pos_map = on_local_shards(local, [sk, sk, (None,)], (sk, sk),
                                      k, v)
    return KVCache(place(ck, mesh, kv_cache_spec(tuple(ck.shape))),
                   place(cv, mesh, kv_cache_spec(tuple(cv.shape))),
                   place(pos_map, mesh, batch_cache_spec((cap,))))


def decode_attention(p: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                     cache: KVCache, pos: int):
    """One-token self-attention step.  x: [B, 1, d]; pos: absolute
    position of the new token.  Writes the new row into ``cache`` and
    returns (out, cache)."""
    hd = cfg.hd()
    q = _project(x, p.wq)
    k_new = _project(x, p.wk)
    v_new = _project(x, p.wv)
    if cfg.pos_kind == "rope":
        at = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, at, cfg.rope_theta)
        k_new = rope(k_new, at, cfg.rope_theta)
    if current_mesh() is not None:
        return _out(_decode_on_mesh(q, k_new, v_new, cfg, cache, pos),
                    p.wo), cache
    slot = pos % cache.cap
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos_map[slot] = pos

    qpos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    mask = _mask(qpos, cache.pos_map, True, cfg.window)
    o = _sdpa(q, cache.k, cache.v, mask, hd ** -0.5)
    return _out(o, p.wo), cache


def _decode_on_mesh(q, k_new, v_new, cfg: ModelConfig, cache: KVCache,
                    pos: int):
    """The decode step's attention on the mesh in scope, the cache at
    ``sharding.kv_cache_spec``'s placements (read from the cache's own)
    and written in place (each process its local shard).  Batch split:
    each process runs its rows' step on its cache shard.  Sequence split (the batch does not divide
    the ``batch`` axes): each process holds a block of cache rows; the
    new row is written by the process whose block holds slot pos % cap;
    each block's float32 max, sum and weighted values under the mask
    (``block_softmax``) are combined over the ``kv_seq`` axes by
    log-sum-exp (``merge_blocks``: one max all-reduce, then sums) —
    the cross-shard reductions GSPMD inserts for the reference.  Under a
    model split a local q head reads the kv heads of its own group.
    Returns the attention output [B, 1, Hq, hd], placed as q."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = current_mesh()
    hq, hkv = q.shape[2], k_new.shape[2]
    cap = cache.cap
    sq = spec("batch", None, "model", None, dims=q.shape)
    # the new row split as the cache's batch and heads are, its one
    # sequence row whole
    row = [p if not p.is_shard(1) else Replicate()
           for p in cache.k.placements]
    ql = place(q, mesh, sq).to_local()
    kn = k_new.redistribute(mesh, row).to_local()
    vn = v_new.redistribute(mesh, row).to_local()
    kc, vc = cache.k.to_local(), cache.v.to_local()
    slot = pos % cap
    seq = split_dims(cache.k, 1)
    lo, hi = local_range(cache.k, 1)
    if lo <= slot < hi:
        kc[:, slot - lo] = kn[:, 0].to(kc.dtype)
        vc[:, slot - lo] = vn[:, 0].to(vc.dtype)
    pmap = cache.pos_map
    plo, phi = local_range(pmap, 0)
    if plo <= slot < phi:
        pmap.to_local()[slot - plo] = pos
    qpos = torch.full((1,), pos, dtype=torch.int32, device=ql.device)
    mask = _mask(qpos, pmap.full_tensor(), True, cfg.window)[:, lo:hi]
    heads = axes_of(sq[2])
    if heads and not split_dims(cache.k, 2):
        kc, vc = own_kv_heads(kc, vc, shard_index(mesh, heads)
                              * ql.shape[2], ql.shape[2], hq // hkv)
    scale = cfg.hd() ** -0.5
    if seq:
        o = _heads_last(merge_blocks(
            *block_softmax(ql, kc, vc, mask, scale),
            lambda t, op: all_reduce_over(t, seq, op)), ql)
    else:
        o = _sdpa(ql, kc, vc, mask, scale)
    return DTensor.from_local(o, mesh, placements(sq, mesh),
                              run_check=False)


def cross_decode(q, xk, xv, scale: float):
    """A decode step's cross-attention: q [B, 1, Hq, hd] against every
    row of a layer's cross keys / values [B, S_enc, Hkv, hd] (plain
    PyTorch, as it is XLA in the JAX package).  On a mesh, under
    ``local_map`` (``_on_q_heads``), xk / xv at their cache placement
    (``batch_cache_spec``: heads and rows whole).  The cross caches never
    split their rows, so no log-sum-exp merge is needed."""
    if current_mesh() is None:
        return _attend_all(q, xk, xv, scale)
    return _on_q_heads(lambda ql, kl, vl: _attend_all(ql, kl, vl, scale),
                       q, xk, xv, batch_cache_spec(tuple(xk.shape)))


def _attend_all(q, k, v, scale):
    """``_sdpa`` with every key row valid."""
    everywhere = torch.ones((1, k.shape[1]), dtype=torch.bool,
                            device=k.device)
    return _sdpa(q, k, v, everywhere, scale)


def block_softmax(q, k, v, mask, scale):
    """``_sdpa`` over one block of key rows, not normalized: per query
    row (as [B, Hkv, G, Sq, ·], float32) the max score m, the sum l of
    exp(score − m) and the weighted values o, under ``mask`` [Sq,
    Skv_block].  A block with no valid row gives m = −inf, l = 0,
    o = 0 (never NaN)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    m = mask[None, None, None]
    s = torch.where(m, s, float("-inf"))
    mx = s.amax(-1, keepdim=True)
    p = torch.where(m, torch.exp(s - torch.where(torch.isfinite(mx), mx,
                                                 0.0)), 0.0)
    return mx, p.sum(-1, keepdim=True), torch.einsum("bhgqk,bkhd->bhgqd",
                                                     p, v.float())


def merge_blocks(m, l, o, reduce):
    """The blocks' parts (``block_softmax``) combined by log-sum-exp:
    ``reduce(t, op)`` is ``t`` reduced over the blocks by "max" or
    "sum" (all-reduces over the mesh, or a reduction over a stacked
    axis).  Rows no block holds a valid key for give 0, as ``_sdpa``'s
    do."""
    mx = reduce(m, "max")
    a = torch.where(torch.isfinite(m), torch.exp(m - mx), 0.0)
    tot = reduce(l * a, "sum")
    o = reduce(o * a, "sum")
    return torch.where(tot > 0, o / tot, 0.0)


def _heads_last(o, q):
    """[B, Hkv, G, Sq, hd] → [B, Sq, Hq, hd] in q's dtype."""
    b, sq, hq, hd = q.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)
