"""Whisper-style encoder-decoder — counterpart of
``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the JAX package: the batch
carries precomputed frame embeddings ``frames`` [B, enc_seq, d_model]
(what the two conv layers would produce).  Encoder: bidirectional
attention + sinusoidal positions.  Decoder: causal self-attention
(learned positions) + cross-attention to the encoder output + GELU MLP.
Decode caches, one dict a decoder layer: ``self``, a ``KVCache``, and
the static cross keys / values ``xk`` / ``xv`` [B, enc_seq, Hkv, hd],
computed once at prefill.

The model is an ``nn.Module`` (``EncDec``) whose parameter names are
the JAX param tree's with the stacked layer axes unstacked into
``ModuleList``s (``enc.<i>.attn.wq``, ``dec.<i>.xattn.wq``).  Every
full-sequence attention — the encoder's, the decoder's self-attention
and the prefill's cross-attention — goes through
``kernels.flash_attention``; the decode step's one-token attention,
self and cross, is plain PyTorch (``attention._sdpa``), as it is XLA in
the JAX package.

dtypes follow JAX's promotion: float32 frames under bfloat16 params run
the whole encoder in float32, and so the cross keys / values, while the
decoder's own activations and its self-KV cache stay bfloat16.

On a mesh (``sharding.mesh_context``; parameters, ``frames``,
``tokens`` and ``labels`` placed as ``models/lm.py`` says) the encoder's
input is annotated by batch as the reference's, the learned positions
are read with the token table under ``local_map``
(``layers._lookup``), every B5 call runs on each process's shards
(``attention._flash_on_mesh``), the loss is ``lm.next_token_nll``'s,
the self caches sit at ``kv_cache_spec``'s placements and the cross
caches at the batch rule only (``_cross_kv``), and the decode step's
cross-attention runs on each process's q heads against whole cross
caches (``attention.cross_decode``).

Remat: the JAX package wraps a layer in ``jax.checkpoint`` without a
policy, so "block" and "full" both keep only each layer's input and
recompute the whole layer in the backward (``lm.py``'s "block" also
keeps the matmul outputs).  The values are the same either way; only
memory differs.  ``prefill`` and ``decode_step`` run without autograd.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import (apply_mlp, apply_norm, embed,
                                       init_embed, init_mlp, init_norm,
                                       sinusoidal, unembed)
from repro_torch.models.lm import next_token_nll
from repro_torch.sharding import (batch_cache_spec, current_mesh, place,
                                  replicated_like, shard)


def _enc_layer_init(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    layer = nn.Module()
    layer.norm1 = init_norm(cfg, dtype, device)
    layer.attn = A.init_attention(gen, cfg, dtype, device)
    layer.norm2 = init_norm(cfg, dtype, device)
    layer.mlp = init_mlp(gen, cfg, dtype, device)
    return layer


def _dec_layer_init(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    layer = nn.Module()
    layer.norm1 = init_norm(cfg, dtype, device)
    layer.attn = A.init_attention(gen, cfg, dtype, device)
    layer.norm_x = init_norm(cfg, dtype, device)
    layer.xattn = A.init_attention(gen, cfg, dtype, device)
    layer.norm2 = init_norm(cfg, dtype, device)
    layer.mlp = init_mlp(gen, cfg, dtype, device)
    return layer


class EncDec(nn.Module):
    """Parameters of one encoder-decoder (names as the JAX param tree:
    ``embed.tok``, ``enc.<i>.attn.wq``, ``enc_norm.scale``,
    ``dec.<i>.xattn.wq``, ``final_norm.scale``)."""

    def __init__(self, cfg: ModelConfig, embed: nn.Module,
                 enc: list[nn.Module], enc_norm: nn.Module,
                 dec: list[nn.Module], final_norm: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.enc = nn.ModuleList(enc)
        self.enc_norm = enc_norm
        self.dec = nn.ModuleList(dec)
        self.final_norm = final_norm


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> EncDec:
    """Random weights drawn from ``generator`` in ``dtype``."""
    dev = resolve_device(device)
    emb = init_embed(generator, cfg, dtype, dev)
    enc = [_enc_layer_init(generator, cfg, dtype, dev)
           for _ in range(cfg.n_enc_layers)]
    enc_norm = init_norm(cfg, dtype, dev)
    dec = [_dec_layer_init(generator, cfg, dtype, dev)
           for _ in range(cfg.n_layers)]
    return EncDec(cfg, emb, enc, enc_norm, dec, init_norm(cfg, dtype, dev))


def _positions(start: int, n: int, cfg: ModelConfig, device):
    """``arange(start, start + n)``; raises past the learned position
    table (JAX clamps such a gather, torch would fault)."""
    if cfg.pos_kind == "learned" and start + n > cfg.max_seq:
        raise ValueError(f"positions up to {start + n - 1} exceed the "
                         f"learned table of {cfg.max_seq}")
    return torch.arange(start, start + n, device=device)


def _layers(layers: nn.ModuleList, fn, x, remat: str, *args):
    """``x = fn(layer, x, *args)`` for every layer in turn; under
    autograd with ``remat`` "block" or "full", each layer checkpointed
    without a policy (the JAX package's ``jax.checkpoint``)."""
    if remat not in ("none", "block", "full"):
        raise ValueError(f"remat must be none, block or full, got {remat!r}")
    for lp in layers:
        if remat == "none" or not torch.is_grad_enabled():
            x = fn(lp, x, *args)
        else:
            x = ckpt.checkpoint(fn, lp, x, *args, use_reentrant=False)
    return x


def _enc_layer(lp: nn.Module, h, cfg: ModelConfig, positions):
    a = apply_norm(lp.norm1, h, cfg.norm_kind)
    a, _ = A.attention(lp.attn, a, cfg, causal=False, positions=positions,
                       use_rope=False)
    h = h + a
    m = apply_norm(lp.norm2, h, cfg.norm_kind)
    return h + apply_mlp(lp.mlp, m, cfg.mlp_kind)


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig,
           remat: str = "block") -> torch.Tensor:
    """frames: [B, enc_seq, d] (stub frontend output) → [B, enc_seq, d],
    in the promoted dtype of frames and params."""
    x = frames + replicated_like(sinusoidal(
        frames.shape[1], cfg.d_model, frames.dtype, frames.device), frames)
    x = shard(x, "batch", None, None)
    positions = torch.arange(frames.shape[1], dtype=torch.int32,
                             device=frames.device)
    x = _layers(params.enc, _enc_layer, x, remat, cfg, positions)
    return apply_norm(params.enc_norm, x, cfg.norm_kind)


def _dec_layer(lp: nn.Module, h, cfg: ModelConfig, enc_out, positions,
               make_cache: bool = False, cache_cap: int | None = None):
    a = apply_norm(lp.norm1, h, cfg.norm_kind)
    a, self_c = A.attention(lp.attn, a, cfg, causal=True,
                            positions=positions, use_rope=False,
                            make_cache=make_cache, cache_cap=cache_cap)
    h = h + a
    c = apply_norm(lp.norm_x, h, cfg.norm_kind)
    c, _ = A.attention(lp.xattn, c, cfg, causal=False, kv_x=enc_out,
                       positions=positions)
    h = h + c
    m = apply_norm(lp.norm2, h, cfg.norm_kind)
    h = h + apply_mlp(lp.mlp, m, cfg.mlp_kind)
    return h, self_c


def _dec_layer_out(lp, h, cfg, enc_out, positions):
    return _dec_layer(lp, h, cfg, enc_out, positions)[0]


def decode_seq(params: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, remat: str = "block") -> torch.Tensor:
    """Teacher-forced decoder pass → logits [B, S, V] (float32)."""
    tokens = shard(tokens, "batch", None)
    positions = _positions(0, tokens.shape[1], cfg, tokens.device)
    x = embed(params.embed, tokens.long(), cfg, positions=positions)
    x = _layers(params.dec, _dec_layer_out, x, remat, cfg, enc_out,
                positions)
    x = apply_norm(params.final_norm, x, cfg.norm_kind)
    return unembed(params.embed, x, cfg)


def loss_fn(params: EncDec, batch: dict, cfg: ModelConfig, *,
            remat: str = "block") -> torch.Tensor:
    """Next-token cross entropy over every position, in float32:
    ``batch`` holds ``frames``, ``tokens`` and ``labels``."""
    enc_out = encode(params, batch["frames"], cfg, remat)
    logits = decode_seq(params, batch["tokens"], enc_out, cfg, remat)
    return next_token_nll(logits, batch["labels"]).mean()


@torch.no_grad()
def prefill(params: EncDec, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, cache_cap: int | None = None):
    """Encoder + teacher-forced decoder prefix; builds the caches.
    Returns (last logits [B, V], caches: one dict a decoder layer with
    its self-KV ``KVCache`` and its cross keys / values)."""
    enc_out = encode(params, frames, cfg, remat="none")
    tokens = shard(tokens, "batch", None)
    positions = _positions(0, tokens.shape[1], cfg, tokens.device)
    x = embed(params.embed, tokens.long(), cfg, positions=positions)
    cap = cache_cap or tokens.shape[1]
    caches = []
    for lp in params.dec:
        x, self_c = _dec_layer(lp, x, cfg, enc_out, positions, True, cap)
        caches.append({"self": self_c, "xk": _cross_kv(enc_out, lp.xattn.wk),
                       "xv": _cross_kv(enc_out, lp.xattn.wv)})
    x = apply_norm(params.final_norm, x[:, -1], cfg.norm_kind)
    return unembed(params.embed, x, cfg), caches


def _cross_kv(enc_out, w):
    """A decoder layer's cross keys or values [B, enc_seq, Hkv, hd]; on
    a mesh at the reference's cache placement, the batch rule only
    (``batch_cache_spec``, C10): the heads the projection split over
    ``model`` gathered, and the whole tensor replicated where the batch
    does not divide the ``batch`` axes."""
    t = A._project(enc_out, w)
    mesh = current_mesh()
    return t if mesh is None else place(t, mesh,
                                        batch_cache_spec(tuple(t.shape)))


def init_decode_caches(cfg: ModelConfig, batch: int, cache_len: int,
                       dtype=torch.bfloat16, device="cuda") -> list[dict]:
    """Empty caches, one dict a decoder layer."""
    dev = resolve_device(device)
    shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd())
    return [{"self": A.init_cache(cfg, batch, cache_len, dtype, dev),
             "xk": torch.zeros(shape, dtype=dtype, device=dev),
             "xv": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def decode_step(params: EncDec, token: torch.Tensor, pos: int, caches,
                cfg: ModelConfig):
    """One decoder token step against the cached self / cross keys and
    values; the self caches are updated in place.  token: [B, 1]; pos:
    its absolute position.  → (logits [B, V], caches)."""
    pos = int(pos)
    token = shard(token, "batch", None)
    x = shard(embed(params.embed, token.long(), cfg,
                    positions=_positions(pos, 1, cfg, token.device)),
              "batch", None, None)
    scale = cfg.hd() ** -0.5
    for lp, cache in zip(params.dec, caches):
        a = apply_norm(lp.norm1, x, cfg.norm_kind)
        a, _ = A.decode_attention(lp.attn, a, cfg, cache["self"], pos)
        x = x + a
        c = apply_norm(lp.norm_x, x, cfg.norm_kind)
        o = A.cross_decode(A._project(c, lp.xattn.wq), cache["xk"],
                           cache["xv"], scale)
        x = x + A._out(o, lp.xattn.wo)
        m = apply_norm(lp.norm2, x, cfg.norm_kind)
        x = x + apply_mlp(lp.mlp, m, cfg.mlp_kind)
    x = apply_norm(params.final_norm, x[:, -1], cfg.norm_kind)
    return unembed(params.embed, x, cfg), caches
