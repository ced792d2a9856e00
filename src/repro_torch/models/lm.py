"""Decoder-only LM (dense / MoE / SSM / hybrid / VLM) with KV/SSM caches
and the three step entry points (forward, prefill, decode) and the
training loss — counterpart of ``repro/models/lm.py``.

The model is an ``nn.Module`` tree: ``LM`` holds ``embed``, a
``ModuleList`` of groups, ``final_norm`` and, for the VLM family,
``patch_proj``; the JAX package's scan over stacked group params is a
Python loop here, and its ``jax.checkpoint`` of the scan body is
``torch.utils.checkpoint`` of each group (``remat``).  ``prefill`` and
``decode_step`` run without autograd.

VLM: the vision frontend is a stub, as in the JAX package.
``extra["patches"]`` [B, P, d] is cast to the params' dtype, projected
by ``patch_proj`` and put before the tokens; positions run over P + S,
``forward`` drops the prefix before the unembed, and a caller decodes
at absolute position P + len + i with a ``cache_cap`` that holds the
patches too.  The encoder-decoder family is ``models/encdec.py``.

Hybrid (jamba): a group is one period of ``attn_period`` layers, each
an attention or an SSM mixer followed by an MLP or, every
``moe_every``-th layer, a mixture of experts (``models/blocks.py``).
Its MoE layers run as every other MoE family's do, on a mesh too.

On a mesh (``sharding.mesh_context`` of a ``DeviceMesh``, parameters and
batch placed as DTensors, ``runtime.elastic.reshard_state`` /
``launch.dryrun.batch_sharding``) every family's ``forward``,
``loss_fn``, ``prefill`` and ``decode_step`` run as DTensor programs
(the vlm's batch-placed patches projected by the replicated
``patch_proj`` and joined to the tokens along the unsplit sequence):
activations are annotated at the reference's ``shard`` sites,
attention runs the kernel on each process's shards
(``models/attention.py``), the MoE runs expert parallel
(``models/moe.py::apply_moe_sharded``) and the SSM block each process's
batch rows (``models/ssm.py``).  The caches ``prefill`` returns, and
``decode_step`` takes and returns, sit at ``launch.dryrun.
cache_sharding``'s placements, so a serve loop never reshuffles them
between steps; ``pos`` stays a Python int.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers import _normal, apply_norm, embed, \
    init_embed, init_norm, unembed
from repro_torch.sharding import current_mesh, on_local_shards, shard, spec

class LM(nn.Module):
    """Parameters of one decoder-only LM (names as the JAX param tree:
    ``embed.tok``, ``groups.<g>.l<i>.attn.wq``, ``final_norm.scale``,
    ``patch_proj``)."""

    def __init__(self, cfg: ModelConfig, embed: nn.Module,
                 groups: list[nn.Module], final_norm: nn.Module,
                 patch_proj: torch.Tensor | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.groups = nn.ModuleList(groups)
        self.final_norm = final_norm
        if patch_proj is not None:
            self.patch_proj = nn.Parameter(patch_proj)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> LM:
    """Random weights drawn from ``generator``: ``dtype`` for the weights,
    float32 for the SSM's ``A_log``, ``D`` and ``dt_bias``."""
    dev = resolve_device(device)
    emb = init_embed(generator, cfg, dtype, dev)
    groups = [B.init_group(generator, cfg, dtype, dev)
              for _ in range(B.n_groups(cfg))]
    final_norm = init_norm(cfg, dtype, dev)
    patch_proj = (_normal(generator, (cfg.d_model, cfg.d_model),
                          cfg.d_model ** -0.5, dtype, dev)
                  if cfg.family == "vlm" else None)
    return LM(cfg, emb, groups, final_norm, patch_proj)


def _embed(params: LM, tokens: torch.Tensor, cfg: ModelConfig, pos0: int):
    positions = torch.arange(pos0, pos0 + tokens.shape[1],
                             device=tokens.device)
    return embed(params.embed, tokens.long(), cfg, positions=positions)


def _with_patches(params: LM, x: torch.Tensor, cfg: ModelConfig, extra):
    """VLM: (the projected patches followed by ``x``, the patch count);
    any other family: (``x``, 0)."""
    if cfg.family != "vlm":
        return x, 0
    if not extra or "patches" not in extra:
        raise ValueError(f"{cfg.name}: the vlm family needs "
                         "extra={'patches': [B, P, d]}")
    patches = extra["patches"].to(x.dtype) @ params.patch_proj
    return torch.cat([patches, x], dim=1), patches.shape[1]


# the products without batch dimensions, ``x @ W`` (JAX's
# ``dots_with_no_batch_dims_saveable``); the batched ones, attention's,
# are recomputed with everything else
_SAVED_UNDER_BLOCK = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_UNDER_BLOCK
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _group_out(g, x, cfg, positions):
    return B.apply_group(g, x, cfg, positions=positions)[0]


def _apply_groups(params: LM, x, cfg: ModelConfig, positions,
                  remat: str):
    """Every group in turn.  ``remat`` is the JAX package's: "none"
    keeps every activation for the backward; "full" keeps only each
    group's input and recomputes the group in the backward; "block"
    also keeps the outputs of the matmuls without batch dims.  Outside
    autograd the three are the same computation."""
    if remat not in ("none", "block", "full"):
        raise ValueError(f"remat must be none, block or full, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        for g in params.groups:
            x = _group_out(g, x, cfg, positions)
        return x
    context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _save_products)
               if remat == "block" else ckpt.noop_context_fn)
    for g in params.groups:
        x = ckpt.checkpoint(_group_out, g, x, cfg, positions,
                            use_reentrant=False, context_fn=context)
    return x


def forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
            extra: dict | None = None, remat: str = "none") -> torch.Tensor:
    """Training/eval forward: tokens [B, S] → logits [B, S, V] (f32).
    ``extra``: the modality-stub inputs, ``patches`` [B, P, d] for vlm
    (prepended after projection; their logits are dropped)."""
    tokens = shard(tokens, "batch", None)
    x = _embed(params, tokens, cfg, 0)
    x, n_prefix = _with_patches(params, x, cfg, extra)
    x = shard(x, "batch", None, None)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = _apply_groups(params, x, cfg, positions, remat)
    x = apply_norm(params.final_norm, x, cfg.norm_kind)
    if n_prefix:
        x = x[:, n_prefix:]
    return shard(unembed(params.embed, x, cfg), "batch", None, "model")


def loss_fn(params: LM, batch: dict, cfg: ModelConfig, *,
            extra: dict | None = None, remat: str = "block") -> torch.Tensor:
    """Next-token cross entropy (mean over non-masked positions), in
    float32: ``batch`` holds ``tokens`` and ``labels`` [B, S] and
    optionally ``mask`` [B, S]; ``extra`` as ``forward`` takes it."""
    logits = forward(params, batch["tokens"], cfg, extra=extra, remat=remat)
    nll = next_token_nll(logits, batch["labels"])
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:].float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()


def next_token_nll(logits, labels):
    """−log softmax(logits[:, :-1])[labels[:, 1:]] at each position
    [B, S − 1], in float32; on a mesh, under ``local_map``, each process
    its batch rows with the vocabulary whole (a DTensor log-softmax and
    gather over logits split by vocabulary are not relied on)."""
    targets = labels[:, 1:].long()
    if current_mesh() is None:
        return _token_nll(logits[:, :-1], targets)
    rows = spec("batch", dims=targets.shape)[0]
    return on_local_shards(_token_nll, (rows, None),
                           ((rows, None, None), (rows, None)),
                           logits[:, :-1], shard(targets, "batch", None))


def _token_nll(logits, targets):
    """−log softmax(logits)[target] at each position, in float32."""
    lp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, targets[..., None])[..., 0]


@torch.no_grad()
def prefill(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
            extra: dict | None = None, cache_cap: int | None = None):
    """Build caches for decode (over the patches and the tokens, for
    vlm).  Returns (last_logits [B, V], caches: one dict per group)."""
    tokens = shard(tokens, "batch", None)
    x = _embed(params, tokens, cfg, 0)
    x, _ = _with_patches(params, x, cfg, extra)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    cap = cache_cap or x.shape[1]
    caches = []
    for g in params.groups:
        x, c = B.apply_group(g, x, cfg, positions=positions,
                             make_cache=True, cache_cap=cap)
        caches.append(c)
    x = apply_norm(params.final_norm, x[:, -1], cfg.norm_kind)
    return unembed(params.embed, x, cfg), caches


def init_decode_caches(cfg: ModelConfig, batch: int, cache_len: int,
                       dtype=torch.bfloat16, device="cuda") -> list[dict]:
    """Empty caches, one dict per group."""
    dev = resolve_device(device)
    return [B.init_group_cache(cfg, batch, cache_len, dtype, dev)
            for _ in range(B.n_groups(cfg))]


@torch.no_grad()
def decode_step(params: LM, token: torch.Tensor, pos: int, caches,
                cfg: ModelConfig):
    """One decode step.  token: [B, 1]; pos: absolute position of the
    token; caches: as ``prefill`` returns them, updated in place.
    → (logits [B, V], caches)."""
    pos = int(pos)
    token = shard(token, "batch", None)
    x = shard(_embed(params, token, cfg, pos), "batch", None, None)
    for g, c in zip(params.groups, caches):
        x, _ = B.decode_group(g, x, cfg, c, pos)
    x = apply_norm(params.final_norm, x[:, -1], cfg.norm_kind)
    return unembed(params.embed, x, cfg), caches
