"""Configuration: a framework-free copy of ``repro.config``'s
``ModelConfig``, ``ShardingConfig``, ``TrainConfig``, ``ShapeConfig``,
``SHAPES`` and ``reduced``.

One ``ModelConfig`` instance per assigned architecture lives in
``repro_torch/configs/<id>.py``.  Families:

  dense   — decoder-only transformer (llama/gemma/glm/olmo style)
  moe     — decoder-only with mixture-of-experts FFN
  ssm     — attention-free Mamba2 (SSD)
  hybrid  — Jamba-style interleave (1 attn : 7 mamba, MoE every 2nd)
  encdec  — Whisper-style encoder-decoder (stub audio frontend)
  vlm     — decoder with prepended patch embeddings (stub ViT frontend)

The port's models run every family: ``models/lm.py`` the decoder-only
ones, ``models/encdec.py`` the encoder-decoder.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None           # default d_model // n_heads
    mlp_kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_kind: Literal["rms", "ln", "ln_nonparam"] = "rms"
    rope_theta: float = 10000.0
    pos_kind: Literal["rope", "sinusoidal", "learned", "none"] = "rope"
    window: Optional[int] = None           # sliding-window attention
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = True
    max_seq: int = 8192                    # learned-pos table size
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1                     # MoE FFN on layers l % every == 0
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (Jamba) ---
    attn_period: int = 0                   # 8 → 1 attn : 7 mamba
    attn_offset: int = 0                   # index of attn layer in period
    # --- encdec (Whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                       # encoder frames (post conv stub)
    # --- vlm ---
    n_patches: int = 0

    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd()

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (sub-quadratic sequence mixing)."""
        return (self.family in ("ssm", "hybrid")
                or self.window is not None)

    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def ssm_nheads(self) -> int:
        return self.d_inner() // self.ssm_headdim


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Mesh-axis assignment and the training step's recompute policy,
    every field of the JAX package's.  ``fsdp`` / ``fsdp_pod`` are
    carried (and ``fsdp_axes`` answers as there) but nothing acts on
    them until ``fsdp`` on a mesh is ported.  ``seq_shard_decode`` is
    carried and read by nothing, as in the JAX package: a decode cache
    splits its KV sequence through the logical rule ``kv_seq``
    (``sharding.cache_spec``).  ``remat`` is acted on
    (``models/lm.py::forward``).  ``attn_impl`` is accepted and recorded
    only: the port has no attention switch, the device decides
    (``models/attention.py``)."""
    fsdp: bool = True          # shard params/opt-state over the data axis
    fsdp_pod: bool = False     # additionally over the pod axis
    seq_shard_decode: bool = True  # shard long KV caches over data axis
    remat: Literal["none", "block", "full"] = "block"
    attn_impl: Literal["xla", "xla_flash", "pallas"] = "xla"

    def fsdp_axes(self):
        if not self.fsdp:
            return None
        return ("pod", "data") if self.fsdp_pod else "data"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """``grad_compression`` is carried, as in the JAX package, whose
    single-device step does not read it either (it acts on the
    cross-device reduce)."""
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    param_dtype: Literal["float32", "bfloat16"] = "bfloat16"
    opt_state_dtype: Literal["float32", "bfloat16", "int8"] = "float32"
    grad_compression: Literal["none", "int8"] = "none"
    microbatches: int = 1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (arch × shape = a dry-run cell)."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (CPU-runnable)."""
    base = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.family != "hybrid" else 0),
        d_model=128, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        head_dim=32, d_ff=256, vocab=512, max_seq=512,
    )
    if cfg.family == "hybrid":
        base["n_layers"] = cfg.attn_period  # one full period
    if cfg.n_experts:
        base["n_experts"] = min(cfg.n_experts, 4)
        base["top_k"] = min(cfg.top_k, 2)
        # generous capacity: no token dropping, so reduced-config smoke
        # tests can assert causal prefill/decode consistency
        base["capacity_factor"] = 8.0
    if cfg.ssm_state:
        base["ssm_state"] = 16
        base["ssm_headdim"] = 32
        base["ssm_chunk"] = 16
    if cfg.family == "encdec":
        base["n_enc_layers"] = 2
        base["enc_seq"] = 64
    if cfg.family == "vlm":
        base["n_patches"] = 16
    if cfg.window is not None:
        base["window"] = 64
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
