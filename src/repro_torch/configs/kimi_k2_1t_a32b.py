"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8,
per-expert FF 2048 (paper-table config). [arXiv:2501.kimi2; unverified]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112, mlp_kind="swiglu", norm_kind="rms",
    rope_theta=5e6, n_experts=384, top_k=8, moe_every=1,
    tie_embeddings=False, max_seq=131072)
