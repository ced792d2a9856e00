"""mixtral-8x7b [moe]: 8 experts top-2, GQA kv=8, SWA 4096.
[arXiv:2401.04088; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, mlp_kind="swiglu", norm_kind="rms",
    rope_theta=1e6, window=4096, n_experts=8, top_k=2, moe_every=1,
    tie_embeddings=False, max_seq=524288)
