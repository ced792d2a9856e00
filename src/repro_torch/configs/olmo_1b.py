"""olmo-1b [dense]: non-parametric LayerNorm, kv=16 (MHA).
[arXiv:2402.00838; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, head_dim=128, mlp_kind="swiglu",
    norm_kind="ln_nonparam", rope_theta=10000.0, tie_embeddings=True,
    max_seq=32768)
