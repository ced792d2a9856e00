"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.
d_ff=0 — pure mamba blocks, no FFN. [arXiv:2405.21060; unverified]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, norm_kind="rms", pos_kind="none",
    tie_embeddings=True, max_seq=524288,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
    ssm_chunk=256)
