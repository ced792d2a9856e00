"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave,
MoE 16e top-2 every 2nd layer, GQA kv=8. [arXiv:2403.19887; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128, mlp_kind="swiglu", norm_kind="rms",
    pos_kind="none",  # Jamba uses no positional encoding
    tie_embeddings=False, max_seq=524288,
    n_experts=16, top_k=2, moe_every=2,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
    ssm_chunk=256, attn_period=8, attn_offset=4)
