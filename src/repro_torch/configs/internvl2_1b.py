"""internvl2-1b [vlm]: InternViT frontend stubbed (patch embeddings
provided), InternLM2 backbone, GQA kv=2. [arXiv:2404.16821; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151655, head_dim=64, mlp_kind="swiglu", norm_kind="rms",
    rope_theta=10000.0, tie_embeddings=True, max_seq=32768,
    n_patches=256)
