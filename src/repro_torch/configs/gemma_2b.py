"""gemma-2b [dense]: GeGLU, head_dim=256, MQA kv=1, 256k vocab.
[arXiv:2403.08295; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=256000, head_dim=256, mlp_kind="geglu", norm_kind="rms",
    rope_theta=10000.0, tie_embeddings=True, max_seq=32768)
