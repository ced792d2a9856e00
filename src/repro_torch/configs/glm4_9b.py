"""glm4-9b [dense]: RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552, head_dim=128, mlp_kind="swiglu", norm_kind="rms",
    rope_theta=10000.0, tie_embeddings=False, max_seq=32768)
