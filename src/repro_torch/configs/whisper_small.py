"""whisper-small [audio]: enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, mlp_kind="gelu", norm_kind="ln",
    pos_kind="learned", max_seq=32768, enc_seq=1500,
    tie_embeddings=True, rope_theta=0.0)
