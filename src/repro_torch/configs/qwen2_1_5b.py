"""qwen2-1.5b [dense]: aggressive GQA (kv=2), QKV bias. [arXiv:2407.10671]

Assigned numbers: 28L, d_model=1536, 12H (kv=2), d_ff=8960, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151_936, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    qkv_bias=True, tie_embeddings=True, dtype="float32", remat="none",
)
