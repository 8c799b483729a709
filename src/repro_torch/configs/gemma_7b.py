"""gemma-7b [dense]: GeGLU, head_dim=256, 256k vocab. [arXiv:2403.08295]

Assigned numbers: 28L, d_model=3072, 16H (kv=16), d_ff=24576, vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, d_head=256,
    d_ff=24576, vocab=256_000, act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=64, d_ff=256,
    vocab=512, act="gelu", tie_embeddings=True, dtype="float32",
    remat="none",
)
