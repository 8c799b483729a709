"""mamba2-1.3b [ssm]: attention-free SSD (state-space duality).
[arXiv:2405.21060]

Assigned numbers: 48L, d_model=2048, d_ff=0 (the SSD mixer IS the block),
vocab=50280, ssm_state=128. d_inner = 2*d_model = 4096, head_dim 64 ->
64 SSD heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=0,
    vocab=50280, ssm=True, d_state=128, ssm_expand=2, ssm_head_dim=64,
    d_conv=4, n_groups=1, ssm_chunk=256, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=0, vocab=512,
    ssm=True, d_state=16, ssm_expand=2, ssm_head_dim=32, d_conv=4,
    n_groups=1, ssm_chunk=32, tie_embeddings=True, dtype="float32",
    remat="none",
)
