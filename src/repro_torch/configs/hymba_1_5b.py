"""hymba-1.5b [hybrid]: parallel attention + Mamba heads per layer, meta
tokens, SWA with three full-attention layers. [arXiv:2411.13676; hf]

Assigned numbers: 32L, d_model=1600, 25 heads (GQA kv=5), d_ff=5504,
vocab=32001, ssm_state=16.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab=32001, act="silu", norm="rms",
    hybrid=True, d_state=16, ssm_expand=2, ssm_head_dim=64, d_conv=4,
    window=1024, global_layers=(0, 15, 31), n_meta_tokens=128,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab=512, hybrid=True, d_state=16, ssm_expand=2,
    ssm_head_dim=32, d_conv=4, window=64, global_layers=(0,),
    n_meta_tokens=8, ssm_chunk=32, dtype="float32", remat="none",
)
