"""qwen1.5-4b [dense]: QKV bias, MHA (kv == heads). [hf:Qwen/Qwen1.5-4B]

Assigned numbers: 40L, d_model=2560, 20H (kv=20), d_ff=6912, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab=151_936, qkv_bias=True, rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen15-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    qkv_bias=True, dtype="float32", remat="none",
)
