"""internvl2-2b [vlm]: InternViT frontend (STUB per assignment) + InternLM2
backbone. [arXiv:2404.16821]

Assigned numbers (backbone): 24L, d_model=2048, 16H (kv=8), d_ff=8192,
vocab=92553. The vision frontend contributes 1024 patch-embedding prefix
tokens via input_specs; decode shapes keep the image tokens resident in the
KV-cache prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab=92_553, frontend="vision", n_prefix_tokens=1024,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    frontend="vision", n_prefix_tokens=16, dtype="float32", remat="none",
)
