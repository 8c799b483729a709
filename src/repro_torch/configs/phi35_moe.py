"""phi3.5-moe-42b-a6.6b [moe]: 16 experts, top-2 routing.
[hf:microsoft/Phi-3.5-MoE-instruct]

Assigned numbers: 32L, d_model=4096, 32H (kv=8), d_ff=6400 per expert,
vocab=32064, MoE 16e top-2. EP: 16 experts shard exactly onto the 16-wide
'model' mesh axis (expert parallelism; the paper-technique dispatch path).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, n_experts=16, top_k=2, norm="layer", act="silu",
)

SMOKE = ModelConfig(
    name="phi35-moe-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    n_experts=4, top_k=2, norm="layer", dtype="float32", remat="none",
)
