"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]

Assigned numbers: 32L, d_model=4096, 32H (kv=8), d_ff=14336 per expert,
vocab=32000, SWA window 4096 (rolling-buffer KV => eligible for the 500k
decode cell). 8 experts on a 16-wide model axis are not EP-divisible, so
each expert gets 2 EP replicas (grads tied in the train step) — recorded in
DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, n_experts=8, top_k=2, n_expert_replicas=2,
    window=4096, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    n_experts=4, top_k=2, window=64, dtype="float32", remat="none",
)
