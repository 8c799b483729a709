"""hubert-xlarge [audio]: encoder-only transformer (w2v2 architecture).
[arXiv:2106.07447]

Assigned numbers: 48L, d_model=1280, 16H (kv=16), d_ff=5120, vocab=504
(masked-prediction cluster targets). Modality frontend is a STUB per the
assignment: input_specs provides precomputed frame embeddings. Positional
encoding adapted to RoPE (the conv-positional frontend is part of the stub).
Encoder-only => no decode shape cells.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab=504, act="gelu", norm="layer", causal=False, frontend="audio",
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=128,
    act="gelu", norm="layer", causal=False, frontend="audio",
    dtype="float32", remat="none",
)
