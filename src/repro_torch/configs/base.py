"""Model / shape configuration schema for the assigned architectures.

One :class:`ModelConfig` fully describes an LM-family architecture
(dense / MoE / SSM / hybrid / audio encoder / VLM backbone). The model code
in ``repro_torch.models.lm`` is config-driven; ``repro_torch/configs/<arch>.py`` files
hold the exact published numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["ModelConfig", "ShapeCell", "LM_SHAPES", "shape_cells_for",
           "FULL_ATTN_WINDOW"]

FULL_ATTN_WINDOW = 1 << 30   # sentinel: "window" large enough to be full


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    act: str = "silu"               # silu | gelu
    norm: str = "rms"               # rms | layer
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    causal: bool = True             # False: encoder-only (hubert)
    # sliding-window / hybrid attention pattern
    window: Optional[int] = None    # SWA width; None = full attention
    global_layers: tuple = ()       # layer ids that use full attention anyway
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # expert replicas: pad E up to the model-axis width so EP shards exactly
    # (mixtral: 8e x 2 replicas on a 16-wide axis). Replica grads are tied in
    # the train step; see DESIGN.md §Arch-applicability.
    n_expert_replicas: int = 1
    # SSM (mamba2 SSD / hymba heads)
    ssm: bool = False
    hybrid: bool = False            # parallel attn + ssm in one layer (hymba)
    d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    n_groups: int = 1
    d_conv: int = 4
    # meta tokens (hymba) / modality prefix (internvl)
    n_meta_tokens: int = 0
    frontend: Optional[str] = None  # 'audio' | 'vision' | None
    n_prefix_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    remat: str = "full"             # none | full | dots
    vocab_pad_to: int = 256
    logit_chunk: int = 1024
    # paper tie-in: MoE dispatch via the sparse dispatch path
    moe_sparse_dispatch: bool = True

    # ----- derived -----------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_rep(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def has_attention(self) -> bool:
        return not self.ssm

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def layer_windows(self, seq_len: int) -> np.ndarray:
        """Per-layer attention window (scanned operand). Full attention (or a
        window >= seq) is encoded as FULL_ATTN_WINDOW."""
        w = self.window if self.window is not None else FULL_ATTN_WINDOW
        out = np.full(self.n_layers, min(w, FULL_ATTN_WINDOW), np.int32)
        for i in self.global_layers:
            out[i] = FULL_ATTN_WINDOW
        return out

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        per_layer = 0
        if self.has_attention or self.hybrid:
            per_layer += d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        if self.ssm or self.hybrid:
            di, g, n = self.d_inner, self.n_groups, self.d_state
            per_layer += d * (2 * di + 2 * g * n + self.n_ssm_heads)
            per_layer += self.d_conv * self.conv_dim
            per_layer += di * d + 2 * self.n_ssm_heads
        if self.n_experts:
            per_layer += d * self.n_experts          # router
            per_layer += self.n_experts * 3 * d * f  # gate/up/down
        elif f:
            per_layer += 3 * d * f
        per_layer += 2 * d                            # norms
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count() \
            - self.n_layers * self.n_experts * 3 * d * f
        return dense_like + self.n_layers * self.top_k * 3 * d * f


# --------------------------------------------------------------------------
# Shape cells (assignment): each LM arch x these four, with documented skips
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


LM_SHAPES = {
    "train_4k":    ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeCell("long_500k", "decode", 524_288, 1),
}

# archs that may run the 500k decode cell (sub-quadratic / bounded-KV)
_SUBQUADRATIC = ("mamba2-1.3b", "hymba-1.5b", "mixtral-8x7b")


def shape_cells_for(cfg: ModelConfig) -> list[ShapeCell]:
    """The assignment's skip rules (mirrored in DESIGN.md §Shape-cells)."""
    cells = [LM_SHAPES["train_4k"], LM_SHAPES["prefill_32k"]]
    if cfg.is_encoder:               # hubert: no decode step exists
        return cells
    cells.append(LM_SHAPES["decode_32k"])
    if cfg.name in _SUBQUADRATIC:
        cells.append(LM_SHAPES["long_500k"])
    return cells
