"""Gradient compression: symmetric per-tensor int8 with error feedback
(``src/repro/optim/compression.py``).

The train step quantizes each gradient leaf (after adding the residual
the last step left), dequantizes it for the optimizer and keeps the
quantization residual for the next step (EF-SGD, Karimireddy et al.,
2019). Rounding is half to even, as ``jnp.round``; the scale and the
quotient are fp32, so the same grads give the reference's bits.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.optimizer import tree_map

__all__ = ["int8_compress", "int8_decompress", "ErrorFeedbackState",
           "ef_init", "ef_compress_update"]


def int8_compress(x: torch.Tensor, amax: torch.Tensor | None = None):
    """-> (q int8, scale fp32 scalar), q = clip(round(x / scale), ±127)
    with scale = max(amax, 1e-12) / 127; ``amax`` defaults to the
    tensor's own absmax."""
    if amax is None:
        amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax.to(torch.float32), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


class ErrorFeedbackState(NamedTuple):
    residual: Any   # fp32 tree shaped like the grads


def ef_init(grads_like) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def ef_compress_update(grads, ef: ErrorFeedbackState):
    """-> (tree of (q, scale), new EF state): each leaf is compressed
    with the last residual added, and the new residual is what the int8
    grid lost of it."""
    def one(g, r):
        corrected = g.to(torch.float32) + r
        q, s = int8_compress(corrected)
        return (q, s), corrected - int8_decompress(q, s)

    pairs = tree_map(one, grads, ef.residual)
    qtree = tree_map(lambda _, p: p[0], grads, pairs)
    res = tree_map(lambda _, p: p[1], grads, pairs)
    return qtree, ErrorFeedbackState(residual=res)
