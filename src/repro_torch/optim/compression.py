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

from repro_torch.optim.optimizer import tree_leaves, tree_map

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


def _whole_absmax(amax: list, shardings: list) -> list:
    """Each leaf's absmax ``amax``, max-reduced over the axes its
    sharding splits it over (one collective for the leaves of each set of
    axes, in the tree's order, the same on every rank): a split leaf's
    absmax is its whole leaf's."""
    from repro_torch.dist.collectives import pmax
    amax = list(amax)
    groups: dict = {}
    for i, sh in enumerate(shardings):
        axes = () if sh is None else tuple(
            a for d in range(len(sh.spec)) for a in sh.dim_axes(d)
            if int(sh.mesh.shape[a]) > 1)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        m = torch.stack([amax[i] for i in idx])
        for a in axes:
            m = pmax(m, shardings[idx[0]].mesh, a)
        for i, v in zip(idx, m):
            amax[i] = v
    return amax


def ef_compress_update(grads, ef: ErrorFeedbackState, shardings=None):
    """-> (tree of (q, scale), new EF state): each leaf is compressed
    with the last residual added, and the new residual is what the int8
    grid lost of it. ``shardings`` (a matching tree of
    ``dist.sharding.Sharding``, the leaves this rank's slices) makes a
    split leaf's scale its whole leaf's: its absmax is max-reduced over
    its split axes (the reference's ``amax`` override), so every rank
    quantises its slice onto the grid the whole leaf would take."""
    gs, rs = tree_leaves(grads), tree_leaves(ef.residual)
    if shardings is None:
        amax = [None] * len(gs)
    else:
        amax = _whole_absmax([torch.amax(torch.abs(g.to(torch.float32) + r))
                              for g, r in zip(gs, rs)],
                             tree_leaves(shardings))
    it = iter(amax)

    def one(g, r):
        corrected = g.to(torch.float32) + r
        q, s = int8_compress(corrected, amax=next(it))
        return (q, s), corrected - int8_decompress(q, s)

    pairs = tree_map(one, grads, ef.residual)
    qtree = tree_map(lambda _, p: p[0], grads, pairs)
    res = tree_map(lambda _, p: p[1], grads, pairs)
    return qtree, ErrorFeedbackState(residual=res)
