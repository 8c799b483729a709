"""GPipe-style pipeline parallelism over a stage-split parameter stack
(``src/repro/dist/pipeline.py``).

``pipeline_apply`` runs ``fn`` (one stage's computation) S times over an
(S, ...) parameter stack, one stage a rank: at step ``t`` rank ``i``
computes microbatch ``t - i`` (when in range) and hands its activation
to rank ``i + 1`` (``dist.collectives._ppermute``, one ring hop: staged
through host buffers where gloo carries card tensors, since gloo aborts
on a card pointer in a send). The pipeline fills for S - 1 steps, runs
full, and drains for S - 1 steps; the last stage's drained outputs are
summed over the axis, so every rank returns them. The reference runs the
same schedule inside ``shard_map`` with ``ppermute`` and a ``psum``.

Forward only, as the reference's test uses it: under autograd it raises
(the backward schedule is ROADMAP.md queue 1, item 5b.6).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dist.collectives import _axis_total, _ppermute, axis_size

__all__ = ["pipeline_apply"]

_BACKWARD = ("pipeline_apply under autograd: the pipeline's backward "
             "schedule is not ported (ROADMAP.md queue 1, item 5b.6)")


def _pipeline_axis(mesh) -> str:
    return "pipe" if "pipe" in mesh.shape else next(iter(mesh.shape))


def pipeline_apply(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   mesh, params: torch.Tensor, x: torch.Tensor,
                   microbatches: int = 4) -> torch.Tensor:
    """y = fn(params[S-1], ... fn(params[1], fn(params[0], x))).

    ``params``: the whole (S, ...) stage stack, S the size of the
    pipeline axis (``'pipe'`` when the mesh has it, else its first axis);
    this rank keeps its stage, ``params[i]`` on the axis's ``i``-th rank.
    ``x``: (B, ...) with B divisible by ``microbatches``, the same on
    every rank. Returns (B, ...) on every rank. Every rank of the axis
    calls it."""
    if torch.is_grad_enabled() and (params.requires_grad
                                    or x.requires_grad):
        raise NotImplementedError(_BACKWARD)
    axis = _pipeline_axis(mesh)
    s = axis_size(mesh, axis)
    if params.shape[0] != s:
        raise ValueError(f"a stack of {params.shape[0]} stages over the "
                         f"{s} ranks of {axis!r}")
    b, m = x.shape[0], int(microbatches)
    if b % m:
        raise ValueError(f"a batch of {b} does not split into {m} "
                         "microbatches")
    mb = x.reshape(m, b // m, *x.shape[1:])
    me = mesh.index(axis)
    w = params[me]
    buf = torch.zeros_like(mb[0])
    outs = torch.zeros_like(mb)
    for t in range(s + m - 1):
        # stage 0 ingests microbatch t (clamped during the drain: its
        # results past m never reach the last stage inside the window)
        cur = mb[min(t, m - 1)] if me == 0 else buf
        y = fn(w, cur)
        slot = t - (s - 1)                      # drains at the last stage
        if me == s - 1 and 0 <= slot < m:
            outs[slot] = y
        buf = _ppermute(y, mesh, axis, shift=1) if s > 1 else y
    if s > 1:
        # replicate the drained outputs (only the last stage holds them)
        outs = _axis_total(outs if me == s - 1 else torch.zeros_like(outs),
                           mesh, axis)
    return outs.reshape(b, *x.shape[1:])
