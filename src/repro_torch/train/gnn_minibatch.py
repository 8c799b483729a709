"""The block model shared by minibatch training and online serving.

This slice ports the forward only: :func:`make_block_model` is what the
serving path (``repro_torch.serving``) runs on every flush, layer for
layer the reference's. The minibatch trainer and the exact layer-wise
full-neighbor inference come with later slices (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models.gnn import layers as L

__all__ = ["MB_ARCHS", "make_block_model", "layerwise_inference"]

MB_ARCHS = ("sage-sum", "sage-mean", "sage-max", "gin")


def _block_arch(arch: str):
    """(aggr-or-None, semiring) for a minibatch-capable arch."""
    if arch not in MB_ARCHS:
        raise ValueError(f"minibatch arch must be one of {MB_ARCHS}, "
                         f"got {arch!r}")
    if arch == "gin":
        return None, "sum"
    aggr = arch.split("-")[1]
    return aggr, aggr


def make_block_model(arch: str, in_dim: int, hidden: int, out_dim: int,
                     n_layers: int):
    """init/apply over a block stack. Params are layer-keyed ('l0', 'l1',
    ...) with the reference's per-layer structure.

    Returns ``(init, conv, apply_blocks, dims)``: ``init(generator,
    device="cuda")`` draws the params from a ``torch.Generator``;
    ``conv(p_l, pb, h)`` applies one layer over one packed block;
    ``apply_blocks(params, pbs, h)`` folds a whole block stack with
    inter-layer relu (none after the last layer)."""
    aggr, _ = _block_arch(arch)
    dims = [in_dim] + [hidden] * (n_layers - 1) + [out_dim]
    init_one = L.init_gin if arch == "gin" else L.init_sage

    def init(generator: torch.Generator, device="cuda"):
        return {f"l{i}": init_one(generator, dims[i], dims[i + 1],
                                  device=device)
                for i in range(n_layers)}

    def conv(p_l, pb, h):
        if arch == "gin":
            return L.gin_conv_block(p_l, pb, h)
        return L.sage_conv_block(p_l, pb, h, aggr=aggr)

    def apply_blocks(params, pbs, h):
        for i, pb in enumerate(pbs):
            h = conv(params[f"l{i}"], pb, h)
            if i < len(pbs) - 1:
                h = torch.relu(h)
        return h

    return init, conv, apply_blocks, dims


def layerwise_inference(*args, **kwargs):
    """Exact full-neighbor layer-wise inference: not ported yet (ROADMAP.md
    queue 1, item 1: historical mode, layerwise_inference and
    gathered_ell_spmm)."""
    raise NotImplementedError(
        "layerwise_inference is not ported yet: ROADMAP.md queue 1, item 1 "
        "(historical mode, layerwise_inference, gathered_ell_spmm)")
