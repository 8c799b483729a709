"""SDDMM — sampled dense-dense matmul over a graph's sparsity pattern.

``sddmm(g, x, y)`` returns per-edge scores s_e = x[row_e] · y[col_e]
(optionally scaled by A's values). Differentiable in x and y; the
backward is two segment sums over the CachedGraph's edges (no transpose
at step time — the same §3.3 discipline as spmm), ordered on the card
over the graph's cached row and column orders, so they repeat bit for
bit. The forward is the per-edge path, as in the reference: on the card
the per-edge SDDMM kernel (``kernels/edge_dots``), on the CPU its plain
version. The BSR SDDMM kernel returns tile scores, not edge scores, and
is reached through ``kernels.ops.sddmm_bsr``.
"""
from __future__ import annotations

import torch

from repro_torch.core.cache import CachedGraph
from repro_torch.core.semiring import get_semiring
from repro_torch.kernels.edge_dots import edge_dots
from repro_torch.kernels.ref import coo_reduce

__all__ = ["sddmm", "masked_edge_scores"]


def masked_edge_scores(xs: torch.Tensor, ys: torch.Tensor,
                       valid: torch.Tensor,
                       scale: torch.Tensor | None = None) -> torch.Tensor:
    """Slot-wise sampled dot products: ``sum(xs * ys, -1)``, invalid slots
    zeroed, optionally scaled by A's values. ``xs``/``ys`` broadcast
    against each other, so one definition serves the flat per-edge layout
    (``(nnz, D)`` each) and row-against-neighbour tile layouts
    (``(rows, 1, D)`` against ``(rows, max_deg, D)``)."""
    s = (xs * ys).sum(-1)
    if scale is not None:
        s = s * scale
    return torch.where(valid, s, 0.0)


class _SDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: CachedGraph, x: torch.Tensor, y: torch.Tensor,
                scale_by_a: bool):
        ctx.graph, ctx.scale_by_a = g, scale_by_a
        ctx.save_for_backward(x, y)
        coo, n = g.coo, g.coo.nse
        s = edge_dots(x, y, coo.row[:n], coo.col[:n])
        if scale_by_a:
            s = s * coo.val[:n]
        return torch.cat([s, s.new_zeros((coo.nnz_padded - n,))])

    @staticmethod
    def backward(ctx, ds: torch.Tensor):
        x, y = ctx.saved_tensors
        g = ctx.graph
        coo, n = g.coo, g.coo.nse
        row, col = coo.row[:n], coo.col[:n]
        w = ds[:n] * coo.val[:n] if ctx.scale_by_a else ds[:n]
        add = get_semiring("sum")
        dx = coo_reduce(row, col, w, n, x.shape[0], y, add,
                        order=CachedGraph.order_for(g.row_order, x)) \
            if ctx.needs_input_grad[1] else None
        dy = coo_reduce(col, row, w, n, y.shape[0], x, add,
                        order=CachedGraph.order_for(g.col_order, y)) \
            if ctx.needs_input_grad[2] else None
        return None, dx, dy, None


def sddmm(g: CachedGraph, x: torch.Tensor, y: torch.Tensor, *,
          scale_by_a: bool = True) -> torch.Tensor:
    """Per-edge scores ``(nnz_padded,)``, zero on padding entries."""
    return _SDDMM.apply(g, x, y, scale_by_a)
