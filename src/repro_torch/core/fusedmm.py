"""FusedMM: SDDMM → edge nonlinearity → SpMM without materializing the
edge tensor in device memory (paper §3.4 / FusedMM, Rahman et al.
IPDPS'21).

The forward runs the fused BSR kernel when the plan has BSR tiles and K
is a multiple of 128 (the reference's routing, kept so that the same
layers take the kernel in both packages), else the trusted composition:
the per-edge scores, the edge op, and a segment sum. The backward is
recompute-based (flash-attention style): only (x, y, h) are kept, and the
edge scores and weights are rebuilt per edge (the reference has no
backward kernel here). Only ``(edges,)`` scalars exist whole.

On the card the per-edge dot products are the per-edge SDDMM kernel
(``kernels/edge_dots``; the backward's recomputed scores and its
``dw_e = dout_row · h_col`` are one launch over the edge list), and the
gradient scatters are ordered segment sums over the graph's cached edge
orders (``kernels/segment_sum``), so a step repeats bit for bit. On the
CPU the plain versions run and the scatters are sequential
``index_add_``.
"""
from __future__ import annotations

import torch

from repro_torch.core.cache import CachedGraph
from repro_torch.core.semiring import get_semiring
from repro_torch.kernels import ops as kops
from repro_torch.kernels.edge_dots import edge_dots
from repro_torch.kernels.fusedmm import EDGE_OPS
from repro_torch.kernels.ref import coo_reduce, edge_weights
from repro_torch.kernels import segment_sum as kseg

__all__ = ["fusedmm", "edge_weights"]


def _use_fused_kernel(g: CachedGraph, k: int) -> bool:
    return g.plan.wants_bsr and g.bsr is not None and k % 128 == 0


class _FusedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: CachedGraph, x: torch.Tensor, y: torch.Tensor,
                h: torch.Tensor, edge_op: str):
        ctx.graph, ctx.edge_op = g, edge_op
        ctx.save_for_backward(x, y, h)
        if _use_fused_kernel(g, h.shape[-1]):
            out = kops.fusedmm_bsr(g.bsr, x.float().contiguous(),
                                   y.float().contiguous(),
                                   h.float().contiguous(), edge_op=edge_op)
            return out[: g.coo.nrows].to(h.dtype)
        coo, n = g.coo, g.coo.nse
        w = edge_weights(edge_dots(x, y, coo.row[:n], coo.col[:n]),
                         coo.row[:n], coo.nrows, None, edge_op,
                         order=g.row_order)
        return coo_reduce(coo.row, coo.col, w, n, coo.nrows, h,
                          get_semiring("sum"), order=g.row_order)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        x, y, h = ctx.saved_tensors
        g = ctx.graph
        coo, n = g.coo, g.coo.nse
        row, col = coo.row[:n], coo.col[:n]
        add = get_semiring("sum")
        need_dh = ctx.needs_input_grad[3]
        need_dx, need_dy = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        if need_dx or need_dy:
            # the recomputed scores and dL/dw_e = dout[row_e] · h[col_e]
            s, dw = edge_dots(x, y, row, col, dout, h)
        else:
            s, dw = edge_dots(x, y, row, col), None
        w = edge_weights(s, row, coo.nrows, None, ctx.edge_op,
                         order=g.row_order)
        dh = dx = dy = None
        if need_dx or need_dy:
            # the edge op's jacobian
            if ctx.edge_op == "softmax":
                wd = w * dw
                srow = kseg.scatter_sum(wd, row, coo.nrows, g.row_order)
                ds = wd - w * srow[row.long()]
            elif ctx.edge_op == "sigmoid":
                ds = dw * w * (1.0 - w)
            else:
                ds = dw
            if need_dx:
                dx = coo_reduce(row, col, ds, n, x.shape[0], y, add,
                                order=CachedGraph.order_for(g.row_order, x))
            if need_dy:
                dy = coo_reduce(col, row, ds, n, y.shape[0], x, add,
                                order=CachedGraph.order_for(g.col_order, y))
        if need_dh:
            dh = coo_reduce(col, row, w, n, h.shape[0], dout, add,
                            order=CachedGraph.order_for(g.col_order, h))
        return None, dx, dy, dh, None


def fusedmm(g: CachedGraph, x: torch.Tensor, y: torch.Tensor,
            h: torch.Tensor, *, edge_op: str = "softmax") -> torch.Tensor:
    """out[i] = Σ_j f(x_i·y_j) h_j over sparsity(A); f ∈ {softmax over the
    row's neighborhood, sigmoid, none}. Differentiable in x, y, h."""
    if edge_op not in EDGE_OPS:
        raise ValueError(f"edge_op {edge_op!r} not in {EDGE_OPS}")
    return _FusedMM.apply(g, x, y, h, edge_op)
