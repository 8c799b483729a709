"""FusedMM: SDDMM → edge nonlinearity → SpMM without materializing the
edge tensor in device memory (paper §3.4 / FusedMM, Rahman et al.
IPDPS'21).

The forward runs the fused BSR kernel when the plan has BSR tiles and K
is a multiple of 128 (the reference's routing, kept so that the same
layers take the kernel in both packages), else the trusted composition.
The backward is recompute-based (flash-attention style): only (x, y, h)
are kept, and the edge scores and weights are rebuilt per edge in the
backward, in chunks of edges, as plain PyTorch (the reference has no
backward kernel here). Only ``(edges,)`` scalars exist whole; the
gradient scatters are ``index_add_``.
"""
from __future__ import annotations

import torch

from repro_torch.core.cache import CachedGraph
from repro_torch.core.semiring import get_semiring
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fusedmm import EDGE_OPS
from repro_torch.kernels.ref import (coo_reduce, edge_dots, edge_weights,
                                     fusedmm_coo_ref)

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
        return fusedmm_coo_ref(g.coo, x, y, h, edge_op=edge_op)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        x, y, h = ctx.saved_tensors
        coo, n = ctx.graph.coo, ctx.graph.coo.nse
        row, col = coo.row[:n], coo.col[:n]
        add = get_semiring("sum")
        w = edge_weights(edge_dots(x, y, row, col), row, coo.nrows, None,
                         ctx.edge_op)                       # recompute
        dh = coo_reduce(col, row, w, n, h.shape[0], dout, add) \
            if ctx.needs_input_grad[3] else None
        dx = dy = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # dL/dw_e = dout[row_e] · h[col_e]; then the edge op's jacobian
            dw = edge_dots(dout, h, row, col)
            if ctx.edge_op == "softmax":
                wd = w * dw
                srow = torch.zeros((coo.nrows,), dtype=wd.dtype,
                                   device=wd.device)
                srow.index_add_(0, row.long(), wd)
                ds = wd - w * srow[row.long()]
            elif ctx.edge_op == "sigmoid":
                ds = dw * w * (1.0 - w)
            else:
                ds = dw
            if ctx.needs_input_grad[1]:
                dx = coo_reduce(row, col, ds, n, x.shape[0], y, add)
            if ctx.needs_input_grad[2]:
                dy = coo_reduce(col, row, ds, n, y.shape[0], x, add)
        return None, dx, dy, dh, None


def fusedmm(g: CachedGraph, x: torch.Tensor, y: torch.Tensor,
            h: torch.Tensor, *, edge_op: str = "softmax") -> torch.Tensor:
    """out[i] = Σ_j f(x_i·y_j) h_j over sparsity(A); f ∈ {softmax over the
    row's neighborhood, sigmoid, none}. Differentiable in x, y, h."""
    if edge_op not in EDGE_OPS:
        raise ValueError(f"edge_op {edge_op!r} not in {EDGE_OPS}")
    return _FusedMM.apply(g, x, y, h, edge_op)
