"""Baseline sparse paths the paper compares against ("PyTorch-equivalent").

The paper's baselines are PyTorch/PyG sparse training: normalization in
every step, a transpose in every backward, no kernel specialization. Here
they are plain PyTorch on the same device as the tuned path, so a speedup
is measured against a same-framework opponent:

* ``spmm_uncached``           — the trusted gather + ``index_add_`` /
  ``scatter_reduce`` with plain autograd, degrees recomputed per call;
  autograd's backward of the gather is itself transpose-free.
* ``spmm_uncached_transpose`` — additionally rebuilds A^T (a sort of the
  edges by column) in every backward, which is what pytorch_sparse's
  csr2csc does when nothing is cached.
* ``gcn_norm_in_step``        — D^-1/2 (A+I) D^-1/2 recomputed per forward
  (the uncached normalization §3.3 removes).
* ``fusedmm_uncached``        — SDDMM, edge op and SpMM unfused under plain
  autograd, which keeps the gathered per-edge operands of every chunk
  (the edge tensors FusedMM avoids).

They take the same COO the tuned path's CachedGraph wraps.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sparse as sp
from repro_torch.core.semiring import get_semiring
from repro_torch.kernels.ref import coo_reduce, fusedmm_coo_ref

__all__ = ["spmm_uncached", "spmm_uncached_transpose", "gcn_norm_in_step",
           "fusedmm_uncached"]


def _as_coo(a) -> sp.COO:
    from repro_torch.core.cache import CachedGraph
    if isinstance(a, CachedGraph):
        return a.coo
    if not isinstance(a, sp.COO):
        raise TypeError(f"unsupported sparse operand {type(a)}")
    return a


def spmm_uncached(a, h: torch.Tensor, reduce: str = "sum",
                  combine: str = "mul") -> torch.Tensor:
    """Trusted path, plain autograd, degrees recomputed per call."""
    coo = _as_coo(a)
    deg = sp.row_degrees(coo) if reduce == "mean" else None
    return coo_reduce(coo.row, coo.col, coo.val, coo.nse, coo.nrows, h,
                      get_semiring(reduce, combine), deg)


class _SpMMTransposeEachStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coo: sp.COO, h: torch.Tensor, reduce: str):
        ctx.coo, ctx.reduce = coo, reduce
        return spmm_uncached(coo, h, reduce)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        a, n = ctx.coo, ctx.coo.nse
        # EXPLICIT per-backward transpose: sort the edges by (col, row) —
        # the csr2csc cost pytorch_sparse pays when nothing is cached
        row, col = a.row[:n].long(), a.col[:n].long()
        order = torch.argsort(col * a.nrows + row, stable=True)
        row_t, col_t, val_t = col[order], row[order], a.val[:n][order]
        if ctx.reduce == "mean":
            dy = dy * (1.0 / torch.clamp(sp.row_degrees(a), min=1.0))[:, None]
        dh = coo_reduce(row_t, col_t, val_t, n, a.ncols, dy,
                        get_semiring("sum"))
        return None, dh, None


def spmm_uncached_transpose(a, h: torch.Tensor,
                            reduce: str = "sum") -> torch.Tensor:
    """PyTorch-equivalent: the backward rebuilds A^T (a sort) every step."""
    if reduce not in ("sum", "mean"):
        raise ValueError("transpose baseline: linear reductions only")
    return _SpMMTransposeEachStep.apply(_as_coo(a), h, reduce)


def gcn_norm_in_step(a) -> sp.COO:
    """Symmetric GCN normalization executed INSIDE the step (uncached
    baseline). Self-loops must be in ``a`` already (the dataset's
    ``coo_sl``): this recomputes only the degree scaling — PyG's gcn_norm
    cost."""
    coo = _as_coo(a)
    valid = torch.arange(coo.nnz_padded, device=coo.val.device) < coo.nse
    val = torch.where(valid, coo.val, 0.0)
    deg = torch.zeros(coo.nrows, dtype=val.dtype, device=val.device)
    deg.index_add_(0, coo.row.long(), val)
    dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
    col = torch.clamp(coo.col.long(), max=coo.nrows - 1)
    new_val = dinv[coo.row.long()] * val * dinv[col]
    return dataclasses.replace(coo, val=new_val)


def fusedmm_uncached(a, x: torch.Tensor, y: torch.Tensor, h: torch.Tensor,
                     *, edge_op: str = "softmax") -> torch.Tensor:
    """Unfused composition (per-edge products materialized), plain
    autograd."""
    return fusedmm_coo_ref(_as_coo(a), x, y, h, edge_op=edge_op)
