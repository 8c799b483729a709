"""Generalized semiring SpMM with cache-enabled backpropagation.

The paper's ``matmul`` (§3.5) with its two speed mechanisms:

* §3.2 — the autotuned kernel plan decides per (graph, K, semiring)
  whether a hand kernel (BSR tiles, SELL or ELL gather) or the trusted
  path (gather + ``index_add_`` / ``scatter_reduce``) runs. The reference
  gates the BSR kernel to K that is a multiple of 128 lanes; here the gate
  is the hardware model's ``lane``, which is 1 on the H100 (the CUDA
  kernel masks its last K tile), so GCN's second layer (K = 112) runs the
  BSR kernel too.
* §3.3 — cached backpropagation: the backward operand A^T (and the degree
  vectors) come from the :class:`CachedGraph` built once per graph, so no
  transpose, sort or normalization happens in a training step. The
  backward of a sum/mean SpMM is the SAME forward kernel on the cached
  transpose (mean pre-scales ``dy`` by the inverse degree); max/min keep a
  recompute subgradient on the trusted path. On the card every float
  scatter of a backward is an ordered segment sum over the graph's cached
  edge orders, so a step repeats bit for bit.

Only the dense operand is differentiated: the adjacency is static in
every GNN the paper targets. When ``h`` needs no gradient (a model's input
features), the backward computes nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core import sparse as sp
from repro_torch.core.autotune import H100
from repro_torch.core.cache import CachedGraph, build_cached_graph
from repro_torch.core.semiring import Semiring, get_semiring
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import _rows_per_chunk, coo_reduce, take_rows
from repro_torch.kernels import segment_sum as kseg

__all__ = ["spmm", "matmul"]

_BIG = torch.iinfo(torch.int64).max


def _lane_aligned(k: int) -> bool:
    return k % H100.lane == 0


def _bsr_ok(g: CachedGraph, sr: Semiring, k: int) -> bool:
    return (g.plan.wants_bsr and g.bsr is not None
            and sr.mxu_eligible and _lane_aligned(k))


def _sell_ok(g: CachedGraph, sr: Semiring) -> bool:
    # a gather kernel: any K, but the paper's semiring rule (sum; mean is
    # the post-scaled sum)
    return g.plan.wants_sell and g.sell is not None and sr.mxu_eligible


def _ell_ok(g: CachedGraph, sr: Semiring) -> bool:
    return g.plan.wants_ell and g.ell is not None and sr.mxu_eligible


def _forward(g: CachedGraph, h: torch.Tensor, sr: Semiring,
             transposed: bool) -> torch.Tensor:
    """One SpMM against A (or the *cached* A^T when ``transposed``).

    Hand kernels (BSR / SELL / ELL, per the plan) compute the sum semiring
    in fp32; mean applies the cached inverse degree after. Everything else
    takes the trusted path."""
    coo = g.coo_t if transposed else g.coo
    if _bsr_ok(g, sr, h.shape[-1]):
        bsr = g.bsr_t if transposed else g.bsr
        out = kops.bsr_spmm(bsr, h.float().contiguous())[: coo.nrows]
    elif _sell_ok(g, sr):
        out = kops.sell_spmm(g.sell_t if transposed else g.sell,
                             h.float().contiguous())
    elif _ell_ok(g, sr):
        out = kops.ell_spmm(g.ell_t if transposed else g.ell,
                            h.float().contiguous())
    else:
        return _trusted(g, h, sr, transposed)
    if sr.reduce == "mean":
        out = out * (g.inv_deg_t if transposed else g.inv_deg)[:, None]
    return out.to(h.dtype)


def _trusted(g: CachedGraph, h: torch.Tensor, sr: Semiring,
             transposed: bool, val=None) -> torch.Tensor:
    """The trusted segment path over A (or A^T: A's edges grouped by
    column, which is the cached transpose's order), ``val`` replacing A's
    values when given; on the card the graph's cached edge orders give
    the ordered sums their segments."""
    c = g.coo
    val = c.val if val is None else val
    if transposed:
        return coo_reduce(c.col, c.row, val, c.nse, c.ncols, h, sr,
                          g.degrees_t, order=g.col_order)
    return coo_reduce(c.row, c.col, val, c.nse, c.nrows, h, sr, g.degrees,
                      order=g.row_order)


def _backward_linear(g: CachedGraph, dy: torch.Tensor,
                     sr: Semiring) -> torch.Tensor:
    """dH = A^T · dY (combine 'mul') or P^T · dY (the pattern, for
    combine in {'add', 'second'}), on the CACHED transpose — §3.3."""
    sum_sr = get_semiring("sum")
    if sr.combine == "mul":
        return _forward(g, dy, sum_sr, transposed=True)
    return _trusted(g, dy, sum_sr, True, val=torch.ones_like(g.coo.val))


def _backward_maxmin(coo: sp.COO, col_order: kseg.SegmentOrder,
                     h: torch.Tensor, out: torch.Tensor, dy: torch.Tensor,
                     sr: Semiring) -> torch.Tensor:
    """Subgradient: route dy[i, k] to the first edge attaining the
    extremum, by recompute (no (edges, K) residual is stored), in chunks
    of edges. ``out`` is the forward (finalized or raw); it equals the raw
    extremum on every row that has an edge, and only such rows are read.
    ``coo``'s real edges (the first ``nse``) are summed into ``dh``'s
    ``ncols`` rows; on the card in ``col_order``, their stable sort by
    column (a graph's cached one, or a block's sorted on the device)."""
    k = h.shape[1]
    n = coo.nse
    step = _rows_per_chunk(1, k)
    winner = torch.full((coo.nrows, k), _BIG, dtype=torch.int64,
                        device=h.device)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        row = coo.row[lo:hi].long()
        msgs = sr.apply_combine(coo.val[lo:hi, None],
                                take_rows(h, coo.col[lo:hi]))
        eid = torch.arange(lo, hi, device=h.device)[:, None]
        cand = torch.where(msgs == out[row], eid, _BIG)
        winner.scatter_reduce_(0, row[:, None].expand_as(cand), cand, "amin")
    if kseg.on_card(dy):
        return _subgradient_ordered(coo, col_order, winner, dy, sr, step)
    dh = torch.zeros((coo.ncols, k), dtype=dy.dtype, device=dy.device)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        row = coo.row[lo:hi].long()
        eid = torch.arange(lo, hi, device=h.device)[:, None]
        contrib = torch.where(winner[row] == eid, dy[row], 0.0)
        if sr.combine == "mul":
            contrib = contrib * coo.val[lo:hi, None]
        dh.index_add_(0, coo.col[lo:hi].long(), contrib.to(dh.dtype))
    return dh


def _subgradient_ordered(coo: sp.COO, col_order: kseg.SegmentOrder,
                         winner: torch.Tensor, dy: torch.Tensor,
                         sr: Semiring, step: int) -> torch.Tensor:
    """The subgradient's scatter on the card: the edges in the column
    order, chunk by chunk, each column's routed rows summed in edge order
    by the ordered segment sum."""

    def routed(eid):
        row = coo.row[eid].long()
        contrib = torch.where(winner[row] == eid[:, None], dy[row], 0.0)
        if sr.combine == "mul":
            contrib = contrib * coo.val[eid, None]
        return contrib

    return kseg.chunked_sum(col_order, coo.nse, dy.shape[1], routed,
                            step).to(dy.dtype)


class _SpMM(torch.autograd.Function):
    """The cached-backprop boundary (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, g: CachedGraph, h: torch.Tensor, sr: Semiring):
        ctx.graph, ctx.semiring = g, sr
        if sr.reduce in ("max", "min"):
            out = coo_reduce(g.coo.row, g.coo.col, g.coo.val, g.coo.nse,
                             g.coo.nrows, h, sr)
            ctx.save_for_backward(h, out)
            return out
        return _forward(g, h, sr, transposed=False)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        g, sr = ctx.graph, ctx.semiring
        if sr.reduce == "sum":
            dh = _backward_linear(g, dy, sr)
        elif sr.reduce == "mean":
            dh = _backward_linear(g, dy * g.inv_deg[:, None], sr)
        else:
            h, out = ctx.saved_tensors
            dh = _backward_maxmin(g.coo, g.col_order, h, out, dy, sr)
        return None, dh, None


def spmm(g: CachedGraph, h: torch.Tensor, reduce: str = "sum",
         combine: str = "mul") -> torch.Tensor:
    """out[i,:] = ⊕_{j: A_ij≠0} (A_ij ⊗ h[j,:]) — differentiable in ``h``."""
    return _SpMM.apply(g, h, get_semiring(reduce, combine))


def matmul(a, h: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """The paper's user-facing interface (§3.5): ``matmul(sparse, dense,
    reduce)``. Takes a CachedGraph (preferred: one-time tuning and
    caching) or a raw COO/CSR (a CachedGraph is built ad hoc, untuned, on
    the host and moved to ``h``'s device)."""
    if isinstance(a, CachedGraph):
        return spmm(a, h, reduce=reduce)
    if isinstance(a, sp.CSR):
        a = sp.COO(row=a.row_ids, col=a.indices, val=a.val, nrows=a.nrows,
                   ncols=a.ncols, nse=a.nse)
    if isinstance(a, sp.COO):
        g = build_cached_graph(a, tune=False).to(h.device)
        return spmm(g, h, reduce=reduce)
    raise TypeError(f"unsupported sparse operand {type(a)}")
