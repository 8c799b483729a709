"""Sparse matrix containers for GNN message passing, as dataclasses of
torch tensors.

Construction and conversion are host-side numpy, once per graph (or once
per sampled block); the constructors return CPU tensors and
:func:`to_device` moves any container (nested ones included) to the
device that runs the kernels.

Formats
-------
COO   : canonical triplet form; the trusted (``index_add_`` /
        ``scatter_reduce``) reduce and every reference consume this.
CSR   : indptr/indices/val plus the cached expanded ``row_ids``.
BSR   : block-sparse rows of dense Br x Bc tiles — the tiled ("generated")
        kernel format for full-graph training.
ELL   : ELLPACK (row-padded neighbor lists) — the gather kernel format for
        fanout-capped sampled blocks.
SELL  : SELL-C-σ (sliced ELLPACK) — rows sorted by degree within windows
        of σ, packed into slices of C rows, each slice padded only to its
        own max degree.

Conventions match the reference package exactly (the parity tests compare
the index tables bitwise): COO pads ``row = nrows - 1, col = 0, val = 0``;
ELL/SELL pad slots hold the one-past-the-end sentinel ``idx == ncols``
with ``val == 0``; BSR padding blocks replicate the last block row with
zero data.

The graph-static precomputations that cached backpropagation reuses
(:func:`coo_transpose`, :func:`row_degrees`, :func:`gcn_normalize`) are
here too, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

Array = Any

__all__ = [
    "COO",
    "CSR",
    "BSR",
    "ELL",
    "SELL",
    "coo_from_edges",
    "csr_from_coo",
    "bsr_from_coo",
    "ell_from_coo",
    "sell_from_coo",
    "sell_slice_degrees",
    "to_device",
    "coo_transpose",
    "row_degrees",
    "gcn_normalize",
]


def _np(x) -> np.ndarray:
    """Host numpy view of a tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x: np.ndarray, dtype=None) -> torch.Tensor:
    """CPU tensor owning a copy of ``x`` (optionally cast)."""
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True, order="C"))


def to_device(obj, device):
    """``obj`` with every tensor field (recursively through nested
    dataclasses) moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if not dataclasses.is_dataclass(obj):
        return obj
    moved = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            moved[f.name] = to_device(v, device)
    return dataclasses.replace(obj, **moved)


@dataclasses.dataclass(frozen=True)
class COO:
    """Triplet sparse matrix. Entries past ``nse`` are zero-padding."""

    row: Array  # (nnz_padded,) int32
    col: Array  # (nnz_padded,) int32
    val: Array  # (nnz_padded,) float
    nrows: int
    ncols: int
    nse: int    # number of real (non-pad) entries

    @property
    def nnz_padded(self) -> int:
        return self.row.shape[0]

    @property
    def shape(self):
        return (self.nrows, self.ncols)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse rows; ``row_ids`` is the cached COO row expansion."""

    indptr: Array   # (nrows+1,) int32
    indices: Array  # (nnz_padded,) int32
    val: Array      # (nnz_padded,)
    row_ids: Array  # (nnz_padded,) int32
    nrows: int
    ncols: int
    nse: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse rows, sorted by (block_row, block_col).

    Invariants (enforced by :func:`bsr_from_coo`, relied on by the kernel):
      * blocks sorted by (blk_row, blk_col);
      * every block row owns at least one block (an explicit zero block if
        it is empty);
      * padding blocks replicate the final block row with zero data, so
        they fall inside that row's range and add nothing;
      * nrows % br == 0 and ncols % bc == 0 (the matrix is padded up front).
    """

    blk_row: Array  # (nblocks,) int32
    blk_col: Array  # (nblocks,) int32
    blocks: Array   # (nblocks, br, bc)
    nrows: int      # padded row count (multiple of br)
    ncols: int      # padded col count (multiple of bc)
    br: int
    bc: int
    n_real_blocks: int

    @property
    def nblocks(self) -> int:
        return self.blk_row.shape[0]

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def n_block_rows(self) -> int:
        return self.nrows // self.br

    @property
    def density(self) -> float:
        total = self.n_block_rows * (self.ncols // self.bc)
        return self.n_real_blocks / max(total, 1)


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: per-row padded neighbor lists. Pad slots have ``idx == ncols``
    (one-past-the-end sentinel) and ``val == 0``."""

    idx: Array  # (nrows, max_deg) int32
    val: Array  # (nrows, max_deg)
    nrows: int
    ncols: int
    nse: int

    @property
    def max_deg(self) -> int:
        return self.idx.shape[1]

    @property
    def shape(self):
        return (self.nrows, self.ncols)


@dataclasses.dataclass(frozen=True)
class SELL:
    """SELL-C-σ: degree-sorted sliced ELLPACK, degree-major packed.

    Packed step ``t`` holds the d-th neighbor of all ``c`` rows of one
    slice, so ``idx``/``val`` have shape ``(n_steps, c)``. ``slice_of[t]``
    is the owning slice (monotonic); ``first_step[t] == 1`` marks a
    slice's first step. ``perm`` maps sorted position -> original row over
    the padded row range (positions >= nrows are degree-0 pad rows);
    ``inv_perm`` maps original row -> sorted position.
    """

    idx: Array         # (n_steps, c) int32; pad slots == ncols sentinel
    val: Array         # (n_steps, c)
    slice_of: Array    # (n_steps,) int32
    first_step: Array  # (n_steps,) int32 (0/1)
    perm: Array        # (nslices * c,) int32
    inv_perm: Array    # (nrows,) int32
    nrows: int
    ncols: int
    nse: int
    c: int
    sigma: int
    nslices: int

    @property
    def n_steps(self) -> int:
        return self.idx.shape[0]

    @property
    def nrows_padded(self) -> int:
        return self.nslices * self.c

    @property
    def shape(self):
        return (self.nrows, self.ncols)


# --------------------------------------------------------------------------
# Host-side constructors (numpy; run once per graph or block)
# --------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def coo_from_edges(src, dst, val, nrows: int, ncols: int,
                   pad_to: int | None = None, dtype=np.float32) -> COO:
    """Row-major-sorted COO from edge lists. ``dst -> row`` so that
    ``spmm(A, H)[i]`` aggregates over in-neighbors of i."""
    src = np.asarray(_np(src), np.int32)
    dst = np.asarray(_np(dst), np.int32)
    if val is None:
        val = np.ones(src.shape[0], dtype)
    order = np.lexsort((src, dst))
    row, col, val = dst[order], src[order], np.asarray(_np(val), dtype)[order]
    nse = row.shape[0]
    tot = pad_to if pad_to is not None else nse
    assert tot >= nse
    row = np.concatenate([row, np.full(tot - nse, max(nrows - 1, 0), np.int32)])
    col = np.concatenate([col, np.zeros(tot - nse, np.int32)])
    val = np.concatenate([val, np.zeros(tot - nse, dtype)])
    return COO(row=_t(row), col=_t(col), val=_t(val),
               nrows=nrows, ncols=ncols, nse=nse)


def csr_from_coo(a: COO) -> CSR:
    row = _np(a.row)[: a.nse]
    col = _np(a.col)[: a.nse]
    val = _np(a.val)[: a.nse]
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    indptr = np.zeros(a.nrows + 1, np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    pad = a.nnz_padded - a.nse
    col = np.concatenate([col, np.zeros(pad, np.int32)])
    val = np.concatenate([val, np.zeros(pad, val.dtype)])
    row_ids = np.concatenate([row, np.full(pad, max(a.nrows - 1, 0), np.int32)])
    return CSR(indptr=_t(indptr), indices=_t(col, np.int32), val=_t(val),
               row_ids=_t(row_ids, np.int32),
               nrows=a.nrows, ncols=a.ncols, nse=a.nse)


def bsr_from_coo(a: COO, br: int = 128, bc: int = 128,
                 pad_blocks_to: int | None = None) -> BSR:
    """Tile a COO matrix into dense Br x Bc blocks (host-side).

    Every block row is guaranteed >= 1 block (explicit zeros) — see BSR
    invariants. Rows/cols are padded up to multiples of (br, bc); duplicate
    entries accumulate. The tile array is handed to torch without a copy
    (at full graph scale it is gigabytes)."""
    nrows_p, ncols_p = _round_up(a.nrows, br), _round_up(a.ncols, bc)
    n_brows, n_bcols = nrows_p // br, ncols_p // bc
    row = _np(a.row)[: a.nse].astype(np.int64)
    col = _np(a.col)[: a.nse].astype(np.int64)
    val = _np(a.val)[: a.nse]

    key = (row // br) * n_bcols + col // bc
    uniq, inv = np.unique(key, return_inverse=True)
    ub_row, ub_col = uniq // n_bcols, uniq % n_bcols

    # ensure every block row non-empty
    missing = np.setdiff1d(np.arange(n_brows), ub_row)
    all_rows = np.concatenate([ub_row, missing])
    all_cols = np.concatenate([ub_col, np.zeros(len(missing), np.int64)])
    order = np.lexsort((all_cols, all_rows))
    all_rows, all_cols = all_rows[order], all_cols[order]
    n_real = len(all_rows)

    # map original unique-block index -> slot after sort/merge
    slot_of_uniq = np.empty(n_real, np.int64)
    slot_of_uniq[order] = np.arange(n_real)

    nb = pad_blocks_to if pad_blocks_to is not None else n_real
    assert nb >= n_real, (nb, n_real)
    blocks = np.zeros((nb, br, bc), val.dtype)
    flat = (slot_of_uniq[inv.reshape(-1)] * br + row % br) * bc + col % bc
    np.add.at(blocks.reshape(-1), flat, val)  # duplicates accumulate
    pad = nb - n_real
    last = all_rows[-1] if n_real else 0
    blk_row = np.concatenate([all_rows, np.full(pad, last, np.int64)])
    blk_col = np.concatenate([all_cols, np.zeros(pad, np.int64)])
    return BSR(blk_row=_t(blk_row, np.int32), blk_col=_t(blk_col, np.int32),
               blocks=torch.from_numpy(blocks), nrows=nrows_p, ncols=ncols_p,
               br=br, bc=bc, n_real_blocks=n_real)


def ell_from_coo(a: COO, max_deg: int | None = None) -> ELL:
    """Degenerate cases are explicit: an empty graph and a requested
    ``max_deg == 0`` both yield a single all-sentinel column, so the
    kernels always see ``max_deg >= 1``."""
    row = _np(a.row)[: a.nse]
    col = _np(a.col)[: a.nse]
    val = _np(a.val)[: a.nse]
    counts = np.bincount(row, minlength=a.nrows)
    md = (int(counts.max()) if counts.size else 0) if max_deg is None \
        else max_deg
    md = max(md, 1)
    idx = np.full((a.nrows, md), a.ncols, np.int32)   # sentinel
    v = np.zeros((a.nrows, md), val.dtype)
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    slot = np.arange(len(row)) - np.repeat(np.cumsum(counts) - counts, counts)
    keep = slot < md
    idx[row[keep], slot[keep]] = col[keep]
    v[row[keep], slot[keep]] = val[keep]
    return ELL(idx=_t(idx), val=_t(v), nrows=a.nrows, ncols=a.ncols,
               nse=a.nse)


def sell_slice_degrees(degrees: np.ndarray, c: int, sigma: int = 0
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Window-sort rows by degree and compute per-slice max degrees.

    Shared by :func:`sell_from_coo` and the autotuner's cost model so both
    see the same packed-step count. ``sigma == 0`` sorts globally;
    otherwise sigma is rounded up to a multiple of ``c``. Returns
    ``(slice_deg, perm)``: ``perm`` is a permutation of
    ``arange(nrows_padded)`` (sorted position -> original row) and
    ``slice_deg`` (>= 1) the per-slice padded width.
    """
    assert c >= 1, c
    n = int(degrees.shape[0])
    nrows_p = max(_round_up(n, c), c)
    d = np.zeros(nrows_p, np.int64)
    d[:n] = degrees
    sig = nrows_p if sigma == 0 else min(_round_up(max(int(sigma), 1), c),
                                         nrows_p)
    perm = np.concatenate([
        lo + np.argsort(-d[lo: lo + sig], kind="stable")
        for lo in range(0, nrows_p, sig)
    ])
    slice_deg = d[perm].reshape(-1, c).max(axis=1)
    return np.maximum(slice_deg, 1), perm


def sell_from_coo(a: COO, c: int = 8, sigma: int = 0) -> SELL:
    """Pack a COO matrix into SELL-C-σ (host-side)."""
    row = _np(a.row)[: a.nse]
    col = _np(a.col)[: a.nse]
    val = _np(a.val)[: a.nse]
    counts = np.bincount(row, minlength=a.nrows) if a.nrows else \
        np.zeros(0, np.int64)
    slice_deg, perm = sell_slice_degrees(counts, c, sigma)
    nslices = slice_deg.shape[0]
    nrows_p = nslices * c
    inv = np.empty(nrows_p, np.int64)
    inv[perm] = np.arange(nrows_p)

    sptr = np.concatenate([[0], np.cumsum(slice_deg)])
    n_steps = int(sptr[-1])
    idx = np.full((n_steps, c), a.ncols, np.int32)
    v = np.zeros((n_steps, c), val.dtype if val.size else np.float32)
    if row.size:
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
        slot = np.arange(len(row)) - np.repeat(np.cumsum(counts) - counts,
                                               counts)
        spos = inv[row]                      # sorted position of each edge's row
        step = sptr[spos // c] + slot        # packed step; slot < slice_deg
        idx[step, spos % c] = col
        v[step, spos % c] = val
    first = np.zeros(n_steps, np.int32)
    first[sptr[:-1]] = 1
    return SELL(idx=_t(idx), val=_t(v),
                slice_of=_t(np.repeat(np.arange(nslices), slice_deg),
                            np.int32),
                first_step=_t(first),
                perm=_t(perm, np.int32),
                inv_perm=_t(inv[: a.nrows], np.int32),
                nrows=a.nrows, ncols=a.ncols, nse=a.nse,
                c=c, sigma=sigma, nslices=nslices)


# --------------------------------------------------------------------------
# Graph-static precomputations (the things iSpLib caches)
# --------------------------------------------------------------------------

def coo_transpose(a: COO) -> COO:
    """Host-side transpose with re-sort — built ONCE and cached (iSpLib
    §3.3); the uncached baseline pays a sort per backward step instead."""
    row = _np(a.row)[: a.nse]
    col = _np(a.col)[: a.nse]
    val = _np(a.val)[: a.nse]
    order = np.lexsort((row, col))
    return coo_from_edges(row[order], col[order], val[order],
                          nrows=a.ncols, ncols=a.nrows,
                          pad_to=a.nnz_padded, dtype=val.dtype)


def row_degrees(a: COO) -> torch.Tensor:
    """``(nrows,)`` fp32 count of the real entries of each row, on the
    device of ``a.row``."""
    return torch.bincount(a.row[: a.nse].long(),
                          minlength=a.nrows).to(torch.float32)


def gcn_normalize(a: COO, add_self_loops: bool = True) -> COO:
    """D^-1/2 (A + I) D^-1/2 — host-side (float64), cached once per graph."""
    row = _np(a.row)[: a.nse]
    col = _np(a.col)[: a.nse]
    val = _np(a.val)[: a.nse].astype(np.float64)
    if add_self_loops:
        eye = np.arange(min(a.nrows, a.ncols))
        row = np.concatenate([row, eye])
        col = np.concatenate([col, eye])
        val = np.concatenate([val, np.ones(len(eye))])
    deg = np.zeros(a.nrows)
    np.add.at(deg, row, val)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    val = dinv[row] * val * dinv[col]
    pad_to = max(a.nnz_padded + (min(a.nrows, a.ncols) if add_self_loops
                                 else 0), len(row))
    return coo_from_edges(col, row, val.astype(np.float32), a.nrows, a.ncols,
                          pad_to=pad_to)
