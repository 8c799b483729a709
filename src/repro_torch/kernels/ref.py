"""Plain PyTorch references for the SpMM kernels of this package.

These are the ground truth of the tests, the trusted path for any
(semiring, plan) point the hand kernels do not cover, and what the
dispatchers in :mod:`repro_torch.kernels.ops` run for tensors on the CPU.
Every gather is zero-filled for the ``idx == ncols`` sentinel.

The gathered message tensors are built in chunks (of edges, ELL rows,
SELL steps or BSR blocks) so that a full-neighbor block around a hub, or
a whole graph's tiles, never needs the whole ``(edges, K)`` or
``(nblocks, br, K)`` tensor at once.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:  # annotation-only
    from repro_torch.core.semiring import Semiring
    from repro_torch.core.sparse import BSR, COO, ELL, SELL

__all__ = ["coo_reduce", "spmm_coo_ref", "spmm_ell_ref", "spmm_sell_ref",
           "spmm_bsr_ref", "sell_packed_reduce", "take_rows",
           "ell_transpose_reduce", "sell_transpose_reduce"]

# gathered elements per chunk (fp32: 256 MiB of messages at a time)
_CHUNK_ELEMS = 1 << 26


def take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` with out-of-range ids (the sentinel) reading zero rows."""
    n = h.shape[0]
    valid = (idx >= 0) & (idx < n)
    if n == 0:
        return h.new_zeros(tuple(idx.shape) + tuple(h.shape[1:]))
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    out = h[safe]
    mask = valid.view(*valid.shape, *([1] * (h.dim() - 1)))
    return torch.where(mask, out, torch.zeros((), dtype=h.dtype,
                                              device=h.device))


def _rows_per_chunk(width: int, k: int) -> int:
    return max(1, _CHUNK_ELEMS // max(width * max(k, 1), 1))


def coo_reduce(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               n_valid: int, nrows: int, h: torch.Tensor, sr: "Semiring",
               degrees=None) -> torch.Tensor:
    """out[i] = ⊕_{e < n_valid, row[e] = i} val[e] ⊗ h[col[e]] — the
    trusted segment path over triplets, in chunks of edges (entries from
    ``n_valid`` on are padding and take no part)."""
    k = h.shape[1]
    out = torch.full((nrows, k), sr.identity,
                     dtype=torch.promote_types(val.dtype, h.dtype),
                     device=h.device)
    step = _rows_per_chunk(1, k)
    for lo in range(0, n_valid, step):
        hi = min(lo + step, n_valid)
        msgs = sr.apply_combine(val[lo:hi, None], take_rows(h, col[lo:hi]))
        out = sr.reduce_into(out, msgs.to(out.dtype), row[lo:hi])
    return sr.finalize(out, degrees)


def spmm_coo_ref(a: "COO", h: torch.Tensor, sr: "Semiring",
                 degrees=None) -> torch.Tensor:
    """out[i] = ⊕_{(i,j) in A} A_ij ⊗ h[j] — the trusted segment path."""
    return coo_reduce(a.row, a.col, a.val, a.nse, a.nrows, h, sr, degrees)


def spmm_ell_ref(a: "ELL", h: torch.Tensor, sr: "Semiring",
                 degrees=None) -> torch.Tensor:
    k = h.shape[1]
    parts = []
    step = _rows_per_chunk(a.max_deg, k)
    for lo in range(0, a.nrows, step):
        idx, val = a.idx[lo: lo + step], a.val[lo: lo + step]
        msg = sr.apply_combine(val[:, :, None], take_rows(h, idx))
        valid = (idx < a.ncols)[:, :, None]
        if sr.reduce in ("sum", "mean"):
            parts.append(torch.where(valid, msg, 0.0).sum(dim=1))
        elif sr.reduce == "max":
            parts.append(torch.where(valid, msg, -torch.inf).amax(dim=1))
        else:
            parts.append(torch.where(valid, msg, torch.inf).amin(dim=1))
    out = torch.cat(parts) if parts else h.new_zeros((0, k))
    return sr.finalize(out, degrees)


def sell_packed_reduce(idx: torch.Tensor, val: torch.Tensor,
                       slice_of: torch.Tensor, nslices: int,
                       inv_perm: torch.Tensor, h: torch.Tensor
                       ) -> torch.Tensor:
    """The packed-slice SELL reduction on raw tensors: gather the
    ``(n_steps, C)`` neighbor table, segment-sum the steps into their
    slices' ``(C, K)`` accumulators, inverse-permute rows. Sentinel slots
    gather 0 and carry val == 0."""
    c, k = idx.shape[1], h.shape[1]
    acc = h.new_zeros((nslices, c, k), dtype=torch.float32)
    step = _rows_per_chunk(c, k)
    for lo in range(0, idx.shape[0], step):
        g = take_rows(h, idx[lo: lo + step]).float()
        msgs = val[lo: lo + step, :, None].float() * g
        acc.index_add_(0, slice_of[lo: lo + step].long(), msgs)
    return acc.reshape(nslices * c, k)[inv_perm.long()]


def spmm_sell_ref(a: "SELL", h: torch.Tensor) -> torch.Tensor:
    """Sum-semiring SELL-C-σ SpMM in fp32, rows in original order."""
    return sell_packed_reduce(a.idx, a.val, a.slice_of, a.nslices,
                              a.inv_perm, h)


def ell_transpose_reduce(a: "ELL", dout: torch.Tensor) -> torch.Tensor:
    """``Aᵀ @ dout`` for an ELL operand (the gradient of the sum-semiring
    ELL SpMM in ``h``): ``dh[idx[r, d]] += val[r, d] * dout[r]``, with
    ``index_add_`` in chunks of rows; sentinel slots land on a spare row
    that is dropped."""
    k = dout.shape[1]
    dh = dout.new_zeros((a.ncols + 1, k), dtype=torch.float32)
    step = _rows_per_chunk(a.max_deg, k)
    for lo in range(0, a.nrows, step):
        idx = a.idx[lo: lo + step].long().clamp(0, a.ncols)
        msg = a.val[lo: lo + step, :, None].float() * \
            dout[lo: lo + step, None, :].float()
        dh.index_add_(0, idx.reshape(-1), msg.reshape(-1, k))
    return dh[: a.ncols]


def sell_transpose_reduce(a: "SELL", dout: torch.Tensor) -> torch.Tensor:
    """``Aᵀ @ dout`` for a SELL operand: ``dout`` (original row order) is
    moved to the packed positions, then every packed step scatters
    ``val * dout_packed[slice, lane]`` into ``dh[idx]`` in chunks of
    steps; sentinel slots land on a spare row that is dropped."""
    k = dout.shape[1]
    packed = dout.new_zeros((a.nslices * a.c, k), dtype=torch.float32)
    packed[a.inv_perm.long()] = dout.float()
    packed = packed.view(a.nslices, a.c, k)
    dh = dout.new_zeros((a.ncols + 1, k), dtype=torch.float32)
    step = _rows_per_chunk(a.c, k)
    for lo in range(0, a.n_steps, step):
        g = packed[a.slice_of[lo: lo + step].long()] * \
            a.val[lo: lo + step, :, None].float()
        idx = a.idx[lo: lo + step].long().clamp(0, a.ncols)
        dh.index_add_(0, idx.reshape(-1), g.reshape(-1, k))
    return dh[: a.ncols]


def spmm_bsr_ref(a: "BSR", h: torch.Tensor) -> torch.Tensor:
    """Sum-semiring BSR SpMM in fp32 with the tiled kernel's block
    algorithm: gather h's block rows, a batched tile product, a segment sum
    into the block rows — in chunks of blocks, so ``(nblocks, br, K)``
    never exists at once. ``h`` may have fewer than ``a.ncols`` rows (the
    rest read as zero); the output has the padded ``a.nrows`` rows."""
    k = h.shape[1]
    h = h.float()
    if h.shape[0] < a.ncols:
        h = torch.cat([h, h.new_zeros((a.ncols - h.shape[0], k))])
    hb = h.view(a.ncols // a.bc, a.bc, k)
    out = h.new_zeros((a.n_block_rows, a.br, k))
    step = _rows_per_chunk(max(a.br, a.bc), k)
    for lo in range(0, a.nblocks, step):
        contrib = torch.bmm(a.blocks[lo: lo + step].float(),
                            hb[a.blk_col[lo: lo + step].long()])
        out.index_add_(0, a.blk_row[lo: lo + step].long(), contrib)
    return out.reshape(a.nrows, k)
