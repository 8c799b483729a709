"""Block-sparse-row SpMM (sum semiring): the hand-written CUDA kernel and
its plain PyTorch version.

``bsr_spmm_cuda`` launches ``csrc/bsr_spmm.cu``, the Hopper replacement of
the TPU kernel ``bsr_spmm_pallas`` (``src/repro/kernels/bsr_spmm.py``).
The TPU kernel keeps a block row's accumulator resident across its
sequential grid; here one CTA owns a (block row, K tile) pair and walks
the row's blocks itself, the row bounds coming from a ``searchsorted``
over the sorted ``blk_row`` in this wrapper. The work is bound by fp32
operations (2 br bc K per stored tile). ``bsr_spmm_plain`` runs the same
block algorithm with tensor ops (CPU dispatch, tests).

The kernel's tiling is the H100 hardware model's (``bsr_k_tile``,
``bsr_depth``, ``bsr_rows``), so the autotuner charges the shared memory
this kernel holds (:func:`smem_bytes`) without importing it.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import H100
from repro_torch.core.sparse import BSR
from repro_torch.kernels.ell_spmm import check_launch_operands
from repro_torch.kernels.ref import spmm_bsr_ref

__all__ = ["bsr_spmm_cuda", "bsr_spmm_plain", "block_row_pointers",
           "K_TILE", "DEPTH", "TILE_ROWS", "smem_bytes"]

# the kernel's compile-time tiling (csrc/bsr_spmm.cu: kFk, kDepth and the
# br templates): output columns per CTA, tile columns staged per step (bc
# must be a multiple), tile heights built
K_TILE, DEPTH, TILE_ROWS = H100.bsr_k_tile, H100.bsr_depth, H100.bsr_rows
smem_bytes = H100.bsr_smem


def bsr_spmm_plain(a: BSR, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch BSR SpMM: gathered h block rows, batched tile
    products, segment sum into the block rows (padded ``a.nrows`` rows)."""
    return spmm_bsr_ref(a, h)


def block_row_pointers(a: BSR) -> torch.Tensor:
    """``(n_block_rows + 1,)`` int32 block offsets: block row r owns blocks
    ``[ptr[r], ptr[r+1])``. ``blk_row`` is sorted, so this is a binary
    search per block row on its device, without a host sync; padding
    blocks (which replicate the last row) fall inside the last range."""
    bounds = torch.arange(a.n_block_rows + 1, dtype=torch.int32,
                          device=a.blk_row.device)
    return torch.searchsorted(a.blk_row, bounds, out_int32=True)


def bsr_spmm_cuda(a: BSR, h: torch.Tensor) -> torch.Tensor:
    """``(a.nrows, K)`` fp32 = a @ h on the card through the hand kernel.
    ``h`` has at most ``a.ncols`` rows (missing padding rows read as
    zero). Counts its launches in ``bsr_spmm_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    # the tile array may pass 2^31 elements: the kernel's offsets are
    # 64-bit, so it is checked here and not by check_launch_operands
    check_launch_operands("bsr_spmm", h, blk_row=a.blk_row, blk_col=a.blk_col)
    blocks = a.blocks
    if blocks.device != h.device or blocks.dtype != torch.float32 or \
            not blocks.is_contiguous() or blocks.data_ptr() % 16:
        raise ValueError(f"bsr_spmm: blocks must be 16-byte aligned "
                         f"contiguous fp32 on {h.device}, got {blocks.dtype} "
                         f"on {blocks.device}")
    if a.br not in TILE_ROWS or a.bc <= 0 or a.bc % DEPTH:
        raise ValueError(f"bsr_spmm: tile {a.br}x{a.bc} not built (br in "
                         f"{TILE_ROWS}, bc a multiple of {DEPTH})")
    if tuple(blocks.shape) != (a.nblocks, a.br, a.bc) or \
            tuple(a.blk_col.shape) != (a.nblocks,) or \
            a.nrows % a.br or a.ncols % a.bc:
        raise ValueError(f"bsr_spmm: inconsistent BSR shapes: blocks "
                         f"{tuple(blocks.shape)}, blk_col "
                         f"{tuple(a.blk_col.shape)}, nrows={a.nrows}, "
                         f"ncols={a.ncols}, tile {a.br}x{a.bc}")
    if h.shape[0] > a.ncols:
        raise ValueError(f"bsr_spmm: h has {h.shape[0]} rows, "
                         f"a has {a.ncols} columns")
    k = h.shape[1]
    out = torch.empty((a.nrows, k), dtype=torch.float32, device=h.device)
    if a.nrows == 0 or k == 0:
        return out.zero_()
    ptr = block_row_pointers(a)
    lib = load_kernel("bsr_spmm")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.bsr_spmm_f32(ptr.data_ptr(), a.blk_col.data_ptr(),
                              blocks.data_ptr(), h.data_ptr(), out.data_ptr(),
                              a.n_block_rows, a.br, a.bc, h.shape[0], k,
                              stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm launch failed: CUDA error {rc}")
    bsr_spmm_cuda.launches += 1
    return out


bsr_spmm_cuda.launches = 0
