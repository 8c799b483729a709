"""Block SDDMM over BSR tiles: the hand-written CUDA kernel and its plain
PyTorch version.

``sddmm_bsr_cuda`` launches ``csrc/sddmm.cu``, the Hopper replacement of
the TPU kernel ``sddmm_bsr_pallas`` (``src/repro/kernels/sddmm.py``):
per stored tile ``X[row blk] @ Y[col blk]^T``, optionally times the tile,
as ``(nblocks, br, bc)``. A CTA owns 32 rows of a block row's tiles and
keeps their x rows in shared memory. Two instances, chosen by
``scale_by_a`` alone: ``tile`` (unscaled: every position's score, bound
by fp32 operations, 2 br bc D per tile; a CTA walks a block row) and
``nnz`` (scaled by A: each tile streamed once and one dot product per
stored nonzero, bound by the bytes of A's tiles and the output; a CTA
walks a chunk of consecutive tiles, and a slice denser than
1 / ``DENSE_DIV`` takes the tile products within the same launch).
``sddmm_bsr_plain`` computes the same function with batched tile
products in chunks of tiles (CPU dispatch, tests).

The score routine (``csrc/tile_scores.cuh``) is shared with the fused
kernel of :mod:`repro_torch.kernels.fusedmm`, and so are the operand
checks here.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import BSR
from repro_torch.kernels.ref import sddmm_bsr_ref

__all__ = ["sddmm_bsr_cuda", "sddmm_bsr_plain", "TILE_COLS", "SLICE_ROWS",
           "DEPTH_STEP", "Y_STRIDE", "DENSE_DIV", "SMEM_LIMIT",
           "score_smem_bytes", "nnz_smem_bytes", "check_tile_operands",
           "check_score_operands"]

# the kernels' compile-time tiling (csrc/tile_scores.cuh): rows per CTA
# (br must be a multiple), tile widths built (those the tuner's candidates
# hold), depth step, Ys row stride
SLICE_ROWS, TILE_COLS, DEPTH_STEP, Y_STRIDE = 32, (128, 256), 32, 36
# csrc/sddmm.cu's kDenseDiv: a 32-row slice of a tile with more than
# 1 / DENSE_DIV of its positions nonzero takes the dense tile products in
# the scaled kernel
DENSE_DIV = 5
SMEM_LIMIT = 232_448     # dynamic shared memory one Hopper block may hold
_INT_MAX = 2 ** 31 - 1


def score_smem_bytes(bc: int, d: int) -> int:
    """Shared memory of the score routine: the slice's x rows at D
    rounded up to the depth step, and one depth step of the tile's y
    rows."""
    dp = -(-d // DEPTH_STEP) * DEPTH_STEP
    return 4 * (SLICE_ROWS * dp + bc * Y_STRIDE)


def nnz_smem_bytes(bc: int, d: int) -> int:
    """Shared memory of the scaled kernel: the score routine's, and the
    list of a sparse slice's nonzeros (position, value and result, 12
    bytes each, at most 1 / DENSE_DIV of the slice)."""
    return score_smem_bytes(bc, d) + 12 * (SLICE_ROWS * bc // DENSE_DIV)


def check_tile_operands(name: str, a: BSR, *mats: torch.Tensor) -> None:
    """Raise unless ``a``'s index tables are contiguous int32 and its
    tiles contiguous fp32 on the device of ``mats`` (contiguous fp32
    CUDA matrices whose rows fit int32), with a tile shape the kernels
    are built for and consistent shapes."""
    dev = mats[0].device
    for t in mats:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must be CUDA tensors on one "
                             f"device, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: dense operands must be contiguous "
                             f"fp32 matrices, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.shape[0] > _INT_MAX or t.shape[1] > _INT_MAX:
            raise ValueError(f"{name}: a dense operand exceeds int32 rows")
    for key in ("blk_row", "blk_col"):
        t = getattr(a, key)
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous int32 on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if a.blocks.device != dev or a.blocks.dtype != torch.float32 or \
            not a.blocks.is_contiguous():
        raise ValueError(f"{name}: blocks must be contiguous fp32 on {dev}, "
                         f"got {a.blocks.dtype} on {a.blocks.device}")
    if a.br <= 0 or a.br % SLICE_ROWS or a.bc not in TILE_COLS:
        raise ValueError(f"{name}: tile {a.br}x{a.bc} not built (br a "
                         f"multiple of {SLICE_ROWS}, bc in {TILE_COLS})")
    if tuple(a.blocks.shape) != (a.nblocks, a.br, a.bc) or \
            tuple(a.blk_col.shape) != (a.nblocks,) or \
            tuple(a.blk_row.shape) != (a.nblocks,) or \
            a.nrows % a.br or a.ncols % a.bc:
        raise ValueError(f"{name}: inconsistent BSR shapes: blocks "
                         f"{tuple(a.blocks.shape)}, blk_col "
                         f"{tuple(a.blk_col.shape)}, nrows={a.nrows}, "
                         f"ncols={a.ncols}, tile {a.br}x{a.bc}")
    if a.n_block_rows * (a.br // SLICE_ROWS) > _INT_MAX:
        raise ValueError(f"{name}: {a.n_block_rows} block rows exceed the "
                         f"grid")


def check_score_operands(name: str, a: BSR, x: torch.Tensor,
                         y: torch.Tensor) -> None:
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"{name}: x and y widths differ: {x.shape[1]} vs "
                         f"{y.shape[1]}")
    if x.shape[0] > a.nrows or y.shape[0] > a.ncols:
        raise ValueError(f"{name}: x has {x.shape[0]} rows and y "
                         f"{y.shape[0]}, a is {a.nrows} x {a.ncols}")


def sddmm_bsr_plain(a: BSR, x: torch.Tensor, y: torch.Tensor, *,
                    scale_by_a: bool = True) -> torch.Tensor:
    """Plain PyTorch block SDDMM (batched tile products in chunks)."""
    return sddmm_bsr_ref(a, x, y, scale_by_a=scale_by_a)


def sddmm_bsr_cuda(a: BSR, x: torch.Tensor, y: torch.Tensor, *,
                   scale_by_a: bool = True) -> torch.Tensor:
    """``(a.nblocks, br, bc)`` fp32 block scores on the card through the
    hand kernel. ``x`` has at most ``a.nrows`` rows and ``y`` at most
    ``a.ncols`` (missing rows read as zero), any equal width D. Counts its
    launches in ``sddmm_bsr_cuda.launches`` and, by instance (``nnz``
    when ``scale_by_a``, else ``tile``), in
    ``sddmm_bsr_cuda.launches_by_instance``.

    With ``scale_by_a`` the kernel writes 0 wherever A's entry is 0
    (+0 or -0) without computing the score there, so where ``a = 0`` and
    ``x_i · y_j`` is not finite it writes 0 where the plain version writes
    ``s * 0`` = NaN. On finite inputs the two agree within
    2 (D + 1) eps Σ_d |x_i,d y_j,d| |a_ij| (two fp32 sums of the same
    products in other orders, and the product with A)."""
    from repro_torch.kernels.build import load_kernel
    from repro_torch.kernels.bsr_spmm import block_row_pointers

    check_tile_operands("sddmm_bsr", a, x, y)
    check_score_operands("sddmm_bsr", a, x, y)
    d = x.shape[1]
    smem = (nnz_smem_bytes if scale_by_a else score_smem_bytes)(a.bc, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"sddmm_bsr: D = {d} needs {smem} bytes of shared "
                         f"memory, more than a block's {SMEM_LIMIT}")
    if scale_by_a and a.blocks.data_ptr() % 16:
        raise ValueError("sddmm_bsr: blocks must be 16-byte aligned (the "
                         "scaled kernel reads whole 16-byte vectors)")
    out = torch.empty((a.nblocks, a.br, a.bc), dtype=torch.float32,
                      device=x.device)
    if a.nblocks == 0:
        return out
    # the unscaled kernel walks block rows, the scaled one chunks of tiles
    ptr = None if scale_by_a else block_row_pointers(a)
    lib = load_kernel("sddmm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sddmm_f32(None if ptr is None else ptr.data_ptr(),
                           a.blk_row.data_ptr(), a.blk_col.data_ptr(),
                           a.blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
                           out.data_ptr(), a.n_block_rows, a.nblocks, a.br,
                           a.bc, x.shape[0], y.shape[0], d, int(scale_by_a),
                           stream)
    if rc != 0:
        raise RuntimeError(f"sddmm_bsr launch failed: CUDA error {rc}")
    sddmm_bsr_cuda.launches += 1
    sddmm_bsr_cuda.launches_by_instance["nnz" if scale_by_a else "tile"] += 1
    return out


sddmm_bsr_cuda.launches = 0
sddmm_bsr_cuda.launches_by_instance = {"nnz": 0, "tile": 0}
