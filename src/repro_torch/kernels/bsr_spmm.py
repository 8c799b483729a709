"""Block-sparse-row SpMM (sum semiring): the hand-written CUDA kernel and
its plain PyTorch version.

``bsr_spmm_cuda`` launches ``csrc/bsr_spmm.cu``, the Hopper replacement of
the TPU kernel ``bsr_spmm_pallas`` (``src/repro/kernels/bsr_spmm.py``).
The TPU kernel keeps a block row's accumulator resident across its
sequential grid; here a CTA owns a chunk of one block row's tiles and a
K tile, and walks them itself, the row bounds coming from a
``searchsorted`` over the sorted ``blk_row`` in this wrapper. Tile
products run on the tensor cores in split TF32 (three TF32 ``wgmma``
passes, fp32-accurate to a few ulps) on operands that TMA stages in a
ring of shared memory; a pre-pass (:func:`transpose_h_cuda`) writes hᵀ,
the K-major B operand TF32 ``wgmma`` needs, and the kernel splits each
staged piece of it into TF32 hi and lo parts on chip. Rows cut
into several chunks are summed in chunk order by a second pass: no
atomics, so the result is deterministic. ``bsr_spmm_plain`` runs the
same block algorithm with tensor ops (CPU dispatch, tests).

The kernel's tiling is the H100 hardware model's (``bsr_k_tile``,
``bsr_depth``, ``bsr_rows``), so the autotuner charges the shared memory
this kernel holds (:func:`smem_bytes`) without importing it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.autotune import H100
from repro_torch.core.sparse import BSR
from repro_torch.kernels.ell_spmm import check_launch_operands
from repro_torch.kernels.ref import spmm_bsr_ref

__all__ = ["bsr_spmm_cuda", "bsr_spmm_plain", "block_row_pointers",
           "transpose_h_cuda", "k_tile", "chunk_tiles", "K_TILE", "DEPTH",
           "TILE_ROWS", "smem_bytes", "CTAS_PER_SM", "split_tf32_bound"]

# the kernel's compile-time tiling (csrc/bsr_spmm.cu): the widest K tile
# (64 is built too), tile columns staged per step (bc must be a multiple),
# tile heights built
K_TILE, DEPTH, TILE_ROWS = H100.bsr_k_tile, H100.bsr_depth, H100.bsr_rows
smem_bytes = H100.bsr_smem
CTAS_PER_SM = 16          # chunks of a block row's tiles: ~16 CTAs an SM


def split_tf32_bound(d, mag):
    """Bound of |kernel - fp32 sum| for an output element whose row has
    ``d`` real terms (nonzero tile entries) and ``mag`` = Σ_j |a_ij h_j|,
    in units of u = 2^-24 (one fp32 rounding): ``(13 + 8 d) u mag``.

    - Split: x_hi = rna_tf32(x) is within 2^-11 |x| of x, and x_lo =
      rna_tf32(x - x_hi) within 2^-11 |x - x_hi| <= 2^-22 |x| of the
      rest. The three kept products miss a_lo b_lo and the two lo
      roundings (times a_hi, b_hi): 3 * 2^-22 (1 + 2^-10) |a b| at most,
      under 13 u |a b|. A TF32 x TF32 product (22 significant bits) is
      exact in fp32.
    - Accumulation: the tensor cores add the 3 d products in fp32 and may
      truncate instead of rounding to nearest: 2 u of the running
      magnitude an addition, 6 d u mag.
    - The plain version's fp32 sum of the same d terms: 2 d u mag (the
      fp32 kernels' check allows 2 d u mag for both sums together)."""
    return (13 + 8 * d) * 2.0 ** -24 * mag


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


def k_tile(k: int) -> int:
    """The K tile the kernel takes for K output columns: 64 when that
    covers K, else 128 (wider K runs one CTA a K tile, neighbours in the
    grid, so the second read of a tile comes from L2)."""
    return 64 if k <= 64 else K_TILE


def chunk_tiles(nblocks: int, ctas_per_chunk: int, n_sm: int) -> int:
    """Tiles a CTA walks: the tile walks (``nblocks`` times the CTAs of a
    chunk, one per 128-row half and K tile) spread over about
    ``CTAS_PER_SM`` CTAs an SM, so no long block row makes the tail."""
    return max(1, -(-nblocks * ctas_per_chunk // (CTAS_PER_SM * n_sm)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def transpose_h_cuda(h: torch.Tensor) -> torch.Tensor:
    """The pre-pass: hᵀ in chunks of 32 nodes, a ``(ld / 32, K, 32)`` fp32
    array, ``ld`` = h's rows rounded up to 32, zero past them (the K-major
    B operand of the TF32 ``wgmma``, a chunk's features one contiguous
    read). Not counted as a launch of its own: it is part of every
    ``bsr_spmm_cuda`` call."""
    from repro_torch.kernels.build import load_kernel
    n, k = h.shape
    ld = -(-n // DEPTH) * DEPTH
    h_t = torch.empty((ld // DEPTH, k, DEPTH), dtype=torch.float32,
                      device=h.device)
    lib = load_kernel("bsr_spmm")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.bsr_transpose_h_f32(h.data_ptr(), h_t.data_ptr(), n, k, ld,
                                     stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm pre-pass failed: CUDA error {rc}")
    return h_t


def bsr_spmm_cuda(a: BSR, h: torch.Tensor) -> torch.Tensor:
    """``(a.nrows, K)`` fp32 = a @ h on the card through the hand kernel.
    ``h`` has at most ``a.ncols`` rows (missing padding rows read as
    zero). Counts its launches in ``bsr_spmm_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    # the tile array may pass 2^31 elements: TMA addresses it, so it is
    # checked here and not by check_launch_operands
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
    if a.nrows == 0 or k == 0 or a.nblocks == 0 or h.shape[0] == 0:
        return out.zero_()
    fk = k_tile(k)
    ctas_per_chunk = max(a.br // 128, 1) * -(-k // fk)
    chunk = chunk_tiles(a.nblocks, ctas_per_chunk,
                        _sm_count(h.device.index or 0))
    ptr = block_row_pointers(a)
    n_chunks = torch.clamp((ptr[1:] - ptr[:-1] + chunk - 1) // chunk, min=1)
    chunk_ptr = torch.zeros(a.n_block_rows + 1, dtype=torch.int32,
                            device=h.device)
    chunk_ptr[1:] = torch.cumsum(n_chunks, 0, dtype=torch.int32)
    # an upper bound of the chunks: sum ceil(len / chunk) <= rows + n / chunk
    grid_items = a.n_block_rows + a.nblocks // chunk
    ws = torch.empty((grid_items, a.br, k), dtype=torch.float32,
                     device=h.device)
    h_t = transpose_h_cuda(h)
    lib = load_kernel("bsr_spmm")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.bsr_spmm_f32(ptr.data_ptr(), chunk_ptr.data_ptr(),
                              a.blk_col.data_ptr(), blocks.data_ptr(),
                              h_t.data_ptr(), out.data_ptr(), ws.data_ptr(),
                              a.n_block_rows, grid_items, a.nblocks, a.br,
                              a.bc, h_t.shape[0] * DEPTH, k, fk, chunk,
                              stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm launch failed: CUDA error {rc}")
    bsr_spmm_cuda.launches += 1
    return out


bsr_spmm_cuda.launches = 0
