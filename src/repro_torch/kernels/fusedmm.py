"""FusedMM over BSR tiles (SDDMM -> edge op -> SpMM, paper §3.4): the
hand-written CUDA kernel and its plain PyTorch version.

``fusedmm_bsr_cuda`` launches ``csrc/fusedmm.cu``, the Hopper replacement
of the TPU kernel ``fusedmm_bsr_pallas`` (``src/repro/kernels/
fusedmm.py``): ``out[i] = Σ_j f(x_i·y_j) h_j`` over A's stored tiles,
masked by the tile's nonzero entries, with f an online row softmax,
a sigmoid or none; only ``out`` reaches device memory. One CTA owns 32
rows of a block row and walks its tiles in order; a warp owns four rows,
whose running max, denominator and accumulator stay in its registers.
Each tile is streamed once, and each 32-row slice of it takes one of two
routes, chosen per tile from its nonzero count (``fused_tile_route``):
``edge`` (at most 1 / ``FUSED_DENSE_DIV`` of the slice nonzero) computes
``x_i·y_j`` and adds ``p h_j`` for every stored nonzero, the warp that
owns the row taking its nonzeros ``fused_batch`` at a time with y_j and
h_j read from L2, bound by the bytes of the tiles and of those rows;
``tile`` takes the dense tile products (2 br bc (D + K) flops a tile)
within the same launch. The kernel writes each CTA's tile count of each
route; the wrapper adds them up on the card. One launch covers up to 512
columns of h; a wider h takes one launch per 512 columns (each
recomputes the scores).

``fusedmm_bsr_plain`` computes the same function with tensor ops in
chunks of tiles: the two-pass softmax of ``kernels/ref.py`` and, for
sigmoid and none, the masked tile products summed into the block rows
(the reference's XLA path).
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import BSR
from repro_torch.kernels.ref import (_block_rows, bsr_tile_chunks,
                                     fusedmm_softmax_ref)
from repro_torch.kernels.sddmm import (DEPTH_STEP, SLICE_ROWS, SMEM_LIMIT,
                                       Y_STRIDE, check_score_operands,
                                       check_tile_operands)

__all__ = ["fusedmm_bsr_cuda", "fusedmm_bsr_plain", "EDGE_OPS", "K_CHUNK",
           "FUSED_DENSE_DIV", "ROUTES", "fused_tile_route", "fused_batch",
           "smem_bytes", "tiles_by_route"]

EDGE_OPS = ("softmax", "sigmoid", "none")   # the kernel's edge_op codes
K_CHUNK = 512            # columns of h one launch covers (NQ <= 4 groups)
_H_ROWS_STAGED = 32      # csrc/fusedmm.cu kJc
_STATIC_SMEM = 64        # csrc/fusedmm.cu: the warps' nonzero counts
# csrc/fusedmm.cu's kDenseDiv: a 32-row slice of a tile with more than
# 1 / FUSED_DENSE_DIV of its positions nonzero takes the tile route
FUSED_DENSE_DIV = 8
ROUTES = ("edge", "tile")


def fused_tile_route(nnz: int, bc: int) -> str:
    """The route of one 32-row slice of a ``bc``-wide tile holding ``nnz``
    nonzeros, as the kernel decides it: ``tile`` above 1 /
    ``FUSED_DENSE_DIV`` of its positions, else ``edge``."""
    return "tile" if nnz * FUSED_DENSE_DIV > SLICE_ROWS * bc else "edge"


def fused_batch(kw: int) -> int:
    """Edge-route entries a warp applies at once in a launch over ``kw``
    columns of h (csrc/fusedmm.cu ``batch<NQ>()``): fewer for wide h,
    whose rows take more registers in flight."""
    return 4 if -(-kw // 128) <= 2 else 2


def smem_bytes(bc: int, d: int, kw: int) -> int:
    """Dynamic shared memory of one launch over ``kw`` columns: the
    slice's x rows (D rounded up to the depth step), the transposed weight
    tile (bc rows of 36 floats) and one buffer that holds either a depth
    step of the tile's y rows or 32 staged h rows (kw rounded up to 128),
    both for the tile route. The warps' nonzero counts take
    ``_STATIC_SMEM`` bytes beside it."""
    dp = -(-d // DEPTH_STEP) * DEPTH_STEP
    kwp = -(-kw // 128) * 128
    return 4 * (SLICE_ROWS * dp + bc * (SLICE_ROWS + 4) +
                max(bc * Y_STRIDE, _H_ROWS_STAGED * kwp))


def tiles_by_route() -> dict[str, int]:
    """Tiles (32-row slices of a tile, summed over every K launch) each
    route took in the fused launches since the last reset: reads the
    card's running count (a host sync)."""
    got = fusedmm_bsr_cuda.route_tiles
    if got is None:
        return dict.fromkeys(ROUTES, 0)
    return dict(zip(ROUTES, (int(v) for v in got.cpu())))


def fusedmm_bsr_plain(a: BSR, x: torch.Tensor, y: torch.Tensor,
                      h: torch.Tensor, *, edge_op: str = "softmax"
                      ) -> torch.Tensor:
    """Plain PyTorch FusedMM over BSR tiles, ``(a.nrows, K)`` fp32."""
    if edge_op not in EDGE_OPS:
        raise ValueError(f"edge_op {edge_op!r} not in {EDGE_OPS}")
    if edge_op == "softmax":
        return fusedmm_softmax_ref(a, x, y, h)
    k = h.shape[1]
    hb = _block_rows(h, a.ncols, a.bc)
    out = torch.zeros((a.n_block_rows, a.br, k), dtype=torch.float32,
                      device=h.device)
    for lo, hi, s in bsr_tile_chunks(a, x, y, k):
        w = torch.sigmoid(s) if edge_op == "sigmoid" else s
        w = torch.where(a.blocks[lo:hi] != 0, w, 0.0)
        out.index_add_(0, a.blk_row[lo:hi].long(),
                       torch.bmm(w, hb[a.blk_col[lo:hi].long()]))
    return out.reshape(a.nrows, k)


def fusedmm_bsr_cuda(a: BSR, x: torch.Tensor, y: torch.Tensor,
                     h: torch.Tensor, *, edge_op: str = "softmax"
                     ) -> torch.Tensor:
    """``(a.nrows, K)`` fp32 on the card through the hand kernel. ``x``
    has at most ``a.nrows`` rows, ``y`` and ``h`` at most ``a.ncols``
    (missing rows read as zero); D and K are any widths. Counts its
    launches in ``fusedmm_bsr_cuda.launches`` (one per 512 columns of
    h; all of the per-edge kernel, ``launches_by_instance["edge"]``) and
    adds each launch's tiles by route to ``fusedmm_bsr_cuda.route_tiles``
    on the card (``tiles_by_route`` reads it). A build or launch failure
    raises."""
    from repro_torch.kernels.build import load_kernel
    from repro_torch.kernels.bsr_spmm import block_row_pointers

    if edge_op not in EDGE_OPS:
        raise ValueError(f"edge_op {edge_op!r} not in {EDGE_OPS}")
    check_tile_operands("fusedmm_bsr", a, x, y, h)
    check_score_operands("fusedmm_bsr", a, x, y)
    if h.shape[0] > a.ncols:
        raise ValueError(f"fusedmm_bsr: h has {h.shape[0]} rows, a has "
                         f"{a.ncols} columns")
    if a.blocks.data_ptr() % 16:
        raise ValueError("fusedmm_bsr: blocks must be 16-byte aligned (the "
                         "kernel reads whole 16-byte vectors)")
    d, k = x.shape[1], h.shape[1]
    smem = smem_bytes(a.bc, d, min(k, K_CHUNK)) + _STATIC_SMEM
    if smem > SMEM_LIMIT:
        raise ValueError(f"fusedmm_bsr: D = {d}, K = {k} at bc = {a.bc} "
                         f"need {smem} bytes of shared memory, more than a "
                         f"block's {SMEM_LIMIT}")
    out = torch.empty((a.nrows, k), dtype=torch.float32, device=h.device)
    if a.nrows == 0 or k == 0:
        return out.zero_()
    ptr = block_row_pointers(a)
    ctas = a.n_block_rows * (a.br // SLICE_ROWS)
    tally = torch.empty((ctas, 2), dtype=torch.int32, device=h.device)
    lib = load_kernel("fusedmm")
    op = EDGE_OPS.index(edge_op)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        for k0 in range(0, k, K_CHUNK):
            kw = min(K_CHUNK, k - k0)
            rc = lib.fusedmm_f32(
                ptr.data_ptr(), a.blk_col.data_ptr(), a.blocks.data_ptr(),
                x.data_ptr(), y.data_ptr(), h.data_ptr() + 4 * k0,
                out.data_ptr() + 4 * k0, tally.data_ptr(), a.n_block_rows,
                a.br, a.bc, x.shape[0], y.shape[0], d, h.shape[0], k, kw, k,
                op, stream)
            if rc != 0:
                raise RuntimeError(f"fusedmm_bsr launch failed: CUDA error "
                                   f"{rc}")
            fusedmm_bsr_cuda.launches += 1
            fusedmm_bsr_cuda.launches_by_instance["edge"] += 1
            tiles = tally.sum(0, dtype=torch.int64)
            if fusedmm_bsr_cuda.route_tiles is None:
                fusedmm_bsr_cuda.route_tiles = tiles
            else:
                fusedmm_bsr_cuda.route_tiles += tiles
    return out


fusedmm_bsr_cuda.launches = 0
fusedmm_bsr_cuda.launches_by_instance = {"edge": 0}
fusedmm_bsr_cuda.route_tiles = None     # (edge, tile) int64 on the card
