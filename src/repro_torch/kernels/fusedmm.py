"""FusedMM over BSR tiles (SDDMM -> edge op -> SpMM, paper §3.4): the
hand-written CUDA kernel and its plain PyTorch version.

``fusedmm_bsr_cuda`` launches ``csrc/fusedmm.cu``, the Hopper replacement
of the TPU kernel ``fusedmm_bsr_pallas`` (``src/repro/kernels/
fusedmm.py``): ``out[i] = Σ_j f(x_i·y_j) h_j`` over A's stored tiles,
masked by the tile's nonzero entries, with f an online row softmax,
a sigmoid or none; only ``out`` reaches device memory. One CTA owns 32
rows of a block row and walks its tiles in order, running max,
denominator and accumulator in registers; the work is bound by fp32
operations (2 br bc (D + K) per tile, whatever the tile's fill). One
launch covers up to 512 columns of h; a wider h takes one launch per 512
columns (each recomputes the scores).

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
           "smem_bytes"]

EDGE_OPS = ("softmax", "sigmoid", "none")   # the kernel's edge_op codes
K_CHUNK = 512            # columns of h one launch covers (NQ <= 4 groups)
_H_ROWS_STAGED = 32      # csrc/fusedmm.cu kJc


def smem_bytes(bc: int, d: int, kw: int) -> int:
    """Shared memory of one launch over ``kw`` columns: the slice's x rows
    (D rounded up to the depth step), the transposed weight tile (bc rows
    of 36 floats) and one buffer that holds either a depth step of the
    tile's y rows or 32 staged h rows (kw rounded up to 128)."""
    dp = -(-d // DEPTH_STEP) * DEPTH_STEP
    kwp = -(-kw // 128) * 128
    return 4 * (SLICE_ROWS * dp + bc * (SLICE_ROWS + 4) +
                max(bc * Y_STRIDE, _H_ROWS_STAGED * kwp))


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
    h)."""
    from repro_torch.kernels.build import load_kernel
    from repro_torch.kernels.bsr_spmm import block_row_pointers

    if edge_op not in EDGE_OPS:
        raise ValueError(f"edge_op {edge_op!r} not in {EDGE_OPS}")
    check_tile_operands("fusedmm_bsr", a, x, y, h)
    check_score_operands("fusedmm_bsr", a, x, y)
    if h.shape[0] > a.ncols:
        raise ValueError(f"fusedmm_bsr: h has {h.shape[0]} rows, a has "
                         f"{a.ncols} columns")
    d, k = x.shape[1], h.shape[1]
    smem = smem_bytes(a.bc, d, min(k, K_CHUNK))
    if smem > SMEM_LIMIT:
        raise ValueError(f"fusedmm_bsr: D = {d}, K = {k} at bc = {a.bc} "
                         f"need {smem} bytes of shared memory, more than a "
                         f"block's {SMEM_LIMIT}")
    out = torch.empty((a.nrows, k), dtype=torch.float32, device=h.device)
    if a.nrows == 0 or k == 0:
        return out.zero_()
    ptr = block_row_pointers(a)
    lib = load_kernel("fusedmm")
    op = EDGE_OPS.index(edge_op)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        for k0 in range(0, k, K_CHUNK):
            kw = min(K_CHUNK, k - k0)
            rc = lib.fusedmm_f32(
                ptr.data_ptr(), a.blk_col.data_ptr(), a.blocks.data_ptr(),
                x.data_ptr(), y.data_ptr(), h.data_ptr() + 4 * k0,
                out.data_ptr() + 4 * k0, a.n_block_rows, a.br, a.bc,
                x.shape[0], y.shape[0], d, h.shape[0], k, kw, k, op, stream)
            if rc != 0:
                raise RuntimeError(f"fusedmm_bsr launch failed: CUDA error "
                                   f"{rc}")
            fusedmm_bsr_cuda.launches += 1
    return out


fusedmm_bsr_cuda.launches = 0
