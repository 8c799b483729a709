"""SELL-C-σ SpMM (sum semiring): the hand-written CUDA kernel and its
plain PyTorch version.

``sell_spmm_cuda`` launches ``csrc/sell_spmm.cu``, the Hopper replacement
of the TPU kernel ``sell_spmm_pallas`` (``src/repro/kernels/sell_spmm.py``).
The TPU kernel keeps a slice's ``(C, K)`` accumulator resident across the
sequential grid; here one warp owns one sorted row and loops over its
slice's steps, the slice bounds coming from ``slice_of`` in this wrapper,
and the un-sort through ``perm`` is fused into the store. Bound by the
bytes of the gathered h rows, like the ELL kernel. ``sell_spmm_plain``
runs the packed-slice algorithm with tensor ops (CPU dispatch, tests).
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import SELL
from repro_torch.kernels.ell_spmm import check_launch_operands, vec_width
from repro_torch.kernels.ref import spmm_sell_ref

__all__ = ["sell_spmm_cuda", "sell_spmm_plain", "slice_pointers"]


def sell_spmm_plain(a: SELL, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SELL SpMM: packed-slice segment sum + inverse perm."""
    return spmm_sell_ref(a, h)


def slice_pointers(a: SELL) -> torch.Tensor:
    """``(nslices + 1,)`` int32 step offsets: slice s owns steps
    ``[ptr[s], ptr[s+1])``. ``slice_of`` is monotone, so this is a
    binary search per slice, done on ``slice_of``'s device without a host
    sync; padding steps owned by the last slice fall inside its range."""
    bounds = torch.arange(a.nslices + 1, dtype=torch.int32,
                          device=a.slice_of.device)
    return torch.searchsorted(a.slice_of, bounds, out_int32=True)


def sell_spmm_cuda(a: SELL, h: torch.Tensor) -> torch.Tensor:
    """``(a.nrows, K)`` fp32 = a @ h on the card through the hand kernel,
    rows already in original order. Counts its launches in
    ``sell_spmm_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    check_launch_operands("sell_spmm", h, idx=a.idx, val=a.val,
                          slice_of=a.slice_of, perm=a.perm)
    if h.shape[0] != a.ncols:
        raise ValueError(f"sell_spmm: h has {h.shape[0]} rows, "
                         f"a has {a.ncols} columns")
    if a.idx.dim() != 2 or a.idx.shape[1] != a.c or \
            a.val.shape != a.idx.shape or \
            tuple(a.slice_of.shape) != (a.n_steps,) or \
            tuple(a.perm.shape) != (a.nrows_padded,) or \
            a.nrows > a.nrows_padded:
        raise ValueError(f"sell_spmm: inconsistent SELL shapes: idx "
                         f"{tuple(a.idx.shape)}, slice_of "
                         f"{tuple(a.slice_of.shape)}, perm "
                         f"{tuple(a.perm.shape)}, c={a.c}, "
                         f"nslices={a.nslices}, nrows={a.nrows}")
    k = h.shape[1]
    out = torch.empty((a.nrows, k), dtype=torch.float32, device=h.device)
    if a.nrows == 0 or k == 0:
        return out.zero_()
    ptr = slice_pointers(a)
    vec = vec_width(k, h, out)
    lib = load_kernel("sell_spmm")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.sell_spmm_f32(a.idx.data_ptr(), a.val.data_ptr(),
                               ptr.data_ptr(), a.perm.data_ptr(),
                               h.data_ptr(), out.data_ptr(), a.nslices, a.c,
                               a.nrows, a.ncols, k, vec, stream)
    if rc != 0:
        raise RuntimeError(f"sell_spmm launch failed: CUDA error {rc}")
    sell_spmm_cuda.launches += 1
    return out


sell_spmm_cuda.launches = 0
