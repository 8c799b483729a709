"""ELLPACK SpMM (sum semiring): the hand-written CUDA kernel and its plain
PyTorch version.

``ell_spmm_cuda`` launches ``csrc/ell_spmm.cu``, the Hopper replacement of
the TPU kernel ``ell_spmm_pallas`` (``src/repro/kernels/ell_spmm.py``):
one warp per output row, fp32 register accumulation, sentinel slots
skipped in place of the TPU wrapper's K-pad and appended zero row. The
kernel is bound by the bytes of the gathered h rows; the source's header
note says what the design does about that. ``ell_spmm_plain`` computes
the same function with tensor ops; the CPU dispatch and the tests use it.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import get_semiring
from repro_torch.core.sparse import ELL
from repro_torch.kernels.ref import spmm_ell_ref

__all__ = ["ell_spmm_cuda", "ell_spmm_plain", "vec_width",
           "check_launch_operands"]

_INT_MAX = 2 ** 31 - 1


def vec_width(k: int, *tensors: torch.Tensor) -> int:
    """Widest float vector (4, 2 or 1) that divides ``k`` and to which
    every tensor's base address is aligned, so every row start is too."""
    for v in (4, 2):
        if k % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


def check_launch_operands(name: str, h: torch.Tensor, **arrays) -> None:
    """Raise unless ``h`` is a contiguous fp32 CUDA matrix and every
    array is contiguous on the same device with the expected dtype
    (``*idx``/``perm``/``slice_ptr`` int32, ``*val`` fp32)."""
    if h.device.type != "cuda":
        raise ValueError(f"{name}: h must be a CUDA tensor, got {h.device}")
    if h.dtype != torch.float32 or h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"{name}: h must be a contiguous fp32 matrix, got "
                         f"{h.dtype} {tuple(h.shape)}")
    for key, t in arrays.items():
        want = torch.float32 if key.endswith("val") else torch.int32
        if t.device != h.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {want} on "
                             f"{h.device}, got {t.dtype} on {t.device}")
        if t.numel() > _INT_MAX:
            raise ValueError(f"{name}: {key} exceeds int32 indexing")
    if h.shape[0] > _INT_MAX or h.shape[1] > _INT_MAX:
        raise ValueError(f"{name}: h exceeds int32 indexing")


def ell_spmm_plain(a: ELL, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ELL SpMM: zero-filled gather, weighted slot sum."""
    return spmm_ell_ref(a, h, get_semiring("sum")).float()


def ell_spmm_cuda(a: ELL, h: torch.Tensor) -> torch.Tensor:
    """``(a.nrows, K)`` fp32 = a @ h on the card through the hand kernel.
    Counts its launches in ``ell_spmm_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    check_launch_operands("ell_spmm", h, idx=a.idx, val=a.val)
    if h.shape[0] != a.ncols:
        raise ValueError(f"ell_spmm: h has {h.shape[0]} rows, "
                         f"a has {a.ncols} columns")
    if tuple(a.idx.shape) != (a.nrows, a.max_deg) or \
            a.val.shape != a.idx.shape:
        raise ValueError(f"ell_spmm: idx {tuple(a.idx.shape)} / val "
                         f"{tuple(a.val.shape)} do not match "
                         f"({a.nrows}, max_deg)")
    k = h.shape[1]
    out = torch.empty((a.nrows, k), dtype=torch.float32, device=h.device)
    if a.nrows == 0 or k == 0 or a.max_deg == 0:
        return out.zero_()
    vec = vec_width(k, h, out)
    lib = load_kernel("ell_spmm")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.ell_spmm_f32(a.idx.data_ptr(), a.val.data_ptr(),
                              h.data_ptr(), out.data_ptr(), a.nrows,
                              a.max_deg, a.ncols, k, vec, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm launch failed: CUDA error {rc}")
    ell_spmm_cuda.launches += 1
    return out


ell_spmm_cuda.launches = 0
