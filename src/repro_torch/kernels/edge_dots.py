"""Per-edge SDDMM over a COO edge list: the hand-written CUDA kernel, its
plain PyTorch version and the dispatcher between them.

``s[e] = x[row[e]] · y[col[e]]`` for every edge, and optionally, in the
same launch over the same ``(row, col)`` stream, ``s2[e] = x2[row[e]] ·
y2[col[e]]`` (the FusedMM backward's recomputed scores and its
``dw_e = dout[row_e] · h[col_e]``). Ids out of range read zero rows.

* :func:`edge_dots_cuda` launches ``csrc/edge_dots.cu``: an 8-lane group
  an edge, a fixed shuffle tree over the group (the same bits on every
  run), no atomics. It has no Pallas counterpart (the reference computes
  these dot products in XLA); the source's header says what bounds it.
* :func:`edge_dots_plain` is :func:`repro_torch.kernels.ref.edge_dots`
  (gathers, products and row sums in chunks of edges), once per product.
* :func:`edge_dots` chooses by the device of ``x`` and by nothing else: a
  CUDA tensor launches the kernel (which raises if it cannot build or
  launch), a CPU tensor runs the plain version, any other device raises.
  The kernel route is not differentiable: its callers run it inside
  their own ``autograd.Function``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import edge_dots as _dots_plain

__all__ = ["edge_dots", "edge_dots_cuda", "edge_dots_plain", "vec_ok"]

_INT_MAX = 2 ** 31 - 1
_GROUPS = 32            # edges a CTA (csrc kEdges)


def vec_ok(width: int, *tensors: torch.Tensor) -> bool:
    """True where the kernel reads 16-byte vectors: ``width`` a multiple
    of 4 and every matrix 16-byte aligned (so every row start is too)."""
    return width % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def edge_dots_plain(x: torch.Tensor, y: torch.Tensor, row: torch.Tensor,
                    col: torch.Tensor, x2: Optional[torch.Tensor] = None,
                    y2: Optional[torch.Tensor] = None):
    """``ref.edge_dots`` for ``(x, y)`` and, given ``x2``/``y2``, for
    them too: ``s`` or ``(s, s2)``."""
    s = _dots_plain(x, y, row, col)
    return s if x2 is None else (s, _dots_plain(x2, y2, row, col))


def _check(name: str, t: torch.Tensor, dev, dtype, dim: int) -> None:
    if t.device != dev or t.dtype != dtype or t.dim() != dim or \
            not t.is_contiguous():
        raise ValueError(f"edge_dots: {name} must be a contiguous {dtype} "
                         f"{'matrix' if dim == 2 else 'vector'} on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def edge_dots_cuda(x: torch.Tensor, y: torch.Tensor, row: torch.Tensor,
                   col: torch.Tensor, x2: Optional[torch.Tensor] = None,
                   y2: Optional[torch.Tensor] = None):
    """The hand kernel: ``x``, ``y`` (and ``x2``, ``y2``) contiguous fp32
    matrices, ``row``/``col`` contiguous int32 vectors of one length, all
    on one card; ``s`` or ``(s, s2)``, fp32. Counts its launches in
    ``edge_dots_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"edge_dots: needs CUDA tensors, got {dev}")
    if (x2 is None) != (y2 is None):
        raise ValueError("edge_dots: x2 and y2 come together")
    mats = [("x", x), ("y", y)] + ([("x2", x2), ("y2", y2)]
                                   if x2 is not None else [])
    for key, t in mats:
        _check(key, t, dev, torch.float32, 2)
    for key, t in (("row", row), ("col", col)):
        _check(key, t, dev, torch.int32, 1)
    n, d = row.shape[0], x.shape[1]
    k = x2.shape[1] if x2 is not None else 0
    if col.shape[0] != n or y.shape[1] != d or \
            (x2 is not None and y2.shape[1] != k):
        raise ValueError(f"edge_dots: row {tuple(row.shape)} / col "
                         f"{tuple(col.shape)}, x {tuple(x.shape)} / y "
                         f"{tuple(y.shape)} do not match")
    if -(-n // _GROUPS) > _INT_MAX or max(d, k) > _INT_MAX:
        raise ValueError(f"edge_dots: {n} edges of width {d}, {k}")
    s = torch.empty((n,), dtype=torch.float32, device=dev)
    s2 = torch.empty((n,), dtype=torch.float32, device=dev) \
        if x2 is not None else None
    if n == 0:
        return s if s2 is None else (s, s2)
    lib = load_kernel("edge_dots")
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    rows = (lambda t: 0 if t is None else t.shape[0])
    with torch.cuda.device(dev):
        rc = lib.edge_dots_f32(
            x.data_ptr(), x.shape[0], y.data_ptr(), y.shape[0], d, ptr(x2),
            rows(x2), ptr(y2), rows(y2), k, row.data_ptr(), col.data_ptr(),
            n, s.data_ptr(), ptr(s2), int(vec_ok(d, x, y)),
            int(x2 is not None and vec_ok(k, x2, y2)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edge_dots launch failed: CUDA error {rc}")
    edge_dots_cuda.launches += 1
    return s if s2 is None else (s, s2)


edge_dots_cuda.launches = 0


def edge_dots(x: torch.Tensor, y: torch.Tensor, row: torch.Tensor,
              col: torch.Tensor, x2: Optional[torch.Tensor] = None,
              y2: Optional[torch.Tensor] = None):
    """``s[e] = x[row[e]] · y[col[e]]`` (and ``s2[e] = x2[row[e]] ·
    y2[col[e]]`` in the same pass): ``s`` or ``(s, s2)``. A CUDA ``x``
    launches the kernel (fp32 copies of non-fp32 or strided operands), a
    CPU one runs the plain version."""
    if x.device.type == "cuda":
        prep = (lambda t: None if t is None else t.float().contiguous())
        ids = (lambda t: t.to(torch.int32).contiguous())
        return edge_dots_cuda(prep(x), prep(y), ids(row), ids(col), prep(x2),
                              prep(y2))
    if x.device.type == "cpu":
        return edge_dots_plain(x, y, row, col, x2, y2)
    raise ValueError(f"no edge_dots implementation for {x.device}")
