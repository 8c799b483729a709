"""SELL-C-σ SpMM (sum semiring): the hand-written CUDA kernel and its
plain PyTorch version.

``sell_spmm_cuda`` launches ``csrc/sell_spmm.cu``, the Hopper replacement
of the TPU kernel ``sell_spmm_pallas`` (``src/repro/kernels/sell_spmm.py``).
The TPU kernel keeps a slice's ``(C, K)`` accumulator resident across the
sequential grid; here a warp owns one sorted row of one piece of its
slice's steps, at most ``CHUNK_STEPS`` (S) long, and keeps several
gathered h rows in flight. Two routes, chosen by the operand's step
count alone (``sell_route``): ``row`` when no slice can pass S steps
(every slice is one piece, stored straight to its original rows) and
``split`` otherwise (a slice longer than S is cut into chunks of S
steps whose partial rows go to a workspace, and a second kernel sums
them in chunk order). The chunk schedule is derived on the card from
``slice_pointers`` and ``slice_of`` by the kernels themselves, with no
host sync; ``sell_schedule`` states it in Python. Bound by the bytes of
the gathered h rows, like the ELL kernel. ``sell_spmm_plain`` runs the
packed-slice algorithm with tensor ops (CPU dispatch, tests).
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import SELL
from repro_torch.kernels.ell_spmm import check_launch_operands, vec_width
from repro_torch.kernels.ref import spmm_sell_ref

__all__ = ["sell_spmm_cuda", "sell_spmm_plain", "slice_pointers",
           "CHUNK_STEPS", "ROUTES", "sell_route", "sell_windows",
           "sell_workspace_bytes", "sell_schedule", "split_chunks"]

# S: the most packed steps of one slice that one warp walks (csrc/
# sell_spmm.cu takes it at run time); tools/compare_kernels.py sweeps it
CHUNK_STEPS = 1024
ROUTES = ("row", "split")


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


def sell_route(n_steps: int, chunk: int = CHUNK_STEPS) -> str:
    """``row`` when no slice can have more than ``chunk`` steps (the
    operand has no more), else ``split``: a function of the operand's
    step count alone, known on the host without a sync."""
    return "row" if n_steps <= chunk else "split"


def sell_windows(n_steps: int, chunk: int = CHUNK_STEPS) -> int:
    """Windows of ``chunk`` steps the split route launches work items
    for (0 on the row route)."""
    return 0 if sell_route(n_steps, chunk) == "row" else -(-n_steps // chunk)


def sell_workspace_bytes(n_steps: int, c: int, k: int,
                         chunk: int = CHUNK_STEPS) -> int:
    """Bytes of the split route's workspace: two partial rows of ``k``
    fp32 per window and sorted row of a slice."""
    return 2 * sell_windows(n_steps, chunk) * c * k * 4


def sell_schedule(ptr: torch.Tensor, slice_of: torch.Tensor,
                  chunk: int = CHUNK_STEPS) -> list[tuple]:
    """The pieces the kernel walks, derived as ``csrc/sell_spmm.cu``'s
    ``piece_of`` derives them, in launch order: one work item per window
    of ``chunk`` steps (the chunk that starts in it, if it is not a
    slice's first), then one per slice (its first chunk). Each piece is
    ``(item, slice, t0, t1, slot)``: steps ``[t0, t1)`` of the slice,
    ``slot`` the workspace slot of its partial rows or -1 where the slice
    is one piece and stores straight to its rows. Empty window items are
    left out."""
    ptr = [int(v) for v in ptr.cpu()]
    slice_of = slice_of.cpu()
    n_steps, nslices = slice_of.numel(), len(ptr) - 1
    nwin = sell_windows(n_steps, chunk)
    pieces = []
    for w in range(nwin):
        tw = w * chunk
        if tw >= n_steps:
            continue
        s = int(slice_of[tw])
        p0, p1 = ptr[s], ptr[s + 1]
        if p0 >= tw:
            continue
        t0 = p0 + -(-(tw - p0) // chunk) * chunk
        if t0 >= tw + chunk or t0 >= p1:
            continue
        pieces.append((w, s, t0, min(t0 + chunk, p1), 2 * w))
    for s in range(nslices):
        p0, p1 = ptr[s], ptr[s + 1]
        pieces.append((nwin + s, s, p0, min(p0 + chunk, p1),
                       2 * (p0 // chunk) + 1 if p1 - p0 > chunk else -1))
    return pieces


def split_chunks(a: SELL, chunk: int = CHUNK_STEPS) -> int:
    """Chunks of the slices longer than ``chunk`` steps (the pieces that
    write partial rows). Reads the slice pointers on the host: for
    reports, not for a launch."""
    steps = torch.diff(slice_pointers(a).long()).cpu()
    long_ = steps[steps > chunk]
    return int((-(-long_ // chunk)).sum()) if sell_route(
        a.n_steps, chunk) == "split" else 0


def sell_spmm_cuda(a: SELL, h: torch.Tensor, *,
                   chunk: int = CHUNK_STEPS) -> torch.Tensor:
    """``(a.nrows, K)`` fp32 = a @ h on the card through the hand kernel,
    rows already in original order; no slice's rows are walked more than
    ``chunk`` steps by one warp. Counts its launches in
    ``sell_spmm_cuda.launches`` and by route (``sell_route``) in
    ``sell_spmm_cuda.launches_by_instance``; the largest workspace one
    call allocated is ``sell_spmm_cuda.workspace_bytes``. A build or
    launch failure raises."""
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
    if chunk < 1:
        raise ValueError(f"sell_spmm: chunk {chunk} < 1")
    k = h.shape[1]
    out = torch.empty((a.nrows, k), dtype=torch.float32, device=h.device)
    if a.nrows == 0 or k == 0:
        return out.zero_()
    ptr = slice_pointers(a)
    route = sell_route(a.n_steps, chunk)
    nwin = sell_windows(a.n_steps, chunk)
    ws = torch.empty((2 * nwin * a.c, k), dtype=torch.float32,
                     device=h.device) if nwin else None
    vec = vec_width(k, h, out)
    lib = load_kernel("sell_spmm")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.sell_spmm_f32(a.idx.data_ptr(), a.val.data_ptr(),
                               ptr.data_ptr(), a.slice_of.data_ptr(),
                               a.perm.data_ptr(), h.data_ptr(),
                               out.data_ptr(),
                               None if ws is None else ws.data_ptr(),
                               a.nslices, a.c, a.nrows, a.ncols, k, vec,
                               a.n_steps, chunk, nwin, stream)
    if rc != 0:
        raise RuntimeError(f"sell_spmm launch failed: CUDA error {rc}")
    sell_spmm_cuda.launches += 1
    sell_spmm_cuda.launches_by_instance[route] += 1
    if ws is not None:
        sell_spmm_cuda.workspace_bytes = max(sell_spmm_cuda.workspace_bytes,
                                             ws.numel() * 4)
    return out


sell_spmm_cuda.launches = 0
sell_spmm_cuda.launches_by_instance = dict.fromkeys(ROUTES, 0)
sell_spmm_cuda.workspace_bytes = 0
