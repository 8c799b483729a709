"""Ordered segment sums: the deterministic scatter of the port's
backwards on the card.

``out[t] = Σ_{p ∈ [offsets[t], offsets[t+1])} weight[p] · src[index[p]]``
over slots sorted by their target. A CUDA float ``index_add_`` adds with
atomics, so its sum order (and last bits) change from run to run; here
the slots are sorted by target once, **stably** (a target's slots keep
their order), and the hand kernel of ``csrc/segment_sum.cu`` sums each
target's slots in that order: the result depends only on the inputs.
The reference's backwards are XLA segment sums, which give one answer
for one input on its chip; this is the port's counterpart (there is no
Pallas kernel to port).

* :class:`SegmentOrder` / :func:`segment_order` — the stable sort of a
  target vector: ``perm`` (slot ``p`` of the sorted order is entry
  ``perm[p]``) and the ``offsets`` of each target's run, by
  ``torch.searchsorted`` over the sorted ids (static sizes, no host
  sync). Graph-static orders are built once per
  :class:`~repro_torch.core.cache.CachedGraph`.
* :func:`segment_sum_sorted` — the primitive (dispatcher, plain version,
  hand kernel).
* Built on it, each target's entries in entry order: :func:`scatter_sum`
  (``Σ data[e]``), :func:`gather_scale_sum` (``Σ weight[e] ·
  src[index[e]]``: SpMM over the sorted slots, with no ``(edges, K)``
  message tensor) and :func:`chunked_sum` (messages built chunk by chunk
  of the sorted entries).

The ordered route runs outside autograd: the port's backwards call it
from inside their ``autograd.Function`` classes.

Each dispatcher chooses by the device of ``src`` and by nothing else: a
CUDA tensor launches the kernel (which raises if it cannot build or
launch), a CPU tensor runs the plain version (a product tensor and a
sequential ``index_add_``: slot order within a target, so the kernel
equals it bit for bit wherever a target's slots fit one piece of 256).
Slots whose index is outside ``[0, src.shape[0])`` add nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SegmentOrder", "segment_order", "segment_sum_sorted", "on_card",
           "segment_sum_sorted_cuda", "segment_sum_sorted_plain",
           "scatter_sum", "gather_scale_sum", "chunked_sum", "CHUNK"]

CHUNK = 256          # slots a work item of the kernel sums (csrc kChunk)
_INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class SegmentOrder:
    """A target vector's entries sorted stably by target: sorted slot
    ``p`` is entry ``perm[p]`` (int32) and target ``t`` owns sorted slots
    ``offsets[t] .. offsets[t+1]`` (int64, ``num_targets + 1`` entries).
    Entries whose target is outside ``[0, num_targets)`` sort outside
    every run."""

    perm: torch.Tensor
    offsets: torch.Tensor

    @property
    def num_targets(self) -> int:
        return self.offsets.shape[0] - 1


def segment_order(targets: torch.Tensor, num_targets: int) -> SegmentOrder:
    """The stable sort of ``targets`` (any integer dtype) on its device,
    static shapes, no host sync."""
    t = targets.to(torch.int32)
    if t.shape[0] > _INT_MAX:
        raise ValueError("segment_order: more entries than int32 indexes")
    ids = torch.arange(num_targets + 1, dtype=torch.int32, device=t.device)
    srt, perm = torch.sort(t, stable=True)
    return SegmentOrder(perm=perm.to(torch.int32),
                        offsets=torch.searchsorted(srt, ids))


# --------------------------------------------------------------------------
# The primitive
# --------------------------------------------------------------------------

def _n_slots(src, index, weight) -> int:
    if index is not None:
        return index.shape[0]
    return weight.shape[0] if weight is not None else src.shape[0]


def segment_sum_sorted_plain(src: torch.Tensor, offsets: torch.Tensor, *,
                             index: Optional[torch.Tensor] = None,
                             weight: Optional[torch.Tensor] = None,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version: each slot's product, then ``index_add_`` into its
    target (slots of no target, and slots with an out-of-range index,
    land on a spare row that is dropped). ``out`` given: added to it in
    place and returned."""
    n_t, k = offsets.shape[0] - 1, src.shape[1]
    n = _n_slots(src, index, weight)
    pos = torch.arange(n, device=src.device)
    tgt = torch.searchsorted(offsets, pos, right=True) - 1
    lo, hi = offsets[:1].clamp(0, n), offsets[-1:].clamp(0, n)
    ok = (pos >= lo) & (pos < hi) & (tgt >= 0) & (tgt < n_t)
    rows = pos if index is None else index.long()
    ok &= (rows >= 0) & (rows < src.shape[0])
    if src.shape[0] == 0:
        msg = src.new_zeros((n, k), dtype=torch.float32)
    else:
        msg = src[torch.where(ok, rows, 0)].float()
    if weight is not None:
        msg = weight.float()[:, None] * msg
    acc = torch.zeros((n_t + 1, k), dtype=torch.float32, device=src.device)
    if out is not None:
        acc[:n_t] = out
    acc.index_add_(0, torch.where(ok, tgt, n_t), msg)
    if out is None:
        return acc[:n_t]
    out.copy_(acc[:n_t])
    return out


def segment_sum_sorted_cuda(src: torch.Tensor, offsets: torch.Tensor, *,
                            index: Optional[torch.Tensor] = None,
                            weight: Optional[torch.Tensor] = None,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The hand kernel: one warp a piece of at most 256 of a target's
    slots, pieces of long targets summed in order by a second kernel.
    ``src`` (S, K) fp32, ``offsets`` (T + 1,) int64, ``index`` (P,) int32,
    ``weight`` (P,) fp32 (contiguous, on one card); ``out`` (T, K) fp32 is
    added to in place. Counts its launches in
    ``segment_sum_sorted_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel
    from repro_torch.kernels.ell_spmm import vec_width

    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: needs CUDA tensors, got {dev}")
    if src.dtype != torch.float32 or src.dim() != 2 or \
            not src.is_contiguous():
        raise ValueError(f"segment_sum: src must be a contiguous fp32 "
                         f"matrix, got {src.dtype} {tuple(src.shape)}")
    arrays = (("offsets", offsets, torch.int64),
              ("index", index, torch.int32), ("weight", weight,
                                              torch.float32))
    for key, t, dtype in arrays:
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or t.dim() != 1 or \
                not t.is_contiguous():
            raise ValueError(f"segment_sum: {key} must be a contiguous "
                             f"{dtype} vector on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    n_t, k = offsets.shape[0] - 1, src.shape[1]
    n = _n_slots(src, index, weight)
    if n_t < 0 or (index is not None and weight is not None
                   and weight.shape[0] != n):
        raise ValueError(f"segment_sum: offsets {tuple(offsets.shape)}, "
                         f"index / weight lengths do not match")
    if n_t > _INT_MAX or k > _INT_MAX or k < 1:
        raise ValueError(f"segment_sum: {n_t} targets of width {k}")
    if out is not None:
        if out.device != dev or out.dtype != torch.float32 or \
                out.shape != (n_t, k) or not out.is_contiguous():
            raise ValueError(f"segment_sum: out must be a contiguous fp32 "
                             f"({n_t}, {k}) matrix on {dev}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}")
        res = out
    else:
        res = torch.empty((n_t, k), dtype=torch.float32, device=dev)
    if n_t == 0:
        return res
    ws = None
    if n > CHUNK:
        ws = torch.empty((-(-n // CHUNK), k), dtype=torch.float32,
                         device=dev)
    vec = vec_width(k, src, res, *([ws] if ws is not None else []))
    lib = load_kernel("segment_sum")
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.segment_sum_f32(
            src.data_ptr(), src.shape[0], ptr(index), ptr(weight),
            offsets.data_ptr(), res.data_ptr(), ptr(ws), n_t, k, n, vec,
            int(out is not None), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {rc}")
    segment_sum_sorted_cuda.launches += 1
    return res


segment_sum_sorted_cuda.launches = 0


def on_card(t: torch.Tensor) -> bool:
    """True where the ordered route runs: on a CUDA tensor (a CPU one
    keeps the sequential ``index_add_``; any other device raises)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no segment_sum implementation for {t.device}")


def segment_sum_sorted(src: torch.Tensor, offsets: torch.Tensor, *,
                       index: Optional[torch.Tensor] = None,
                       weight: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[t] (+)= Σ_{p ∈ [offsets[t], offsets[t+1])} weight[p] ·
    src[index[p]]`` in slot order (fp32). ``index`` None: slot ``p``
    reads row ``p``; ``weight`` None: weight 1; ``out`` given: added to in
    place (targets without slots keep their row), else a new (T, K)
    tensor (0 where a target has no slot)."""
    if on_card(src):
        return segment_sum_sorted_cuda(src, offsets, index=index,
                                       weight=weight, out=out)
    return segment_sum_sorted_plain(src, offsets, index=index, weight=weight,
                                    out=out)


# --------------------------------------------------------------------------
# Built on it
# --------------------------------------------------------------------------

def gather_scale_sum(src: torch.Tensor, order: SegmentOrder,
                     index: torch.Tensor,
                     weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[t] = Σ_{e: target[e] = t} weight[e] · src[index[e]]`` with
    the entries of each target in entry order, ``order`` the stable sort
    of the (unseen) target vector: a sparse-dense product over sorted
    slots, with no per-entry message tensor. ``index``/``weight`` are per
    entry (in entry order); ``src`` rows out of range add nothing."""
    if weight is not None:
        weight = weight.float().index_select(0, order.perm)
    return segment_sum_sorted(
        src.float().contiguous(), order.offsets,
        index=index.index_select(0, order.perm).to(torch.int32), weight=weight)


def chunked_sum(order: SegmentOrder, n: int, k: int, messages,
                step: int) -> torch.Tensor:
    """``out[t] = Σ_{e: target[e] = t} messages(e)`` over the first ``n``
    entries, each target's entries in entry order: the sorted entries in
    chunks of ``step``, ``messages(ids)`` building a chunk's (chunk, K)
    rows from its entry ids, each chunk added into ``out`` in order."""
    out = torch.zeros((order.num_targets, k), dtype=torch.float32,
                      device=order.offsets.device)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        msgs = messages(order.perm[lo:hi].long())
        segment_sum_sorted(msgs.float().contiguous(),
                           order.offsets.clamp(lo, hi) - lo, out=out)
    return out


def scatter_sum(data: torch.Tensor, target: torch.Tensor, num_targets: int,
                order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """``out[t] = Σ_{e: target[e] = t} data[e]`` for ``data`` of shape
    (E,) or (E, K). Given ``order`` (the stable sort of ``target``) and no
    autograd record to keep, a card tensor's entries of a target are
    summed in entry order through the ordered kernel; otherwise, and on
    the CPU, it is ``index_add`` into zeros (sequential on the CPU, so in
    the same order; differentiable)."""
    if order is None or not on_card(data) or \
            (torch.is_grad_enabled() and data.requires_grad):
        out = torch.zeros((num_targets,) + tuple(data.shape[1:]),
                          dtype=data.dtype, device=data.device)
        return out.index_add(0, target.long(), data)
    out = segment_sum_sorted(data.reshape(data.shape[0], -1).float()
                             .contiguous(), order.offsets, index=order.perm)
    return out.reshape((num_targets,) + tuple(data.shape[1:])).to(data.dtype)
