"""Device dispatch over the port's kernels.

``bsr_spmm`` / ``ell_spmm`` / ``sell_spmm`` / ``sddmm_bsr`` /
``fusedmm_bsr`` and the LM side's ``ragged_gemm`` / ``flash_attention``
choose by the device of the dense operand and by nothing else: a CUDA tensor launches the
hand-written kernel (which raises if it cannot build or launch), a CPU
tensor runs the plain PyTorch version, any other device raises. There is
no fallback between the two.

``ragged_gemm`` and ``flash_attention`` are differentiable: each is a
``torch.autograd.Function`` whose backward launches hand kernels on the
card (the ragged GEMM reading the weights transposed in place for dX,
with dW one batched product; ``flash_attention_bwd``, which recomputes the scores
from the forward's row log-sum-exp) and runs the plain pieces on the
CPU. A backward launch is counted like a forward one: flash's under its
own wrapper, ``flash_attention_bwd``; the ragged GEMM's by direction in
``ragged_gemm_cuda.launches_by_direction``. Calls that need no gradient
(serving) launch the forward kernels alone, without the log-sum-exp.

``gathered_ell_spmm`` is ``ell_spmm`` over a block whose source rows are
picked out of a full feature matrix: the block's ``src_ids`` are composed
into its neighbour table, and the ELL kernel reads the full matrix in
place (the reference composes the two gathers in XLA, not in Pallas).

The sampling primitives' kernels (``kernels/sample.py``, the fused hop
among them), the ordered segment sum of the backwards
(``kernels/segment_sum.py``) and the per-edge SDDMM of the FusedMM and
SDDMM autograd paths (``kernels/edge_dots.py``) dispatch in their own
modules and count their launches here too.

``slot_gather`` / ``table_insert`` are the serving feature cache's device
primitives. The reference writes them as plain array ops, so plain tensor
indexing is their port.

Profile-ops mode (``repro_torch.obs``): every dispatcher records one
``op.<name>`` event per call; disabled, the cost is one flag check.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse import BSR, ELL, SELL
from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda, bsr_spmm_plain
from repro_torch.kernels.build import build_kernels, load_kernel
from repro_torch.kernels.edge_dots import edge_dots_cuda
from repro_torch.kernels.ell_spmm import ell_spmm_cuda, ell_spmm_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_cuda, flash_attention_bwd_plain,
    flash_attention_cuda, flash_attention_plain, flash_attention_plain_lse)
from repro_torch.kernels.fusedmm import fusedmm_bsr_cuda, fusedmm_bsr_plain
from repro_torch.kernels.ragged_gemm import (ragged_gemm_cuda,
                                             ragged_gemm_dw,
                                             ragged_gemm_plain)
from repro_torch.kernels.sample import (expand_indptr_cuda, flat_gather_cuda,
                                        sample_hop_cuda, segment_sample_cuda)
from repro_torch.kernels.segment_sum import segment_sum_sorted_cuda
from repro_torch.kernels.sddmm import sddmm_bsr_cuda, sddmm_bsr_plain
from repro_torch.kernels.sell_spmm import sell_spmm_cuda, sell_spmm_plain
from repro_torch.obs import op_record, op_t0

__all__ = ["bsr_spmm", "ell_spmm", "sell_spmm", "gathered_ell_spmm",
           "sddmm_bsr", "fusedmm_bsr", "ragged_gemm", "flash_attention",
           "slot_gather", "table_insert", "build_kernels", "load_kernel",
           "kernel_launches", "reset_kernel_launches"]

_CUDA_WRAPPERS = {"ell_spmm": ell_spmm_cuda, "sell_spmm": sell_spmm_cuda,
                  "bsr_spmm": bsr_spmm_cuda,
                  "segment_sample": segment_sample_cuda,
                  "expand_indptr": expand_indptr_cuda,
                  "flat_gather": flat_gather_cuda,
                  "sample_hop": sample_hop_cuda,
                  "segment_sum": segment_sum_sorted_cuda,
                  "edge_dots": edge_dots_cuda,
                  "sddmm_bsr": sddmm_bsr_cuda,
                  "fusedmm_bsr": fusedmm_bsr_cuda,
                  "ragged_gemm": ragged_gemm_cuda,
                  "flash_attention": flash_attention_cuda,
                  "flash_attention_bwd": flash_attention_bwd_cuda}


def _backend(h: torch.Tensor, op: str = "SpMM") -> str:
    if h.device.type == "cuda":
        return "cuda"
    if h.device.type == "cpu":
        return "plain"
    raise ValueError(f"no {op} implementation for device {h.device}")


def bsr_spmm(a: BSR, h: torch.Tensor) -> torch.Tensor:
    """(a.nrows, K) fp32 = a @ h over the dense Br x Bc tiles (sum
    semiring). ``a.nrows`` is padded to a multiple of ``br``: the caller
    crops. ``h`` may have fewer than ``a.ncols`` rows; the padding rows
    read as zero."""
    t0 = op_t0()
    backend = _backend(h)
    out = bsr_spmm_cuda(a, h) if backend == "cuda" else bsr_spmm_plain(a, h)
    op_record("bsr_spmm", out, a.blocks, h, t0_ns=t0, backend=backend)
    return out


def ell_spmm(a: ELL, h: torch.Tensor) -> torch.Tensor:
    """(a.nrows, K) fp32 = a @ h over the row-padded ELLPACK neighbor
    lists (sum semiring). Rectangular operands are first-class: ``h`` has
    ``a.ncols`` rows (a sampled block's source count)."""
    t0 = op_t0()
    backend = _backend(h)
    out = ell_spmm_cuda(a, h) if backend == "cuda" else ell_spmm_plain(a, h)
    op_record("ell_spmm", out, a.idx, h, t0_ns=t0, backend=backend)
    return out


def sell_spmm(a: SELL, h: torch.Tensor) -> torch.Tensor:
    """(a.nrows, K) fp32 = a @ h over SELL-C-σ packed slices (sum
    semiring), rows in original order."""
    t0 = op_t0()
    backend = _backend(h)
    out = sell_spmm_cuda(a, h) if backend == "cuda" else sell_spmm_plain(a, h)
    op_record("sell_spmm", out, a.idx, h, t0_ns=t0, backend=backend)
    return out


def sddmm_bsr(a: BSR, x: torch.Tensor, y: torch.Tensor, *,
              scale_by_a: bool = True) -> torch.Tensor:
    """Sampled dense-dense matmul over A's block pattern: ``(nblocks, br,
    bc)`` fp32 per-tile scores ``x_i · y_j`` at every position of every
    stored tile, times A's stored values when ``scale_by_a``. ``x`` and
    ``y`` may have fewer than ``a.nrows`` / ``a.ncols`` rows (the rest
    read as zero)."""
    t0 = op_t0()
    backend = _backend(x)
    fn = sddmm_bsr_cuda if backend == "cuda" else sddmm_bsr_plain
    out = fn(a, x, y, scale_by_a=scale_by_a)
    op_record("sddmm", out, a.blocks, x, y, t0_ns=t0, backend=backend)
    return out


def fusedmm_bsr(a: BSR, x: torch.Tensor, y: torch.Tensor, h: torch.Tensor,
                *, edge_op: str = "softmax") -> torch.Tensor:
    """Fused SDDMM -> edge op -> SpMM over BSR tiles: ``out[i] = Σ_j
    f(x_i · y_j) h_j`` over A's nonzero tile entries without the edge
    tensor ever reaching device memory (paper §3.4 / FusedMM).
    ``edge_op``: softmax | sigmoid | none. ``(a.nrows, K)`` fp32 (padded
    rows: the caller crops)."""
    t0 = op_t0()
    backend = _backend(h)
    fn = fusedmm_bsr_cuda if backend == "cuda" else fusedmm_bsr_plain
    out = fn(a, x, y, h, edge_op=edge_op)
    op_record("fusedmm", out, a.blocks, x, y, h, t0_ns=t0, edge_op=edge_op,
              backend=backend)
    return out


class _RaggedGemm(torch.autograd.Function):
    """out = x @ w[expert(token)]; dX = dY · W[e]ᵀ through the same
    kernel reading w transposed in place, dW = ``ragged_gemm_dw`` over
    ``n_groups`` equal expert groups of rows (None: no weight gradient
    can be formed)."""

    @staticmethod
    def forward(ctx, x, w, tile_expert, tm, n_groups):
        ctx.save_for_backward(x, w, tile_expert)
        ctx.tm, ctx.n_groups = tm, n_groups
        return _ragged(x, w, tile_expert, tm, "forward")

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_expert = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _ragged(dy.contiguous(), w, tile_expert, ctx.tm,
                         "backward")
        if ctx.needs_input_grad[1]:
            if ctx.n_groups is None:
                raise ValueError("ragged_gemm: the weight gradient needs the "
                                 "rows in equal expert groups (pass "
                                 "n_groups)")
            dw = ragged_gemm_dw(x, dy, ctx.n_groups)
        return dx, dw, None, None, None


def _ragged(x, w, tile_expert, tm, direction):
    """x @ w[e], or with ``direction="backward"`` x @ w[e]ᵀ (dX)."""
    if _backend(x, "ragged GEMM") == "cuda":
        return ragged_gemm_cuda(x, w, tile_expert, tm=tm, direction=direction)
    return ragged_gemm_plain(x, w, tile_expert, tm=tm,
                             transpose_w=direction == "backward")


def ragged_gemm(x: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
                *, tm: int = 128, n_groups: int | None = None
                ) -> torch.Tensor:
    """MoE grouped GEMM over tile-aligned groups: x (T, D) tokens sorted by
    expert with T % tm == 0, w (E, D, F), tile_expert (T // tm,) int32
    expert id per token tile. Returns (T, F) = x @ w[expert(token)] in x's
    dtype, fp32 accumulation. A misaligned T or a tile_expert of the
    wrong length raises (nothing is padded). Differentiable in x; in w
    where the rows form ``n_groups`` equal contiguous expert groups, in
    expert order (``moe_mlp``'s buffer: ``n_groups`` = E, known from the
    shapes, so ``tile_expert`` is never read back to the host)."""
    t0 = op_t0()
    backend = _backend(x, "ragged GEMM")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = _RaggedGemm.apply(x, w, tile_expert, tm, n_groups)
    else:
        out = _ragged(x, w, tile_expert, tm, "forward")
    op_record("ragged_gemm", out, x, w, tile_expert, t0_ns=t0,
              backend=backend)
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward with the row log-sum-exp; backward from it (the hand
    kernel on the card, the plain version's math on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, meta_len):
        if _backend(q, "attention") == "cuda":
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, return_lse=True,
                                            meta_len=meta_len)
        else:
            out, lse = flash_attention_plain_lse(q, k, v, causal=causal,
                                                 window=window,
                                                 meta_len=meta_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.meta_len = causal, window, meta_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        fn = flash_attention_bwd_cuda if _backend(q, "attention") == "cuda" \
            else flash_attention_bwd_plain
        dq, dk, dv = fn(q, k, v, out, do.contiguous(), lse,
                        causal=ctx.causal, window=ctx.window,
                        meta_len=ctx.meta_len)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    meta_len: int = 0) -> torch.Tensor:
    """Tiled online-softmax attention for LM prefill and training: q (B,
    Hq, S, D), k / v (B, Hkv, T, D), queries aligned to the end of the KV
    axis; ``window`` enables sliding-window masking, under which the first
    ``meta_len`` keys stay visible (attention sinks). The kernel takes
    contiguous operands, so strided views (the model's head transposes)
    are copied first. Differentiable in q, k and v."""
    t0 = op_t0()
    backend = _backend(q, "attention")
    if backend == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = _FlashAttention.apply(q, k, v, causal, window, meta_len)
    elif backend == "cuda":
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   meta_len=meta_len)
    else:
        out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    meta_len=meta_len)
    op_record("flash_attention", out, q, k, v, t0_ns=t0, causal=causal,
              window=window, meta_len=meta_len, backend=backend)
    return out


def gathered_ell_spmm(a: ELL, h_full: torch.Tensor,
                      src_ids: torch.Tensor) -> torch.Tensor:
    """``ell_spmm(a, h_full[src_ids])`` without copying the block's source
    rows: the local neighbour ids are composed with ``src_ids`` into
    global ids, and the ELL kernel gathers from ``h_full`` directly.
    Local sentinels, and ``src_ids`` pads (``num_nodes``), compose to the
    ``h_full.shape[0]`` sentinel, which the kernel skips and the plain
    version reads as a zero row. Sum semiring."""
    t0 = op_t0()
    n, n_src = h_full.shape[0], src_ids.shape[0]
    idx = a.idx.long()
    gid = src_ids[idx.clamp(0, max(n_src - 1, 0))].to(torch.int32)
    gid = torch.where((idx < n_src) & (gid < n), gid, n)
    glob = ELL(idx=gid, val=a.val, nrows=a.nrows, ncols=n, nse=a.nse)
    out = ell_spmm(glob, h_full)
    op_record("gathered_ell_spmm", out, a.idx, h_full, src_ids, t0_ns=t0)
    return out


def kernel_launches() -> dict[str, int]:
    """Launch count of each hand kernel's wrapper since the last reset."""
    return {name: fn.launches for name, fn in _CUDA_WRAPPERS.items()}


def reset_kernel_launches() -> None:
    """Zero every wrapper's launch count, its per-instance, per-direction
    or per-route counts where it keeps them (``launches_by_instance``,
    ``launches_by_direction``, the fused kernel's tiles by route
    ``route_tiles``) and SELL's largest workspace (``workspace_bytes``)."""
    for fn in _CUDA_WRAPPERS.values():
        fn.launches = 0
        for by in ("launches_by_instance", "launches_by_direction"):
            if hasattr(fn, by):
                setattr(fn, by, dict.fromkeys(getattr(fn, by), 0))
        if hasattr(fn, "route_tiles"):
            fn.route_tiles = None
        if hasattr(fn, "workspace_bytes"):
            fn.workspace_bytes = 0


def slot_gather(table: torch.Tensor, slots: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[slots[i]]`` where ``slots[i] >= 0`` (a cache hit),
    else ``rows[i]`` (the staged fallback row). Rows are copied, never
    recomputed, so a hit is bitwise the row it was filled from. Miss lanes
    are clamped before the gather so the table read stays in bounds."""
    t0 = op_t0()
    safe = slots.clamp(0, max(table.shape[0] - 1, 0)).long()
    out = torch.where((slots >= 0)[:, None], table[safe], rows)
    op_record("slot_gather", out, table, slots, rows, t0_ns=t0)
    return out


def table_insert(table: torch.Tensor, slots, rows: torch.Tensor
                 ) -> torch.Tensor:
    """``table[slots] = rows``, in place, returning ``table``. The
    reference donates the old buffer to a functional scatter; a torch
    tensor is updated in place with ``index_copy_`` instead, which is the
    same steady-state cost without the donation. ``slots`` is the host
    slot map's output (numpy or a CPU tensor); negative lanes are the
    "no insert" lanes and are dropped on the host before the scatter."""
    t0 = op_t0()
    slots = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor)
                       else slots)
    keep = slots >= 0
    if not keep.all():
        rows = rows[torch.from_numpy(keep).to(rows.device)]
        slots = slots[keep]
    if slots.size:
        index = torch.from_numpy(slots.astype(np.int64)).to(table.device)
        table.index_copy_(0, index, rows.to(table.dtype))
    op_record("table_insert", table, slots, rows, t0_ns=t0)
    return table
