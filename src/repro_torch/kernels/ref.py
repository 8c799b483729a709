"""Plain PyTorch references for the SpMM, SDDMM and FusedMM kernels of
this package, and the dense attention oracle of the LM side
(:func:`flash_attention_ref`).

These are the ground truth of the tests, the trusted path for any
(semiring, plan) point the hand kernels do not cover, and what the
dispatchers in :mod:`repro_torch.kernels.ops` run for tensors on the CPU.
Every gather is zero-filled for the ``idx == ncols`` sentinel.

The float scatters of the trusted reduce and of the transposes
(``coo_reduce`` over sum/mean, ``edge_weights``' softmax denominator,
``ell_transpose_reduce`` / ``sell_transpose_reduce``) take
``index_add_`` on the CPU, which is sequential, and on the card the
ordered segment sum of ``kernels/segment_sum`` (slots sorted stably by
target, no atomics), so that a card run repeats bit for bit.

The gathered message tensors are built in chunks (of edges, ELL rows,
SELL steps or BSR blocks) so that a full-neighbor block around a hub, or
a whole graph's tiles, never needs the whole ``(edges, K)`` or
``(nblocks, br, K)`` tensor at once. The edge-score paths (SDDMM and
FusedMM) chunk the same way: only per-edge scalars, ``(edges,)``, exist
whole.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels import segment_sum as kseg
from repro_torch.kernels.segment_sum import SegmentOrder

if TYPE_CHECKING:  # annotation-only
    from repro_torch.core.semiring import Semiring
    from repro_torch.core.sparse import BSR, COO, ELL, SELL

__all__ = ["coo_reduce", "spmm_coo_ref", "spmm_ell_ref", "spmm_sell_ref",
           "spmm_bsr_ref", "sell_packed_reduce", "take_rows",
           "ell_transpose_reduce", "sell_transpose_reduce",
           "ell_transpose_ordered", "sell_transpose_ordered", "edge_dots",
           "edge_weights", "sddmm_coo_ref", "sddmm_bsr_ref",
           "fusedmm_coo_ref", "fusedmm_softmax_ref", "bsr_tile_chunks",
           "flash_attention_ref"]

# gathered elements per chunk (fp32: 256 MiB of messages at a time)
_CHUNK_ELEMS = 1 << 26


def take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` with out-of-range ids (the sentinel) reading zero rows."""
    n = h.shape[0]
    valid = (idx >= 0) & (idx < n)
    if n == 0:
        return h.new_zeros(tuple(idx.shape) + tuple(h.shape[1:]))
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    out = h[safe]
    mask = valid.view(*valid.shape, *([1] * (h.dim() - 1)))
    return torch.where(mask, out, torch.zeros((), dtype=h.dtype,
                                              device=h.device))


def _rows_per_chunk(width: int, k: int) -> int:
    return max(1, _CHUNK_ELEMS // max(width * max(k, 1), 1))


def coo_reduce(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               n_valid: int, nrows: int, h: torch.Tensor, sr: "Semiring",
               degrees=None, order: SegmentOrder | None = None
               ) -> torch.Tensor:
    """out[i] = ⊕_{e < n_valid, row[e] = i} val[e] ⊗ h[col[e]] — the
    trusted segment path over triplets, in chunks of edges (entries from
    ``n_valid`` on are padding and take no part). Given ``order``, the
    stable sort of ``row[:n_valid]`` (a graph's cached one), a sum or mean
    on the card outside autograd takes the ordered segment sum: each row's
    edges in edge order, the same bits on every run. Otherwise (the
    unpatched baselines) the sum is ``index_add_``."""
    if order is not None and sr.reduce in ("sum", "mean") and \
            kseg.on_card(h) and not (torch.is_grad_enabled() and (
                h.requires_grad or val.requires_grad)):
        return sr.finalize(_ordered_sum(col, val, n_valid, h, sr, order),
                           degrees)
    k = h.shape[1]
    out = torch.full((nrows, k), sr.identity,
                     dtype=torch.promote_types(val.dtype, h.dtype),
                     device=h.device)
    step = _rows_per_chunk(1, k)
    for lo in range(0, n_valid, step):
        hi = min(lo + step, n_valid)
        msgs = sr.apply_combine(val[lo:hi, None], take_rows(h, col[lo:hi]))
        out = sr.reduce_into(out, msgs.to(out.dtype), row[lo:hi])
    return sr.finalize(out, degrees)


def _ordered_sum(col, val, n_valid, h, sr, order):
    """The sum of :func:`coo_reduce` on the card, each row's edges added
    in edge order: for combine ``mul`` / ``second`` one gather-scale-sum
    over the sorted edges (no message tensor), for ``add`` the messages
    chunk by chunk of the sorted edges."""
    dtype = torch.promote_types(val.dtype, h.dtype)
    if sr.combine == "add":
        out = kseg.chunked_sum(
            order, n_valid, h.shape[1],
            lambda e: sr.apply_combine(val[e, None], take_rows(h, col[e])),
            _rows_per_chunk(1, h.shape[1]))
    else:
        w = val[:n_valid] if sr.combine == "mul" else None
        out = kseg.gather_scale_sum(h, order, col[:n_valid], w)
    return out.to(dtype)


def spmm_coo_ref(a: "COO", h: torch.Tensor, sr: "Semiring",
                 degrees=None) -> torch.Tensor:
    """out[i] = ⊕_{(i,j) in A} A_ij ⊗ h[j] — the trusted segment path."""
    return coo_reduce(a.row, a.col, a.val, a.nse, a.nrows, h, sr, degrees)


def spmm_ell_ref(a: "ELL", h: torch.Tensor, sr: "Semiring",
                 degrees=None) -> torch.Tensor:
    k = h.shape[1]
    parts = []
    step = _rows_per_chunk(a.max_deg, k)
    for lo in range(0, a.nrows, step):
        idx, val = a.idx[lo: lo + step], a.val[lo: lo + step]
        msg = sr.apply_combine(val[:, :, None], take_rows(h, idx))
        valid = (idx < a.ncols)[:, :, None]
        if sr.reduce in ("sum", "mean"):
            parts.append(torch.where(valid, msg, 0.0).sum(dim=1))
        elif sr.reduce == "max":
            parts.append(torch.where(valid, msg, -torch.inf).amax(dim=1))
        else:
            parts.append(torch.where(valid, msg, torch.inf).amin(dim=1))
    out = torch.cat(parts) if parts else h.new_zeros((0, k))
    return sr.finalize(out, degrees)


def sell_packed_reduce(idx: torch.Tensor, val: torch.Tensor,
                       slice_of: torch.Tensor, nslices: int,
                       inv_perm: torch.Tensor, h: torch.Tensor
                       ) -> torch.Tensor:
    """The packed-slice SELL reduction on raw tensors: gather the
    ``(n_steps, C)`` neighbor table, segment-sum the steps into their
    slices' ``(C, K)`` accumulators, inverse-permute rows. Sentinel slots
    gather 0 and carry val == 0."""
    c, k = idx.shape[1], h.shape[1]
    acc = h.new_zeros((nslices, c, k), dtype=torch.float32)
    step = _rows_per_chunk(c, k)
    for lo in range(0, idx.shape[0], step):
        g = take_rows(h, idx[lo: lo + step]).float()
        msgs = val[lo: lo + step, :, None].float() * g
        acc.index_add_(0, slice_of[lo: lo + step].long(), msgs)
    return acc.reshape(nslices * c, k)[inv_perm.long()]


def spmm_sell_ref(a: "SELL", h: torch.Tensor) -> torch.Tensor:
    """Sum-semiring SELL-C-σ SpMM in fp32, rows in original order."""
    return sell_packed_reduce(a.idx, a.val, a.slice_of, a.nslices,
                              a.inv_perm, h)


def ell_transpose_reduce(a: "ELL", dout: torch.Tensor) -> torch.Tensor:
    """``Aᵀ @ dout`` for an ELL operand (the gradient of the sum-semiring
    ELL SpMM in ``h``): ``dh[idx[r, d]] += val[r, d] * dout[r]``, with
    ``index_add_`` in chunks of rows; sentinel slots land on a spare row
    that is dropped. On the card, :func:`ell_transpose_ordered`."""
    if kseg.on_card(dout):
        return ell_transpose_ordered(a, dout)
    k = dout.shape[1]
    dh = dout.new_zeros((a.ncols + 1, k), dtype=torch.float32)
    step = _rows_per_chunk(a.max_deg, k)
    for lo in range(0, a.nrows, step):
        idx = a.idx[lo: lo + step].long().clamp(0, a.ncols)
        msg = a.val[lo: lo + step, :, None].float() * \
            dout[lo: lo + step, None, :].float()
        dh.index_add_(0, idx.reshape(-1), msg.reshape(-1, k))
    return dh[: a.ncols]


def ell_transpose_ordered(a: "ELL", dout: torch.Tensor) -> torch.Tensor:
    """:func:`ell_transpose_reduce` as an ordered segment sum: the slots
    sorted stably by column on the device (static shapes), each column's
    slots summed in slot order, the same order as the sequential
    ``index_add_``."""
    order = kseg.segment_order(a.idx.reshape(-1), a.ncols)
    perm = order.perm
    return kseg.segment_sum_sorted(
        dout.float().contiguous(), order.offsets,
        index=torch.div(perm, a.idx.shape[1], rounding_mode="floor"),
        weight=a.val.reshape(-1).float().index_select(0, perm))


def _packed_dout(a: "SELL", dout: torch.Tensor) -> torch.Tensor:
    """``dout`` (original row order) moved to the packed rows."""
    packed = dout.new_zeros((a.nslices * a.c, dout.shape[1]),
                            dtype=torch.float32)
    packed[a.inv_perm.long()] = dout.float()
    return packed


def sell_transpose_reduce(a: "SELL", dout: torch.Tensor) -> torch.Tensor:
    """``Aᵀ @ dout`` for a SELL operand: ``dout`` (original row order) is
    moved to the packed positions, then every packed step scatters
    ``val * dout_packed[slice, lane]`` into ``dh[idx]`` in chunks of
    steps; sentinel slots land on a spare row that is dropped. On the
    card, :func:`sell_transpose_ordered`."""
    if kseg.on_card(dout):
        return sell_transpose_ordered(a, dout)
    k = dout.shape[1]
    packed = _packed_dout(a, dout).view(a.nslices, a.c, k)
    dh = dout.new_zeros((a.ncols + 1, k), dtype=torch.float32)
    step = _rows_per_chunk(a.c, k)
    for lo in range(0, a.n_steps, step):
        g = packed[a.slice_of[lo: lo + step].long()] * \
            a.val[lo: lo + step, :, None].float()
        idx = a.idx[lo: lo + step].long().clamp(0, a.ncols)
        dh.index_add_(0, idx.reshape(-1), g.reshape(-1, k))
    return dh[: a.ncols]


def sell_transpose_ordered(a: "SELL", dout: torch.Tensor) -> torch.Tensor:
    """:func:`sell_transpose_reduce` as an ordered segment sum over the
    packed slots sorted stably by column."""
    order = kseg.segment_order(a.idx.reshape(-1), a.ncols)
    perm = order.perm
    step = torch.div(perm, a.c, rounding_mode="floor")
    src_row = a.slice_of.index_select(0, step) * a.c + perm % a.c
    return kseg.segment_sum_sorted(
        _packed_dout(a, dout), order.offsets, index=src_row.to(torch.int32),
        weight=a.val.reshape(-1).float().index_select(0, perm))


def spmm_bsr_ref(a: "BSR", h: torch.Tensor) -> torch.Tensor:
    """Sum-semiring BSR SpMM in fp32 with the tiled kernel's block
    algorithm: gather h's block rows, a batched tile product, a segment sum
    into the block rows — in chunks of blocks, so ``(nblocks, br, K)``
    never exists at once. ``h`` may have fewer than ``a.ncols`` rows (the
    rest read as zero); the output has the padded ``a.nrows`` rows."""
    k = h.shape[1]
    h = h.float()
    if h.shape[0] < a.ncols:
        h = torch.cat([h, h.new_zeros((a.ncols - h.shape[0], k))])
    hb = h.view(a.ncols // a.bc, a.bc, k)
    out = h.new_zeros((a.n_block_rows, a.br, k))
    step = _rows_per_chunk(max(a.br, a.bc), k)
    for lo in range(0, a.nblocks, step):
        contrib = torch.bmm(a.blocks[lo: lo + step].float(),
                            hb[a.blk_col[lo: lo + step].long()])
        out.index_add_(0, a.blk_row[lo: lo + step].long(), contrib)
    return out.reshape(a.nrows, k)


# --------------------------------------------------------------------------
# SDDMM:  S_ij = (x_i · y_j) * A_ij   for (i,j) in sparsity(A)
# --------------------------------------------------------------------------

def edge_dots(x: torch.Tensor, y: torch.Tensor, row: torch.Tensor,
              col: torch.Tensor) -> torch.Tensor:
    """``sum(x[row] * y[col], -1)`` per edge, in chunks of edges (ids out
    of range read zero rows). Differentiable in ``x`` and ``y``."""
    step = _rows_per_chunk(1, x.shape[1])
    parts = [(take_rows(x, row[lo: lo + step]) *
              take_rows(y, col[lo: lo + step])).sum(-1)
             for lo in range(0, row.shape[0], step)]
    if not parts:
        return x.new_zeros((0,), dtype=torch.promote_types(x.dtype, y.dtype))
    return torch.cat(parts)


def sddmm_coo_ref(a: "COO", x: torch.Tensor, y: torch.Tensor,
                  scale_by_a: bool = True) -> torch.Tensor:
    """Per-edge scores ``(nnz_padded,)``, zero on padding entries.
    x: (N, D), y: (M, D)."""
    n = a.nse
    s = edge_dots(x, y, a.row[:n], a.col[:n])
    if scale_by_a:
        s = s * a.val[:n]
    return torch.cat([s, s.new_zeros((a.nnz_padded - n,))])


def _block_rows(t: torch.Tensor, n: int, b: int) -> torch.Tensor:
    """``t`` (at most ``n`` rows) as ``(n // b, b, width)`` fp32 blocks,
    the missing rows zero."""
    t = t.float()
    if t.shape[0] < n:
        t = torch.cat([t, t.new_zeros((n - t.shape[0], t.shape[1]))])
    return t.reshape(n // b, b, t.shape[1])


def bsr_tile_chunks(a: "BSR", x: torch.Tensor, y: torch.Tensor,
                    width: int):
    """Yield ``(lo, hi, s)`` over chunks of A's stored tiles: ``s`` is
    the ``(hi - lo, br, bc)`` fp32 score tiles ``X[row blk] @ Y[col
    blk]^T`` of tiles ``lo .. hi``. ``x`` and ``y`` may have fewer rows
    than ``a.nrows`` / ``a.ncols`` (the rest read zero); a chunk's
    gathers hold at most ~2^26 elements of rows ``width`` wide."""
    xb = _block_rows(x, a.nrows, a.br)
    yb = _block_rows(y, a.ncols, a.bc)
    step = _rows_per_chunk(max(a.br, a.bc), max(width, x.shape[1], 1))
    for lo in range(0, a.nblocks, step):
        hi = min(lo + step, a.nblocks)
        s = torch.bmm(xb[a.blk_row[lo:hi].long()],
                      yb[a.blk_col[lo:hi].long()].transpose(1, 2))
        yield lo, hi, s


def sddmm_bsr_ref(a: "BSR", x: torch.Tensor, y: torch.Tensor,
                  scale_by_a: bool = True) -> torch.Tensor:
    """Block scores ``(nblocks, br, bc)`` at every position of every
    stored tile, times the tile when ``scale_by_a``."""
    out = torch.empty((a.nblocks, a.br, a.bc), dtype=torch.float32,
                      device=x.device)
    for lo, hi, s in bsr_tile_chunks(a, x, y, x.shape[1]):
        out[lo:hi] = s * a.blocks[lo:hi] if scale_by_a else s
    return out


# --------------------------------------------------------------------------
# FusedMM: SDDMM -> edge nonlinearity -> SpMM
# --------------------------------------------------------------------------

def edge_weights(s: torch.Tensor, row_ids: torch.Tensor, nrows: int,
                 valid, edge_op: str, order: SegmentOrder | None = None
                 ) -> torch.Tensor:
    """Per-edge weights f(s) for a FusedMM edge op, zero on invalid
    entries (``valid`` None: every entry is real). Softmax normalizes
    over each row's neighborhood with segment ops; its max is detached —
    softmax is shift-invariant, so the derivative is exact without it.
    The denominators are a :func:`scatter_sum`: ordered on the card when
    ``order``, the stable sort of ``row_ids``, is given."""
    if edge_op == "softmax":
        sm = s if valid is None else torch.where(valid, s, -torch.inf)
        ids = row_ids.long()
        m = torch.full((nrows,), -torch.inf, dtype=s.dtype, device=s.device)
        m = m.scatter_reduce(0, ids, sm.detach(), "amax")
        m = torch.where(torch.isinf(m), 0.0, m)
        e = torch.exp(sm - m[ids])
        if valid is not None:
            e = torch.where(valid, e, 0.0)
        z = kseg.scatter_sum(e, row_ids, nrows, order)
        return e / torch.clamp(z, min=1e-30)[ids]
    if edge_op == "sigmoid":
        w = torch.sigmoid(s)
    elif edge_op == "none":
        w = s
    else:
        raise ValueError(edge_op)
    return w if valid is None else torch.where(valid, w, 0.0)


def fusedmm_coo_ref(a: "COO", x: torch.Tensor, y: torch.Tensor,
                    h: torch.Tensor, edge_op: str = "softmax"
                    ) -> torch.Tensor:
    """out[i] = Σ_j f(x_i·y_j) h_j over sparsity(A); f per ``edge_op``
    (softmax normalizes over each row's neighborhood). The per-edge
    scores and weights are ``(edges,)``; the ``(edges, D)`` and
    ``(edges, K)`` products are built in chunks. Differentiable."""
    from repro_torch.core.semiring import get_semiring
    n = a.nse
    row, col = a.row[:n], a.col[:n]
    w = edge_weights(edge_dots(x, y, row, col), row, a.nrows, None, edge_op)
    return coo_reduce(row, col, w, n, a.nrows, h, get_semiring("sum"))


def fusedmm_softmax_ref(a: "BSR", x: torch.Tensor, y: torch.Tensor,
                        h: torch.Tensor) -> torch.Tensor:
    """Block-sparse graph attention over A's tiles (mask: the tile entry
    is nonzero; padding tiles are all zero and mask out): the row max over
    a whole block row first, then the exponentials, denominators and
    ``e @ h`` tile products. Two passes over the tiles in chunks, the
    scores recomputed in the second. ``(a.nrows, K)`` fp32; a row with no
    unmasked entry is 0."""
    k = h.shape[1]
    hb = _block_rows(h, a.ncols, a.bc)
    m = torch.full((a.n_block_rows, a.br), -torch.inf, device=h.device)
    for lo, hi, s in bsr_tile_chunks(a, x, y, k):
        s = torch.where(a.blocks[lo:hi] != 0, s, -torch.inf)
        ids = a.blk_row[lo:hi].long()[:, None].expand(-1, a.br)
        m.scatter_reduce_(0, ids, s.amax(dim=2), "amax")
    m = torch.where(torch.isinf(m), 0.0, m)
    z = torch.zeros((a.n_block_rows, a.br), device=h.device)
    num = torch.zeros((a.n_block_rows, a.br, k), device=h.device)
    for lo, hi, s in bsr_tile_chunks(a, x, y, k):
        ids = a.blk_row[lo:hi].long()
        e = torch.where(a.blocks[lo:hi] != 0,
                        torch.exp(s - m[ids][:, :, None]), 0.0)
        z.index_add_(0, ids, e.sum(dim=2))
        num.index_add_(0, ids, torch.bmm(e, hb[a.blk_col[lo:hi].long()]))
    out = num / torch.clamp(z, min=1e-30)[:, :, None]
    return out.reshape(a.nrows, k)


# --------------------------------------------------------------------------
# Dense flash-attention oracle (LM side; causal / sliding-window)
# --------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, S, D), k/v: (B, Hkv, T, D); query positions end-aligned
    to the KV axis. GQA by head repetition, the whole (S, T) score matrix
    at once, softmax in fp32: the oracle, never a kernel's plain version."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    scale = scale if scale is not None else \
        1.0 / torch.sqrt(torch.tensor(float(d), dtype=q.dtype))
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, -torch.inf)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhst,bhtd->bhsd", w, v)
