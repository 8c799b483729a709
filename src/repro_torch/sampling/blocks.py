"""Plan-aware packing of sampled MFG blocks + the block SpMM dispatch.

A :class:`repro_torch.sampling.sampler.Block` is fresh numpy every batch;
:func:`pack_block` pads it to its *bucket* sizes (``buckets.py``) and packs
the adjacency in the format the autotuner picked for that bucket:

* **ELL** — fanout caps the row degree, so the neighbor table is a dense
  ``(n_dst, fanout)`` gather — the rectangular ``kernels/ops.ell_spmm``.
* **SELL-C-σ** — degree-sorted slices for blocks whose degree skew
  survives sampling; the step count is padded up the ladder with inert
  sentinel steps assigned to the last slice.
* **trusted** — local COO triplets + the real-edge count ``nnz_real``;
  also the only path for max/min aggregation and the un-patched baseline.

Packing is host-side and yields CPU tensors;
:func:`repro_torch.core.sparse.to_device` moves a packed block to the
device that runs the model (the device sampler,
``sampling/device_graph.py``, builds its blocks on the device instead).
Plans are chosen once per bucket by :class:`BlockPlanCache`
(consulting/persisting ``TuningDB`` rows under a ``block...`` string
key; measured on the card with ``measure=True``).

:func:`block_spmm` is differentiable in ``h`` on every plan: the ELL and
SELL kernels sit in a ``torch.autograd.Function`` whose backward is the
transpose scatter ``dh[col] += val * dout[row]``
(``kernels/ref.ell_transpose_reduce`` / ``sell_transpose_reduce``). On
the card the trusted path is a ``torch.autograd.Function`` too: its sum
and mean are the ordered segment sum over the block's rows, its backward
the ordered sum over the block's columns (both sorted on the device,
static shapes, no host sync), and max / min route the gradient to the
first edge attaining the extremum, summed in the same column order. So
every plan's backward on the card is an ordered segment sum
(``kernels/segment_sum``, no atomics) and a step repeats bit for bit. On
the CPU the transposes and the trusted path (plain autograd) are
sequential ``index_add_``. The reference gets this gradient from plain
AD of its XLA path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import sparse as sp
from repro_torch.core.autotune import KernelPlan, TuningDB, autotune
from repro_torch.core.patch import is_patched
from repro_torch.core.semiring import Semiring, get_semiring
from repro_torch.core.spmm import _backward_maxmin
from repro_torch.kernels import ops as kops
from repro_torch.kernels import segment_sum as kseg
from repro_torch.kernels.ref import (coo_reduce, ell_transpose_reduce,
                                     sell_transpose_reduce, take_rows)
from repro_torch.sampling.buckets import round_bucket
from repro_torch.sampling.sampler import Block

__all__ = ["PackedBlock", "pack_block", "BlockPlanCache", "block_spmm",
           "block_spmm_baseline", "block_spmm_global", "gather_rows"]


@dataclasses.dataclass(frozen=True)
class PackedBlock:
    """Bucket-padded bipartite block.

    Padding conventions: ``src_ids`` pads with ``num_nodes`` (out of range
    -> zero row on gather); ``col`` pads with ``n_src``; ``row`` pads with
    ``n_dst - 1`` and ``val`` with 0 (inert under sum); ``dst_pos`` pads
    with ``n_src`` (zero row on the self-term gather). A block of the
    device sampler keeps ``n_dst_real`` as a device scalar (reading it
    would wait for the device) and ``nnz_real`` at its capacity.
    """

    src_ids: torch.Tensor     # (n_src,) int32 global ids of source rows
    dst_pos: torch.Tensor     # (n_dst,) int32 position of each dst among sources
    row: torch.Tensor         # (nnz,) int32 local dst ids
    col: torch.Tensor         # (nnz,) int32 local src ids
    val: torch.Tensor         # (nnz,) float edge values
    degrees: torch.Tensor     # (n_dst,) float32 sampled in-degrees
    ell: Optional[sp.ELL]
    sell: Optional[sp.SELL]
    n_dst_real: int | torch.Tensor    # real destination count
    nnz_real: int             # real edge count
    n_dst: int
    n_src: int
    plan_kind: str

    @property
    def nnz(self) -> int:
        return self.row.shape[0]

    @property
    def bucket_signature(self) -> tuple:
        """The shape key of this block's bucket."""
        sig = (self.n_dst, self.n_src, self.nnz, self.plan_kind)
        if self.sell is not None:
            sig += (self.sell.n_steps, self.sell.c, self.sell.sigma)
        if self.ell is not None:
            sig += (self.ell.max_deg,)
        return sig


def _pad_sell_steps(s: sp.SELL, n_steps: int) -> sp.SELL:
    """Pad a SELL's packed-step axis up to the bucket's count. Sentinel
    steps carry idx == ncols and val == 0, are owned by the last slice and
    are never a first_step."""
    pad = n_steps - s.n_steps
    assert pad >= 0, (s.n_steps, n_steps)
    if pad == 0:
        return s
    idx = np.pad(sp._np(s.idx), ((0, pad), (0, 0)), constant_values=s.ncols)
    val = np.pad(sp._np(s.val), ((0, pad), (0, 0)))
    slice_of = np.pad(sp._np(s.slice_of), (0, pad),
                      constant_values=s.nslices - 1)
    first = np.pad(sp._np(s.first_step), (0, pad))
    return dataclasses.replace(
        s, idx=torch.from_numpy(idx), val=torch.from_numpy(val),
        slice_of=torch.from_numpy(slice_of),
        first_step=torch.from_numpy(first))


def _i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int32))


def pack_block(block: Block, *, n_dst: int, n_src: int, nnz: int,
               plan: KernelPlan, ell_width: int | None = None,
               sell_steps: int | None = None) -> PackedBlock:
    """Pad ``block`` to the bucket sizes and pack per ``plan`` (CPU).

    ``ell_width`` (ELL plans) is the static neighbor-table width; the
    SELL step count is rounded up the geometric ladder from
    ``sell_steps``."""
    assert block.n_dst <= n_dst and block.n_src <= n_src, \
        (block.n_dst, n_dst, block.n_src, n_src)
    assert block.nnz <= nnz, (block.nnz, nnz)
    nn = block.num_nodes

    src_ids = np.full(n_src, nn, np.int64)
    src_ids[: block.n_src] = block.src_ids
    dst_pos = np.full(n_dst, n_src, np.int64)
    dst_pos[: block.n_dst] = np.arange(block.n_dst)

    row = np.full(nnz, max(n_dst - 1, 0), np.int64)
    col = np.full(nnz, n_src, np.int64)
    val = np.zeros(nnz, np.asarray(block.val).dtype
                   if block.val.size else np.float32)
    row[: block.nnz] = block.row
    col[: block.nnz] = block.col
    val[: block.nnz] = block.val

    degrees = np.zeros(n_dst, np.float32)
    degrees[: block.n_dst] = block.degrees()

    local = sp.COO(row=np.asarray(block.row, np.int64),
                   col=np.asarray(block.col, np.int64),
                   val=np.asarray(block.val), nrows=n_dst, ncols=n_src,
                   nse=block.nnz)

    # the packed containers' ``nse`` is the bucket's edge capacity, as in
    # the reference (the kernels never read it; pads are sentinel-inert)
    ell = sell = None
    if plan.wants_ell:
        width = ell_width if ell_width is not None else \
            int(block.degrees().max()) if block.n_dst else 1
        ell = dataclasses.replace(
            sp.ell_from_coo(local, max_deg=max(width, 1)), nse=nnz)
    elif plan.wants_sell:
        sell = sp.sell_from_coo(local, c=plan.sell_c, sigma=plan.sell_sigma)
        sell = _pad_sell_steps(
            sell, round_bucket(sell.n_steps, base=sell_steps or 64))
        sell = dataclasses.replace(sell, nse=nnz)

    return PackedBlock(
        src_ids=_i32(src_ids), dst_pos=_i32(dst_pos), row=_i32(row),
        col=_i32(col), val=torch.from_numpy(val),
        degrees=torch.from_numpy(degrees), ell=ell, sell=sell,
        n_dst_real=int(block.n_dst), nnz_real=int(block.nnz),
        n_dst=n_dst, n_src=n_src, plan_kind=plan.kind)


# --------------------------------------------------------------------------
# Per-bucket plan selection
# --------------------------------------------------------------------------

class BlockPlanCache:
    """One :func:`repro_torch.core.autotune.autotune` decision per (bucket
    shape, K, semiring), persisted via ``TuningDB`` string keys. BSR is
    excluded from the sweep (``tile_candidates=()``): a sampled bipartite
    block has no dense tiles and ``PackedBlock`` does not carry the
    format. A plan found in ``db`` is used as it is, which is how a caller
    pins a plan.

    ``measure=True`` times each bucket's candidates on ``device`` (the
    card unless the caller asks for ``"cpu"``) over the bucket's first
    block; its rows persist under the key plus the device kind
    (``TuningDB.measured_key``)."""

    def __init__(self, *, semiring: str = "sum", tune: bool = True,
                 measure: bool = False, db: Optional[TuningDB] = None,
                 device="cuda"):
        self.semiring = semiring
        self.tune = tune
        self.measure = measure
        self.db = db
        self.device = device
        self._plans: dict[tuple, KernelPlan] = {}

    @staticmethod
    def key(n_dst: int, n_src: int, nnz: int, k: int, semiring: str) -> str:
        return f"block{n_dst}x{n_src}nse{nnz}k{k}sr{semiring}"

    def _row_device(self):
        return self.device if self.measure else None

    def will_measure(self, *, n_dst: int, n_src: int, nnz: int,
                     k_hint: int, sell_ok: bool = True) -> bool:
        """True iff :meth:`plan_for` on this bucket would time kernels:
        measuring, tuning, and the plan neither cached nor in the DB."""
        ck = (n_dst, n_src, nnz, k_hint, self.semiring, sell_ok)
        if not (self.measure and self.tune) or ck in self._plans:
            return False
        skey = self.key(*ck[:5]) + ("" if sell_ok else "nosell")
        return self.db is None or \
            self.db.get_key(skey, device=self._row_device()) is None

    def plan_for(self, block: Block, *, n_dst: int, n_src: int, nnz: int,
                 k_hint: int, sell_ok: bool = True) -> KernelPlan:
        """The plan of ``block``'s bucket: cached, else from the DB, else
        swept (``tune``; measured over ``block`` when ``measure``) or
        trusted. ``sell_ok=False`` restricts the sweep to ELL/trusted, for
        the device sampler, whose packing cannot build the degree-sorted
        SELL layout; such plans cache and persist under their own key."""
        ck = (n_dst, n_src, nnz, k_hint, self.semiring, sell_ok)
        plan = self._plans.get(ck)
        if plan is not None:
            return plan
        skey = self.key(*ck[:5]) + ("" if sell_ok else "nosell")
        source = None
        if self.db is not None:
            plan = self.db.get_key(skey, device=self._row_device())
            source = "db" if plan is not None else None
        if plan is None:
            if self.tune and block.nnz:
                rep = sp.COO(row=np.asarray(block.row, np.int64),
                             col=np.asarray(block.col, np.int64),
                             val=np.asarray(block.val), nrows=n_dst,
                             ncols=n_src, nse=block.nnz)
                plan = autotune(rep, k_hint, measure=self.measure,
                                semiring_reduce=self.semiring,
                                tile_candidates=(),
                                sell_candidates=None if sell_ok else (),
                                device=self.device)
                source = "measure" if self.measure else "sweep"
            else:
                plan = KernelPlan.trusted(k_hint)
                source = "untuned"
            if self.db is not None:
                self.db.put_key(skey, plan, device=self._row_device())
                self.db.save()
        self._plans[ck] = plan
        if obs.enabled():
            obs.instant("tuning.plan", site="block_plan_cache", key=skey,
                        source=source, kind=plan.kind)
        return plan

    def plans(self) -> dict:
        """The plans chosen so far, keyed ``(n_dst, n_src, nnz, k_hint,
        semiring, sell_ok)``."""
        return dict(self._plans)

    def kinds(self) -> tuple:
        """Distinct kernel kinds chosen so far (sorted, for reporting)."""
        return tuple(sorted({p.kind for p in self._plans.values()}))


# --------------------------------------------------------------------------
# Block SpMM dispatch (registered as the 'block_spmm' op)
# --------------------------------------------------------------------------

def _trusted_reduce(pb: PackedBlock, h: torch.Tensor,
                    sr: Semiring) -> torch.Tensor:
    """Segment reduce over the local COO triplets; pads past ``nnz_real``
    take no part (the reference fills them with the identity)."""
    return coo_reduce(pb.row, pb.col, pb.val, pb.nnz_real, pb.n_dst, h, sr,
                      pb.degrees)


class _TrustedSpMM(torch.autograd.Function):
    """The trusted path over a packed block on the card, before
    :meth:`Semiring.finalize`. Sum / mean: the ordered segment sum over
    the block's real edges sorted by row (each row's edges in edge
    order); the backward ``dh[col] = Σ val · dout[row]`` (``val`` left
    out unless combine is ``mul``) the ordered sum over them sorted by
    column. Max / min: ``scatter_reduce`` (order-free) forward, the
    first-edge subgradient backward, its scatter ordered by column. The
    sorts run on the device (static shapes, no host sync)."""

    @staticmethod
    def forward(ctx, h, pb, sr):
        n = pb.nnz_real
        ctx.pb, ctx.sr, ctx.n_h = pb, sr, h.shape[0]
        if sr.reduce in ("sum", "mean"):
            order = kseg.segment_order(pb.row[:n], pb.n_dst,
                                       sources=pb.col[:n])
            return coo_reduce(pb.row, pb.col, pb.val, n, pb.n_dst, h,
                              get_semiring("sum", sr.combine), order=order)
        out = coo_reduce(pb.row, pb.col, pb.val, n, pb.n_dst, h, sr)
        ctx.save_for_backward(h, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        pb, sr, n = ctx.pb, ctx.sr, ctx.pb.nnz_real
        order = kseg.segment_order(pb.col[:n], ctx.n_h, sources=pb.row[:n])
        dout = dout.contiguous()
        if sr.reduce in ("sum", "mean"):
            back = get_semiring("sum", "mul" if sr.combine == "mul"
                                else "second")
            dh = coo_reduce(pb.col, pb.row, pb.val, n, ctx.n_h, dout, back,
                            order=order)
        else:
            h, out = ctx.saved_tensors
            local = sp.COO(row=pb.row, col=pb.col, val=pb.val,
                           nrows=pb.n_dst, ncols=ctx.n_h, nse=n)
            dh = _backward_maxmin(local, order, h, out, dout, sr)
        return dh.to(dout.dtype), None, None


class _PackedSpMM(torch.autograd.Function):
    """Sum-semiring SpMM over a packed ELL or SELL block through its hand
    kernel; the backward is the transpose scatter into ``dh`` (nothing
    when ``h`` needs no gradient)."""

    @staticmethod
    def forward(ctx, h, a, kind):
        ctx.a, ctx.kind = a, kind
        return kops.ell_spmm(a, h) if kind == "ell" else kops.sell_spmm(a, h)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        back = ell_transpose_reduce if ctx.kind == "ell" else \
            sell_transpose_reduce
        return back(ctx.a, dout.contiguous()), None, None


def block_spmm(pb: PackedBlock, h: torch.Tensor, reduce: str = "mean",
               combine: str = "mul") -> torch.Tensor:
    """out[i,:] = ⊕_{j in sampled N(i)} (A_ij ⊗ h[j,:]) over one block.

    The tuned path: the bucket's plan routes sum/mean through the packed
    ELL/SELL kernels (``kernels/ops``), mean dividing by the sampled
    degree; anything else takes the trusted segment path (on the card,
    ordered segment sums forward and backward). Differentiable in ``h``
    on every plan."""
    sr = get_semiring(reduce, combine)
    t0 = obs.op_t0()
    if pb.plan_kind == "ell" and pb.ell is not None and sr.mxu_eligible:
        out = _PackedSpMM.apply(h, pb.ell, "ell")
    elif pb.plan_kind == "sell" and pb.sell is not None and sr.mxu_eligible:
        out = _PackedSpMM.apply(h, pb.sell, "sell")
    else:
        out = sr.finalize(_TrustedSpMM.apply(h, pb, sr), pb.degrees) \
            if kseg.on_card(h) else _trusted_reduce(pb, h, sr)
        out = out.to(h.dtype)
        obs.op_record("block_spmm", out, h, t0_ns=t0, plan="trusted",
                      reduce=reduce)
        return out
    if sr.reduce == "mean":
        out = out * (1.0 / torch.clamp(pb.degrees, min=1.0))[:, None]
    out = out.to(h.dtype)
    obs.op_record("block_spmm", out, h, t0_ns=t0, plan=pb.plan_kind,
                  reduce=reduce)
    return out


def block_spmm_baseline(pb: PackedBlock, h: torch.Tensor,
                        reduce: str = "mean",
                        combine: str = "mul") -> torch.Tensor:
    """The un-patched path: always the trusted segment ops under plain
    autograd (``index_add_`` on the card too: the yardstick launches no
    kernel)."""
    sr = get_semiring(reduce, combine)
    return _trusted_reduce(pb, h, sr).to(h.dtype)


def gather_rows(h_full: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Zero-filled row gather (out-of-range ids -> 0 rows)."""
    return take_rows(h_full, ids)


def block_spmm_global(pb: PackedBlock, h_full: torch.Tensor,
                      reduce: str = "mean",
                      combine: str = "mul") -> torch.Tensor:
    """Block SpMM whose dense operand is the *full* node-feature matrix
    (layer-wise inference): patched ELL plans compose the block's source
    ids into the neighbour table (``kernels/ops.gathered_ell_spmm``), so
    the block's source rows are never copied out; other plans gather then
    dispatch; un-patched, the trusted path."""
    sr = get_semiring(reduce, combine)
    if (is_patched() and pb.plan_kind == "ell" and pb.ell is not None
            and sr.mxu_eligible):
        out = kops.gathered_ell_spmm(pb.ell, h_full, pb.src_ids)
        if sr.reduce == "mean":
            out = out * (1.0 / torch.clamp(pb.degrees, min=1.0))[:, None]
        return out.to(h_full.dtype)
    h_src = gather_rows(h_full, pb.src_ids)
    fn = block_spmm if is_patched() else block_spmm_baseline
    return fn(pb, h_src, reduce, combine)
