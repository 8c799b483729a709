"""Distributed GNN message passing, 1-D: the adjacency in contiguous row
bands, one a rank, and the halo'd banded SpMM (``src/repro/dist/gnn.py``).

The 2-D vertex cut is :mod:`repro_torch.dist.gnn2d`. Each band's layout
follows the kernel plan, as in the reference:

* ``kind == 'ell'`` (the default and the trusted plan): per-row padded
  neighbour lists, every band padded to the graph's largest degree;
* ``kind == 'sell'`` (a SELL-C-σ plan): each band degree-sorted and
  packed into slices of C rows (σ = the band), the bands padded to one
  step count with sentinel steps.

:func:`build_dist_graph` builds the reference's host arrays, every band
stacked (bitwise the reference's). The reference then runs one step
under ``shard_map``; the port runs one process a rank, and each rank
takes only its own band to its device (:meth:`DistGraph.band`,
:meth:`DistGraph.local`): a :class:`Band`, the kernel's ELL or SELL
operand over **global** column ids (sentinel ``ncols``, as in
``core/sparse.py``) without the stacking's pad steps, the band's
cached 1/deg and its slots' stable sort by column. :func:`build_band`
builds one band alone, the same bits.

:func:`distributed_spmm` is one step of A @ H on a rank: H arrives
row-sharded over the partition axis (:func:`shard_rows`), the halo is
the ``all_gather`` of it, then the band's SpMM is the hand ELL or SELL
kernel (``kernels.ops``; their plain versions on the CPU). It is
differentiable in H: the band's backward is its transpose as an ordered
segment sum over the band's cached column order (``kernels/segment_sum``,
the hand kernel on the card), then the gather's backward, a
``psum_scatter``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import sparse as sp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.cache import CachedGraph
from repro_torch.dist.collectives import all_gather
from repro_torch.kernels import ops as kops
from repro_torch.kernels import segment_sum as kseg

__all__ = ["DistGraph", "Band", "Bands", "build_dist_graph", "build_band",
           "distributed_spmm", "comm_volume", "shard_rows", "ell_piece",
           "sell_piece", "SlotSpMM"]


@dataclasses.dataclass(frozen=True)
class DistGraph:
    """Row-banded adjacency, every band stacked over the partition axis
    (host tensors; the reference's layout).

    ELL layout (``kind == 'ell'``): ``idx`` / ``val`` are ``(parts,
    rows_per_part, max_deg)`` with the pad sentinel ``idx == ncols``;
    ``slice_of`` / ``inv_perm`` are None. SELL layout (``kind ==
    'sell'``): ``idx`` / ``val`` are ``(parts, n_steps, C)`` packed
    degree-major per band (bands padded to a common step count with
    sentinel steps of slice 0); ``slice_of`` is ``(parts, n_steps)`` and
    ``inv_perm`` ``(parts, rows_per_part)`` maps each band-local row to
    its sorted position. Column ids are global in both layouts;
    ``inv_deg`` is ``(parts, rows_per_part)``, 1/deg cached for the mean.
    Rows past ``nrows`` (the partition's padding) are empty."""

    idx: torch.Tensor
    val: torch.Tensor
    inv_deg: torch.Tensor
    slice_of: Optional[torch.Tensor]
    inv_perm: Optional[torch.Tensor]
    nrows: int
    ncols: int
    parts: int
    rows_per_part: int
    kind: str = "ell"
    sell_c: int = 8

    @property
    def max_deg(self) -> int:
        if self.kind != "ell":
            raise ValueError("max_deg is an ELL-layout property")
        return self.idx.shape[-1]

    @property
    def n_steps(self) -> int:
        if self.kind != "sell":
            raise ValueError("n_steps is a SELL-layout property")
        return self.idx.shape[1]

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def band(self, p: int, device="cuda") -> "Band":
        """Band ``p`` alone, on ``device``, as the kernel's operand."""
        if self.kind == "sell":
            op = sell_piece(self.idx[p], self.val[p], self.slice_of[p],
                            self.inv_perm[p], self.ncols, self.sell_c)
        else:
            op = ell_piece(self.idx[p], self.val[p], self.ncols)
        return Band.make(op, self.inv_deg[p], p, device)

    def local(self, mesh) -> "Band":
        """This rank's band (its index on the partition axis) on its
        device."""
        return self.band(mesh.index(_partition_axis(mesh)), mesh.device)


def ell_piece(idx: torch.Tensor, val: torch.Tensor, ncols: int) -> sp.ELL:
    """An ELL band or tile of a stacked layout as the kernel's operand."""
    idx = idx.to(torch.int32).contiguous()
    return sp.ELL(idx=idx, val=val.float().contiguous(),
                  nrows=idx.shape[0], ncols=ncols,
                  nse=int((idx < ncols).sum()))


def sell_piece(idx: torch.Tensor, val: torch.Tensor, slice_of: torch.Tensor,
               inv_perm: torch.Tensor, ncols: int, c: int) -> sp.SELL:
    """A SELL band or tile of a stacked layout as the kernel's operand:
    the stacking's pad steps (sentinels attributed to slice 0, after the
    last slice's steps) dropped, so ``slice_of`` is monotone again, and
    ``perm`` / ``first_step`` rebuilt from ``inv_perm`` / ``slice_of``."""
    rows = inv_perm.shape[0]
    nslices = rows // c
    sof = slice_of.to(torch.int32)
    if nslices > 1:     # the pad steps follow the last slice's
        own = int(torch.nonzero(sof == nslices - 1).max()) + 1
    else:               # one slice: its steps are its widest row's
        real = torch.nonzero((idx < ncols).any(1))
        own = int(real.max()) + 1 if real.numel() else 1
    idx = idx[:own].to(torch.int32).contiguous()
    sof = sof[:own].contiguous()
    perm = torch.empty_like(inv_perm, dtype=torch.int32)
    perm[inv_perm.long()] = torch.arange(rows, dtype=torch.int32)
    first = torch.ones_like(sof)
    first[1:] = (sof[1:] != sof[:-1]).to(torch.int32)
    return sp.SELL(idx=idx, val=val[:own].float().contiguous(),
                   slice_of=sof, first_step=first, perm=perm,
                   inv_perm=inv_perm.to(torch.int32).contiguous(),
                   nrows=rows, ncols=ncols, nse=int((idx < ncols).sum()),
                   c=c, sigma=0, nslices=nslices)


def _slot_rows(op) -> torch.Tensor:
    """Each slot's row (in original row order), flattened like ``idx``."""
    if isinstance(op, sp.SELL):
        pos = op.slice_of.long()[:, None] * op.c + \
            torch.arange(op.c, device=op.idx.device)[None, :]
        return op.perm[pos].reshape(-1).to(torch.int32)
    return torch.arange(op.nrows, dtype=torch.int32, device=op.idx.device
                        ).repeat_interleave(op.max_deg)


@dataclasses.dataclass(frozen=True)
class Band:
    """A rank's piece of a distributed adjacency on its device: ``op``
    the ELL or SELL operand of the hand kernels (``op.ncols`` columns,
    the sentinel ``op.ncols``) and ``inv_deg`` its rows' 1/deg. Built on
    first use, on the piece's device, and kept: ``rows`` / ``cols``,
    each slot's row and column (flattened like ``op.idx``), and the
    slots' stable sorts by column (``col_order``, gathering rows: the
    transpose, for the backward) and by row (``row_order``, gathering
    columns: FusedMM). A forward SpMM builds none of them."""

    op: Union[sp.ELL, sp.SELL]
    inv_deg: torch.Tensor
    index: int

    @staticmethod
    def make(op, inv_deg: torch.Tensor, index: int, device) -> "Band":
        return Band(op=sp.to_device(op, device), inv_deg=inv_deg.to(device),
                    index=index)

    @functools.cached_property
    def rows(self) -> torch.Tensor:
        return _slot_rows(self.op)

    @property
    def cols(self) -> torch.Tensor:
        return self.op.idx.reshape(-1)

    @functools.cached_property
    def col_order(self) -> kseg.SegmentOrder:
        return kseg.segment_order(self.cols, self.op.ncols, sources=self.rows)

    @functools.cached_property
    def row_order(self) -> kseg.SegmentOrder:
        return kseg.segment_order(self.rows, self.op.nrows, sources=self.cols)

    @property
    def weight(self) -> torch.Tensor:
        return self.op.val.reshape(-1)

    def with_values(self, w: torch.Tensor):
        """``op`` with the slots' values replaced by ``w`` (flat)."""
        return dataclasses.replace(self.op, val=w.reshape(
            self.op.idx.shape).float().contiguous())


def _spmm(op, h: torch.Tensor) -> torch.Tensor:
    """``op @ h``: the hand ELL or SELL kernel on the card, its plain
    version on the CPU (``kernels.ops``)."""
    h = h.float().contiguous()
    if isinstance(op, sp.SELL):
        return kops.sell_spmm(op, h)
    return kops.ell_spmm(op, h)


class SlotSpMM(torch.autograd.Function):
    """``out = piece(w) @ h``: the piece's SpMM with the slots' values
    ``w`` (flat, in slot order). Backward: ``dh`` the transpose as an
    ordered segment sum over the piece's column order (kernel S on the
    card), ``dw`` each slot's ``dout[row] · h[col]`` (kernel E)."""

    @staticmethod
    def forward(ctx, w, h, piece):
        ctx.piece = piece
        ctx.save_for_backward(w, h)
        return _spmm(piece.with_values(w.detach()), h)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.edge_dots import edge_dots
        w, h = ctx.saved_tensors
        piece = ctx.piece
        dout = dout.float().contiguous()
        dw = dh = None
        if ctx.needs_input_grad[0]:
            dw = edge_dots(dout, h, piece.rows, piece.cols)
        if ctx.needs_input_grad[1]:
            dh = kseg.gather_scale_sum(dout, piece.col_order, w.detach())
            dh = dh.to(h.dtype)
        return dw, dh, None


def _band_coo(row, col, val, lo: int, hi: int, nrows_band: int,
              ncols: int) -> sp.COO:
    m = (row >= lo) & (row < hi)
    return sp.coo_from_edges(col[m], row[m] - lo, val[m],
                             nrows=nrows_band, ncols=ncols)


def _host_graph(a):
    """(COO, float32 degrees, plan) of a COO or a CachedGraph; a COO
    takes the trusted plan (ELL bands), as the reference's untuned
    cached graph does."""
    if isinstance(a, CachedGraph):
        return a.coo, a.degrees.cpu().numpy().astype(np.float32), a.plan
    if isinstance(a, sp.COO):
        row = a.row[: a.nse].cpu().numpy()
        deg = np.bincount(row, minlength=a.nrows).astype(np.float32)
        return a, deg, KernelPlan.trusted()
    raise TypeError(f"a COO or a CachedGraph, got {type(a).__name__}")


def _t(x: np.ndarray, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))


def build_dist_graph(a: Union[sp.COO, CachedGraph], num_parts: int,
                     plan: Optional[KernelPlan] = None) -> DistGraph:
    """The one-time host partition into ``num_parts`` row bands (every
    band's structure is built here, never in a step). The layout follows
    ``plan`` (an explicit one wins; else a CachedGraph's plan; else ELL):
    a SELL plan packs each band degree-sorted, anything else keeps the
    rectangular ELL band."""
    coo, deg, own_plan = _host_graph(a)
    plan = own_plan if plan is None else plan
    nrows, ncols = coo.nrows, coo.ncols
    row = coo.row[: coo.nse].cpu().numpy()
    col = coo.col[: coo.nse].cpu().numpy()
    val = coo.val[: coo.nse].cpu().numpy()
    if plan.wants_sell:
        return _build_dist_sell(row, col, val, deg, nrows, ncols, num_parts,
                                c=plan.sell_c)

    rp = -(-nrows // num_parts)                   # rows per band, padded
    counts = np.bincount(row, minlength=nrows)
    max_deg = max(int(counts.max()) if counts.size else 1, 1)
    idxs, vals, invs = [], [], []
    for p in range(num_parts):
        lo, hi = p * rp, min((p + 1) * rp, nrows)
        n_loc = max(hi - lo, 0)          # trailing bands can be empty
        if n_loc:
            ell = sp.ell_from_coo(_band_coo(row, col, val, lo, hi, n_loc,
                                            ncols), max_deg=max_deg)
            idx_p, val_p = ell.idx.numpy(), ell.val.numpy()
        else:
            idx_p = np.empty((0, max_deg), np.int32)
            val_p = np.empty((0, max_deg), val.dtype)
        pad = rp - n_loc
        idxs.append(np.pad(idx_p, ((0, pad), (0, 0)), constant_values=ncols))
        vals.append(np.pad(val_p, ((0, pad), (0, 0))))
        d = np.pad(deg[lo:lo + n_loc], (0, pad), constant_values=1.0)
        invs.append(1.0 / np.maximum(d, 1.0))
    return DistGraph(idx=_t(np.stack(idxs), np.int32), val=_t(np.stack(vals)),
                     inv_deg=_t(np.stack(invs), np.float32), slice_of=None,
                     inv_perm=None, nrows=nrows, ncols=ncols, parts=num_parts,
                     rows_per_part=rp, kind="ell")


def _build_dist_sell(row, col, val, deg, nrows: int, ncols: int,
                     num_parts: int, c: int) -> DistGraph:
    """SELL bands: each band degree-sorted and slice-packed (σ = the
    band), then every band padded to one step count with sentinel steps
    so they stack over the partition axis."""
    rp = -(-nrows // num_parts)
    rp = -(-rp // c) * c                 # a multiple of C: no slice straddles
    bands = []
    for p in range(num_parts):
        lo, hi = p * rp, min((p + 1) * rp, nrows)
        # rp rows a band; rows past hi have degree 0 and sort to their
        # slices' tails, like sell_from_coo's row padding
        bands.append(sp.sell_from_coo(_band_coo(row, col, val, lo,
                                                max(hi, lo), rp, ncols),
                                      c=c, sigma=0))
    n_steps = max(b.n_steps for b in bands)
    idxs, vals, sofs, invps, invs = [], [], [], [], []
    for p, b in enumerate(bands):
        pad = n_steps - b.n_steps
        # sentinel pad steps: no neighbours, attributed to slice 0 (add 0)
        idxs.append(np.pad(b.idx.numpy(), ((0, pad), (0, 0)),
                           constant_values=ncols))
        vals.append(np.pad(b.val.numpy(), ((0, pad), (0, 0))))
        sofs.append(np.pad(b.slice_of.numpy(), (0, pad)))
        invps.append(b.inv_perm.numpy())
        lo = p * rp
        d = np.zeros(rp, np.float32)
        n_loc = max(min((p + 1) * rp, nrows) - lo, 0)
        d[:n_loc] = deg[lo: lo + n_loc]
        invs.append(1.0 / np.maximum(d, 1.0))
    return DistGraph(idx=_t(np.stack(idxs), np.int32), val=_t(np.stack(vals)),
                     inv_deg=_t(np.stack(invs), np.float32),
                     slice_of=_t(np.stack(sofs), np.int32),
                     inv_perm=_t(np.stack(invps), np.int32),
                     nrows=nrows, ncols=ncols, parts=num_parts,
                     rows_per_part=rp, kind="sell", sell_c=c)


@dataclasses.dataclass(frozen=True)
class Bands:
    """The geometry of a partition into row bands (the scalar fields of
    :class:`DistGraph`): what :func:`comm_volume` reads."""

    nrows: int
    ncols: int
    parts: int
    rows_per_part: int
    kind: str
    sell_c: int


def build_band(a: Union[sp.COO, CachedGraph], num_parts: int, p: int,
               plan: Optional[KernelPlan] = None, device="cuda"
               ) -> tuple[Bands, Band]:
    """Band ``p`` of :func:`build_dist_graph`'s partition alone, built on
    the host and taken to ``device``, without packing the other bands:
    equal to ``build_dist_graph(a, num_parts, plan).band(p, device)``.
    Returns the partition's geometry too."""
    coo, deg, own_plan = _host_graph(a)
    plan = own_plan if plan is None else plan
    nrows, ncols = coo.nrows, coo.ncols
    row = coo.row[: coo.nse].cpu().numpy()
    col = coo.col[: coo.nse].cpu().numpy()
    val = coo.val[: coo.nse].cpu().numpy()
    kind, c = ("sell" if plan.wants_sell else "ell"), plan.sell_c
    rp = -(-nrows // num_parts)
    if kind == "sell":
        rp = -(-rp // c) * c
    lo, hi = p * rp, min((p + 1) * rp, nrows)
    n_loc = max(hi - lo, 0)
    d = np.zeros(rp, np.float32) if kind == "sell" else \
        np.ones(rp, np.float32)
    d[:n_loc] = deg[lo:lo + n_loc]
    inv = _t(1.0 / np.maximum(d, 1.0))
    if kind == "sell":
        b = sp.sell_from_coo(_band_coo(row, col, val, lo, max(hi, lo), rp,
                                       ncols), c=c, sigma=0)
        op = sell_piece(b.idx, b.val, b.slice_of, b.inv_perm, ncols, c)
    else:
        counts = np.bincount(row, minlength=nrows)
        md = max(int(counts.max()) if counts.size else 1, 1)
        e = sp.ell_from_coo(_band_coo(row, col, val, lo, max(hi, lo), rp,
                                      ncols), max_deg=md)
        op = ell_piece(e.idx, e.val, ncols)
    geo = Bands(nrows=nrows, ncols=ncols, parts=num_parts, rows_per_part=rp,
                kind=kind, sell_c=c)
    return geo, Band.make(op, inv, p, device)


def _partition_axis(mesh) -> str:
    """The mesh axis the row bands shard over: ``'data'`` where the mesh
    has it, else its first axis."""
    return "data" if "data" in mesh.shape else next(iter(mesh.shape))


def shard_rows(x: torch.Tensor, parts: int, p: int) -> torch.Tensor:
    """Block ``p`` of ``parts`` of ``x``'s rows, ``x`` padded with zero
    rows to a multiple of ``parts`` first: a rank's row shard."""
    n = -(-x.shape[0] // parts)
    blk = x[p * n:(p + 1) * n]
    if blk.shape[0] < n:
        blk = torch.cat([blk, blk.new_zeros((n - blk.shape[0],) +
                                            tuple(x.shape[1:]))])
    return blk


def comm_volume(g: Union[DistGraph, Bands], k: int) -> dict:
    """A rank's collective traffic (feature rows, elements) in one
    :func:`distributed_spmm` step: the halo all-gathers the whole padded
    H on every rank, O(N K) whatever the rank count (the 2-D partition,
    ``gnn2d.comm_volume_2d``, cuts it to O(N / sqrt(P)))."""
    n_pad = -(-g.ncols // g.parts) * g.parts
    return dict(gather_rows=n_pad, scatter_rows=0, elements=n_pad * k)


def distributed_spmm(g: Union[DistGraph, Band], h: torch.Tensor, mesh,
                     reduce: str = "sum") -> torch.Tensor:
    """A @ H on this rank, A row-banded over the mesh's partition axis
    (``'data'``, else its first axis). ``g``: this rank's :class:`Band`
    (or the :class:`DistGraph`, whose band is then taken to the device
    on every call); ``h``: this rank's ``(ceil(ncols / P), K)`` row
    shard of H (:func:`shard_rows`). Returns this rank's ``(rows_per_part, K)`` rows
    of the result (rows past ``nrows`` are zero), in ``h``'s dtype.
    Differentiable in ``h``."""
    axis = _partition_axis(mesh)
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce must be 'sum' or 'mean', got {reduce!r}")
    band = g.local(mesh) if isinstance(g, DistGraph) else g
    n = mesh.shape[axis]
    n_pad = -(-band.op.ncols // n) * n
    if h.shape[0] * n != n_pad:
        raise ValueError(f"distributed_spmm: h has {h.shape[0]} rows a rank "
                         f"over {n} ranks, the graph {band.op.ncols} columns")
    hg = all_gather(h, mesh, axis)                   # the halo, (n_pad, K)
    out = SlotSpMM.apply(band.weight, hg[: band.op.ncols], band)
    if reduce == "mean":
        out = out * band.inv_deg[:, None]
    return out.to(h.dtype)
