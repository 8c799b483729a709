"""Device-resident graph + fused k-hop sampling (the GraphBolt pattern).

Port of ``src/repro/sampling/device_graph.py`` for one device. The host
:class:`~repro_torch.sampling.sampler.NeighborSampler` rank-selects,
relabels and packs every minibatch in numpy; this module does that stage
on the device:

* :class:`DeviceGraph` — the CSR topology moved to the device **once**,
  with one sentinel entry appended to ``indices``/``val`` so invalid
  sample slots route to an inert edge (id ``num_nodes``, value 0).
* :class:`DeviceSampler` — ``sample_blocks(seeds, rnd)`` runs every hop on
  the device: ``kernels/sample``'s ``segment_sample`` → ``expand_indptr``
  → ``flat_gather`` (hand kernels on the card), a static-size sorted
  unique relabel, and a :class:`~repro_torch.sampling.blocks.PackedBlock`
  of fixed shape per ``(batch_size, fanouts, capacities)``.

Nothing in :meth:`DeviceSampler.sample_blocks` waits for the device: no
``torch.unique`` (its output size is data-dependent), no boolean-mask
indexing, no ``nonzero``, no ``.item()``. The relabel therefore builds
the unique set with a sort, a first-of-run flag, a ``cumsum`` of the
flags as positions and a scatter into an ``(n_src,)`` tensor pre-filled
with ``num_nodes``, positions past ``n_src`` dropped — sorted-unique with
the sentinel last, as ``jnp.unique(size=, fill_value=)`` gives.

Determinism contract: draws are keyed on ``(seed, round, hop, node id,
slot)``, so a fixed ``(seeds, round)`` replays bit for bit, on the CPU
and on the card, and equals the reference's blocks bit for bit. The
stream differs from the host sampler's (same distribution).

Capacity padding (vs host ``pack_block``): invalid edge slots keep their
row, carry ``col == n_src`` / ``val == 0`` (inert under sum/mean), and
``nnz_real`` is the capacity, so device blocks are valid for sum/mean
aggregation only, which the trainer enforces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import sparse as sp
from repro_torch.core.autotune import KernelPlan
from repro_torch.kernels import sample as ksample
from repro_torch.sampling.blocks import PackedBlock
from repro_torch.sampling.buckets import LayerBucket

__all__ = ["DeviceGraph", "DeviceSampler", "device_graph_from_csr"]


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """CSR topology on one device, sentinel-extended: ``indices``/``val``
    carry ``nse + 1`` entries, the last the inert sentinel edge (neighbour
    id ``num_nodes``, value 0)."""

    indptr: torch.Tensor     # (num_nodes + 1,) int32
    indices: torch.Tensor    # (nse + 1,) int32, indices[nse] == num_nodes
    val: torch.Tensor        # (nse + 1,) float32, val[nse] == 0
    num_nodes: int
    nse: int
    max_deg: int             # host-computed max in-degree (>= 1)


def device_graph_from_csr(csr: sp.CSR, *, device="cuda") -> DeviceGraph:
    """Move the adjacency to ``device`` once."""
    assert csr.nrows == csr.ncols, "sampling expects a square adjacency"
    n = int(csr.nrows)
    indptr = sp._np(csr.indptr).astype(np.int64)
    indices = np.concatenate([sp._np(csr.indices)[: csr.nse],
                              [n]]).astype(np.int32)
    val = np.concatenate([sp._np(csr.val)[: csr.nse],
                          [0]]).astype(np.float32)
    max_deg = int(np.diff(indptr).max()) if n else 1
    return DeviceGraph(
        indptr=torch.from_numpy(indptr.astype(np.int32)).to(device),
        indices=torch.from_numpy(indices).to(device),
        val=torch.from_numpy(val).to(device),
        num_nodes=n, nse=int(csr.nse), max_deg=max(max_deg, 1))


def _sorted_unique(cand: torch.Tensor, size: int,
                   fill: int) -> torch.Tensor:
    """The first ``size`` distinct values of ``cand`` in ascending order,
    padded with ``fill``, with static shapes and no host sync."""
    srt = torch.sort(cand).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    slot = torch.cumsum(first.to(torch.int32), 0) - 1
    # repeats and values past the capacity all land on the spare slot
    slot = torch.where(first & (slot < size), slot, size)
    out = torch.full((size + 1,), fill, dtype=cand.dtype, device=cand.device)
    out.scatter_(0, slot.long(), srt)
    return out[:size]


def _searchsorted(sorted_ids: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Left bisection of ``v`` into ``sorted_ids``, clipped to a valid
    position (int32)."""
    pos = torch.searchsorted(sorted_ids, v.contiguous(), out_int32=True)
    return pos.clamp(0, sorted_ids.shape[0] - 1)


def _device_relabel(frontier: torch.Tensor, nbr: torch.Tensor,
                    valid: torch.Tensor, *, n_src: int, num_nodes: int):
    """The new source set is the sorted unique of (frontier ∪ sampled
    neighbours), deduplicating the frontier into the union, so the per-hop
    capacity tracks the bound on distinct reachable ids. The ``num_nodes``
    sentinel sorts last, so truncation drops sentinels first and real ids
    only when the capacity was probed below this batch's reach.

    Overflow is graceful, never silent: every bisection is checked by
    gathering the id back, and an edge whose endpoint was truncated out of
    ``src_ids`` is dropped (``ok`` False → inert slot), not mis-mapped.

    Returns ``(src_ids (n_src,), col (F, width), ok (F, width))`` with
    ``col == n_src`` on invalid or dropped slots."""
    cand = torch.cat([frontier,
                      torch.where(valid, nbr, num_nodes).reshape(-1)])
    src_ids = _sorted_unique(cand, n_src, num_nodes)
    pos = _searchsorted(src_ids, nbr)
    ok = valid & (src_ids[pos.long()] == nbr)
    col = torch.where(ok, pos, n_src)
    return src_ids, col, ok


class DeviceSampler:
    """Fused k-hop sampler over a :class:`DeviceGraph`, with static per-hop
    capacities: hop ``j`` (innermost first) expands ``r_j`` distinct
    reachable ids by width ``w_j`` (the fanout, or the graph's max degree
    for full hops) into at most ``min(r_j * (1 + w_j), num_nodes)``
    distinct sources, or the probed ``src_caps[j]`` when smaller, rounded
    up to a multiple of ``base``. ``fanouts`` is outermost first, as the
    host sampler's.

    Call :meth:`set_plans` (outermost first, one per layer) before
    :meth:`sample_blocks`.
    """

    def __init__(self, graph: DeviceGraph, fanouts: Sequence, *,
                 batch_size: int, seed: int = 0, replace: bool = False,
                 base: int = 128,
                 src_caps: Optional[Sequence[int]] = None):
        self.graph = graph
        self.fanouts = tuple(fanouts)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.replace = bool(replace)
        self._plans: Optional[list[KernelPlan]] = None
        if src_caps is not None:
            assert len(src_caps) == len(self.fanouts), (src_caps, fanouts)
        self._hop_dims: list[tuple[int, int, int]] = []  # (n_dst,n_src,width)
        level = self.batch_size
        real = self.batch_size
        for j, fanout in enumerate(reversed(self.fanouts)):
            width = int(fanout) if fanout is not None else graph.max_deg
            width = max(width, 1)
            bound = min(real * (1 + width), graph.num_nodes)
            tgt = bound if src_caps is None else min(int(src_caps[j]), bound)
            n_src = -(-max(tgt, 1) // base) * base
            self._hop_dims.append((level, n_src, width))
            level = n_src
            real = min(n_src, bound)

    @property
    def buckets(self) -> list[LayerBucket]:
        """Outermost-first per-layer buckets: the keys ``BlockPlanCache``
        plans against."""
        out = [LayerBucket(n_dst=d, n_src=s, nnz=d * w, ell_width=w,
                           sell_steps=None)
               for d, s, w in self._hop_dims]
        return out[::-1]

    def set_plans(self, plans: Sequence[KernelPlan]) -> None:
        """Per-layer kernel plans, outermost first. SELL/BSR plans are
        remapped to ELL: device packing never builds them, and fanout
        sampling *is* the fixed-width ELL layout."""
        assert len(plans) == len(self.fanouts), (len(plans),
                                                 len(self.fanouts))
        self._plans = [dataclasses.replace(p, kind="ell")
                       if p.kind in ("sell", "bsr") else p
                       for p in plans]

    @property
    def signature(self) -> tuple:
        """Bucket signature of the emitted block tuple, one entry per
        layer (``PackedBlock.bucket_signature``)."""
        assert self._plans is not None, "call set_plans() first"
        sig = []
        for (d, s, w), plan in zip(self._hop_dims[::-1], self._plans):
            entry = (d, s, d * w, plan.kind)
            if plan.wants_ell:
                entry += (w,)
            sig.append(entry)
        return tuple(sig)

    def _hop(self, frontier: torch.Tensor, hop: int, rnd: int):
        g = self.graph
        n_dst, n_src, width = self._hop_dims[hop]
        fanout = tuple(reversed(self.fanouts))[hop]
        plan = self._plans[len(self.fanouts) - 1 - hop]
        dev = frontier.device

        # degrees via clipped indptr lookups: sentinel frontier entries
        # (id == num_nodes) read indptr[N] twice -> degree 0
        start = g.indptr[frontier.clamp(0, g.num_nodes).long()]
        end = g.indptr[(frontier + 1).clamp(0, g.num_nodes).long()]
        deg = end - start

        ranks = ksample.segment_sample(
            deg, frontier, rnd, width=width, fanout=fanout, seed=self.seed,
            hop=hop, replace=self.replace)
        valid = ksample.sample_valid_mask(deg, width=width, fanout=fanout,
                                          replace=self.replace)
        pos = ksample.expand_indptr(start, ranks, valid, sentinel=g.nse)
        nbr = ksample.flat_gather(g.indices, pos)
        evals = ksample.flat_gather(g.val, pos)

        src_ids, col2d, ok = _device_relabel(frontier, nbr, valid,
                                             n_src=n_src,
                                             num_nodes=g.num_nodes)
        nnz = n_dst * width
        row = torch.arange(n_dst, dtype=torch.int32,
                           device=dev)[:, None].expand(n_dst, width)
        val2d = torch.where(ok, evals, 0.0)
        ell = None
        if plan.wants_ell:
            ell = sp.ELL(idx=col2d, val=val2d, nrows=n_dst, ncols=n_src,
                         nse=nnz)
        # dst node i is frontier[i]; its self term's row in the source set
        # is found by bisection with the same gather-back overflow check: a
        # truncated dst id zero-fills its self term
        dpos = _searchsorted(src_ids, frontier)
        real_dst = frontier < g.num_nodes
        dok = real_dst & (src_ids[dpos.long()] == frontier)
        dst_pos = torch.where(dok, dpos, n_src)
        # capacity overflow: sampled edges (and dst self terms) dropped
        # because a probed capacity was below this batch's reach
        ovf = ((valid & ~ok).sum(dtype=torch.int32)
               + (real_dst & ~dok).sum(dtype=torch.int32))
        return ovf, PackedBlock(
            src_ids=src_ids, dst_pos=dst_pos,
            row=row.reshape(-1), col=col2d.reshape(-1),
            val=val2d.reshape(-1),
            degrees=ok.sum(dim=1).to(torch.float32),
            ell=ell, sell=None,
            n_dst_real=real_dst.sum(dtype=torch.int32),
            # the capacity, not the real count: invalid slots are scattered
            # through the table, so the trusted path must take every slot;
            # they are inert through val == 0 / col == n_src
            nnz_real=nnz,
            n_dst=n_dst, n_src=n_src, plan_kind=plan.kind)

    def sample_blocks(self, seeds: torch.Tensor, rnd: int) -> tuple:
        """All hops for one seed batch, outermost first (host ``sample``
        order). ``seeds`` is the ``(batch_size,)`` int32 vector on the
        device, pad slots already set to the ``num_nodes`` sentinel; ``rnd``
        is the round counter (a host int)."""
        return self.sample_blocks_stats(seeds, rnd)[0]

    def sample_blocks_stats(self, seeds: torch.Tensor, rnd: int):
        """:meth:`sample_blocks` plus the batch's capacity-overflow count
        as a device int32 scalar: ``(blocks, ovf)``."""
        assert self._plans is not None, "call set_plans() first"
        frontier = seeds.to(torch.int32)
        blocks = []
        ovf = None
        for hop in range(len(self.fanouts)):
            hop_ovf, blk = self._hop(frontier, hop, rnd)
            ovf = hop_ovf if ovf is None else ovf + hop_ovf
            blocks.append(blk)
            frontier = blk.src_ids
        return tuple(blocks[::-1]), ovf
