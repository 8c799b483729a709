"""Deterministic fused k-hop neighbor sampling over CSR (host-side).

The port keeps the reference's numpy sampler line for line, so the blocks
drawn per ``(seed, round, fanouts)`` are bitwise the reference's.

The DGL/GraphSAGE production pattern: a minibatch of *seed* nodes is
expanded backwards through the layers — each hop samples at most ``fanout``
in-neighbors per frontier node — and every hop is emitted as a relabeled
bipartite **message-flow graph** (MFG, "block"): ``n_dst`` frontier rows
aggregating from ``n_src`` source columns, with local (block-relative) edge
ids. Two invariants downstream packing relies on:

* **dst-prefix**: ``src_ids[:n_dst] == dst_ids`` — every destination node
  is also a source (its own features stay available for the self/root term
  of SAGE/GIN), and the *real* destinations occupy the source prefix.
* **chaining**: ``blocks[i].dst_ids`` is exactly ``blocks[i+1].src_ids``
  wait-free — the output rows of layer i are, in order, the input rows of
  layer i+1. The trainer never re-gathers between layers.

Everything here is host-side numpy (sampling is per-batch preprocessing,
never traced); determinism is total per ``(seed, round, fanouts)`` — the
same tuple reproduces the same blocks bit-for-bit, which is what makes
distributed seed-sharding reproducible and failures replayable.

The per-hop sampler is *fused*: one vectorized pass draws all frontier
nodes' samples together (random keys per candidate edge + a windowed rank
select), no per-node Python loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import sparse as sp

__all__ = ["Block", "NeighborSampler"]


@dataclasses.dataclass(frozen=True)
class Block:
    """One bipartite MFG hop, host-side numpy, unpadded.

    Edges are local: ``row`` indexes destinations (``[0, n_dst)``), ``col``
    indexes sources (``[0, n_src)``); ``src_ids`` maps local source id ->
    global node id. ``val`` carries the sampled edges' stored values.
    """

    src_ids: np.ndarray   # (n_src,) int64 global ids; prefix [:n_dst] = dst
    n_dst: int
    row: np.ndarray       # (nnz,) local dst id
    col: np.ndarray       # (nnz,) local src id
    val: np.ndarray       # (nnz,) edge values
    num_nodes: int        # global node count (feature-gather bound)

    @property
    def n_src(self) -> int:
        return int(self.src_ids.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def dst_ids(self) -> np.ndarray:
        return self.src_ids[: self.n_dst]

    def degrees(self) -> np.ndarray:
        """Sampled in-degree per destination."""
        return np.bincount(self.row, minlength=self.n_dst)


def _expand_ranges(start: np.ndarray, deg: np.ndarray):
    """Concatenate ``range(start[i], start[i]+deg[i])`` for all i; returns
    (positions, owner-row-of-each-position)."""
    tot = int(deg.sum())
    row_of = np.repeat(np.arange(len(deg)), deg)
    offset = np.arange(tot) - np.repeat(np.cumsum(deg) - deg, deg)
    return start[row_of] + offset, row_of


def _relabel(frontier: np.ndarray, nbr_global: np.ndarray):
    """Local ids with the frontier as prefix: returns (src_ids, col_local)
    where ``src_ids[:len(frontier)] == frontier`` and new sources follow in
    first-appearance order."""
    cat = np.concatenate([frontier, nbr_global])
    uniq, first = np.unique(cat, return_index=True)
    order = np.argsort(first, kind="stable")   # frontier entries come first
    src_ids = uniq[order]
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    col_local = rank[np.searchsorted(uniq, nbr_global)]
    return src_ids, col_local


class NeighborSampler:
    """Seeded fused k-hop in-neighbor sampler over a :class:`repro_torch.core.CSR`.

    ``fanouts`` is per-layer, outermost-last like the blocks it produces:
    ``fanouts[-1]`` samples the seeds' direct neighbors, ``fanouts[0]`` the
    outermost hop. An entry of ``None`` takes the full neighborhood
    (layer-wise inference). ``replace=True`` samples with replacement
    (duplicate edges are kept — the unbiased-estimator convention);
    without replacement a node with degree <= fanout keeps all its edges.

    ``sample(seeds, round=r)`` is deterministic per ``(seed, r)``: the rng
    stream is freshly derived from that pair, so epochs/batches replay
    exactly and shards on different hosts can coordinate by round number.
    """

    def __init__(self, csr: sp.CSR, fanouts, *, replace: bool = False,
                 seed: int = 0):
        self.indptr = sp._np(csr.indptr).astype(np.int64)
        self.indices = sp._np(csr.indices)[: csr.nse].astype(np.int64)
        self.val = sp._np(csr.val)[: csr.nse]
        self.fanouts = tuple(fanouts)
        self.replace = bool(replace)
        self.seed = int(seed)
        self.num_nodes = int(csr.nrows)
        assert csr.nrows == csr.ncols, "sampling expects a square adjacency"

    # -- one hop ----------------------------------------------------------
    def _sample_hop(self, frontier: np.ndarray, fanout, rng):
        start = self.indptr[frontier]
        deg = self.indptr[frontier + 1] - start
        if fanout is None:                       # full neighborhood
            pos, row_local = _expand_ranges(start, deg)
        elif self.replace:
            f = len(frontier)
            u = rng.random((f, int(fanout)))
            draw = np.floor(u * deg[:, None]).astype(np.int64)
            keep = np.broadcast_to(deg[:, None] > 0, draw.shape)
            row_local = np.nonzero(keep)[0]
            pos = (start[:, None] + draw)[keep]
        else:
            # fused rank-select: random key per candidate edge, keep the
            # ``fanout`` smallest keys within each frontier row
            pos_all, row_of = _expand_ranges(start, deg)
            keys = rng.random(pos_all.shape[0])
            order = np.lexsort((keys, row_of))
            row_s, pos_s = row_of[order], pos_all[order]
            slot = np.arange(len(row_s)) - np.repeat(np.cumsum(deg) - deg,
                                                     deg)
            keep = slot < int(fanout)
            row_local, pos = row_s[keep], pos_s[keep]
        return row_local, self.indices[pos], self.val[pos]

    def _block(self, frontier, fanout, rng) -> Block:
        row_local, nbr, val = self._sample_hop(frontier, fanout, rng)
        src_ids, col_local = _relabel(frontier, nbr)
        return Block(src_ids=src_ids, n_dst=len(frontier),
                     row=np.asarray(row_local, np.int64), col=col_local,
                     val=val, num_nodes=self.num_nodes)

    # -- the fused k-hop pass --------------------------------------------
    def sample(self, seeds, *, round: int = 0, fanouts=None) -> list[Block]:
        """All ``len(fanouts)`` hops for one seed minibatch, outermost
        first: ``blocks[0]`` consumes raw features of its ``src_ids``,
        ``blocks[-1]`` produces the seeds' outputs.

        ``fanouts`` overrides the constructor's per-layer fanouts for this
        call only (same length; ``None`` entries = full neighborhood) —
        the serving path uses one sampler for both its sampled request
        mode and its exact full-neighbor parity mode. The rng stream is
        keyed ``(seed, round)`` either way, so a fixed ``(seeds, round,
        fanouts)`` triple replays bit-for-bit."""
        fanouts = self.fanouts if fanouts is None else tuple(fanouts)
        assert len(fanouts) == len(self.fanouts), (fanouts, self.fanouts)
        frontier = np.asarray(seeds, np.int64)
        assert np.unique(frontier).size == frontier.size, \
            "seed nodes must be unique (slice loader pads off first)"
        rng = np.random.default_rng((self.seed, int(round)))
        blocks: list[Block] = []
        for fanout in reversed(fanouts):
            blk = self._block(frontier, fanout, rng)
            blocks.append(blk)
            frontier = blk.src_ids
        blocks.reverse()
        return blocks

    def full_block(self, dst_ids) -> Block:
        """One full-neighborhood hop (fanout = all in-edges) for layer-wise
        inference — no randomness consumed."""
        rng = np.random.default_rng(0)           # unused for fanout=None
        return self._block(np.asarray(dst_ids, np.int64), None, rng)
