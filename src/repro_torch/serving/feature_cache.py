"""Device-resident LRU feature cache with a pinned-host fallback.

Small-neighborhood GNN inference is dominated by the feature fetch: every
request drags its ego network's feature rows across the host-device
boundary. :class:`FeatureCache` keeps a fixed-capacity ``(capacity, K)``
table on the device plus a host-side **slot map** (id -> slot, in LRU
order). A :meth:`FeatureCache.gather`:

1. resolves every id through the slot map — hits read the device table
   (``kernels/ops.slot_gather``), no host traffic;
2. misses are gathered on the host from the fallback matrix, which lives
   in pinned memory, and cross to the device in one copy per flush;
3. miss rows are written into LRU-evicted slots in place
   (``kernels/ops.table_insert``).

Rows are copied, never recomputed, so a hit is bitwise the fallback row it
was filled from. Every inserted row carries the cache's ``epoch``;
:meth:`set_epoch` makes older entries read as misses (lazy refill). The
device scatter happens before the host slot map commits an insertion, so
an exception in between leaves the map pointing only at written rows
(:meth:`check_consistency` verifies that).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.ops import slot_gather, table_insert

__all__ = ["FeatureCache", "CacheStats"]


@dataclasses.dataclass
class CacheStats:
    """Lifetime counters (ids, not gather calls)."""

    hits: int = 0          # ids served from the device table
    misses: int = 0        # ids fetched from the pinned-host fallback
    stale: int = 0         # misses caused by an epoch-stamp mismatch
    evictions: int = 0     # LRU entries displaced by insertions
    insertions: int = 0    # rows written into the table

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


def _host_matrix(x, pinned: bool) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    t = t.detach().to("cpu", torch.float32).contiguous()
    return t.pin_memory() if pinned else t


class FeatureCache:
    """Fixed-capacity device-resident LRU row cache over a host matrix.

    ``fallback`` is the backing store (node features), kept on the host —
    pinned when ``device`` is a CUDA device. ``capacity`` rows live on
    ``device``; ``capacity=0`` gathers everything from the fallback. Ids
    ``>= num_rows`` are the block-padding sentinel: they gather a zero row
    and are never cached.
    """

    def __init__(self, fallback, capacity: int, *, device="cuda",
                 epoch: int = 0):
        self.device = torch.device(device)
        self._pinned = self.device.type == "cuda"
        self._fallback = _host_matrix(fallback, self._pinned)
        assert self._fallback.dim() == 2, tuple(self._fallback.shape)
        self.capacity = int(capacity)
        assert self.capacity >= 0, capacity
        self.epoch = int(epoch)
        # one dummy row at capacity 0 keeps slot_gather's shapes legal;
        # the slot map is empty so it is never selected
        self._table = torch.zeros((max(self.capacity, 1), self.k),
                                  dtype=torch.float32, device=self.device)
        # id -> (slot, epoch-stamp); ordering IS the recency order
        self._slot_of: OrderedDict[int, tuple[int, int]] = OrderedDict()
        self._free: list[int] = list(range(self.capacity))
        self.stats = CacheStats()

    @property
    def num_rows(self) -> int:
        return self._fallback.shape[0]

    @property
    def k(self) -> int:
        return self._fallback.shape[1]

    def cached_ids(self) -> list[int]:
        """Resident ids, least-recently-used first."""
        return list(self._slot_of)

    def set_epoch(self, epoch: int, fallback=None) -> None:
        """Advance the staleness epoch; optionally swap the backing store.
        Entries stamped with an older epoch read as misses until refilled."""
        assert int(epoch) >= self.epoch, (epoch, self.epoch)
        if fallback is not None:
            fb = _host_matrix(fallback, self._pinned)
            assert fb.shape == self._fallback.shape, \
                (tuple(fb.shape), tuple(self._fallback.shape))
            self._fallback = fb
        self.epoch = int(epoch)

    def _slots_for(self, ids: np.ndarray) -> np.ndarray:
        """Slot per id (hit) or -1; refreshes LRU recency for hits and
        counts stale stamps."""
        slots = np.full(len(ids), -1, np.int32)
        for i, nid in enumerate(ids.tolist()):
            entry = self._slot_of.get(nid)
            if entry is None:
                continue
            slot, stamp = entry
            if stamp != self.epoch:
                self.stats.stale += 1
                continue
            slots[i] = slot
            self._slot_of.move_to_end(nid)
        return slots

    def _insert(self, ids: Sequence[int], rows: torch.Tensor) -> None:
        """Write device ``rows`` into LRU-assigned slots: device scatter
        first, host map commit second."""
        take = min(len(ids), self.capacity)
        if take == 0:
            return
        # more ids than slots: keep the *last* `capacity` ids (they would
        # have evicted the earlier ones anyway)
        ids = list(ids)[-take:]
        rows = rows[-take:]
        slots = []
        n_evict = 0
        for nid in ids:
            stale = self._slot_of.pop(int(nid), None)
            if stale is not None:          # stale-stamp refill reuses its slot
                slots.append(stale[0])
            elif self._free:
                slots.append(self._free.pop())
            else:                          # evict the least-recently-used
                _, (slot, _) = self._slot_of.popitem(last=False)
                self.stats.evictions += 1
                n_evict += 1
                slots.append(slot)
        self._table = table_insert(self._table, np.asarray(slots, np.int32),
                                   rows)
        for nid, slot in zip(ids, slots):
            self._slot_of[int(nid)] = (slot, self.epoch)
        self.stats.insertions += len(ids)
        if obs.enabled():
            reg = obs.metrics()
            reg.counter("cache.evictions").inc(n_evict)
            reg.counter("cache.insertions").inc(len(ids))

    def _staged(self, ids: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """``(len(ids), K)`` device rows: fallback rows at positions
        ``pos`` (one host gather, one host-to-device copy), zeros
        elsewhere."""
        out = torch.zeros((len(ids), self.k), dtype=torch.float32,
                          device=self.device)
        if pos.size:
            rows = torch.empty((pos.size, self.k), dtype=torch.float32,
                               pin_memory=self._pinned)
            torch.index_select(self._fallback, 0,
                               torch.from_numpy(ids[pos].astype(np.int64)),
                               out=rows)
            out.index_copy_(
                0, torch.from_numpy(pos.astype(np.int64)).to(self.device),
                rows.to(self.device, non_blocking=True))
        return out

    def gather(self, ids) -> torch.Tensor:
        """``(len(ids), K)`` device rows for global ``ids`` (host int
        array; ``>= num_rows`` = padding sentinel -> zero row). Hits come
        from the device table, misses from the fallback, and the miss rows
        are inserted for next time."""
        ids = np.asarray(ids)
        real = ids < self.num_rows
        slots = self._slots_for(ids)
        slots[~real] = -1
        miss = real & (slots < 0)
        miss_pos = np.nonzero(miss)[0]
        n_hit = int(np.count_nonzero(slots >= 0))
        self.stats.hits += n_hit
        self.stats.misses += int(miss_pos.size)
        if obs.enabled():
            reg = obs.metrics()
            reg.counter("cache.hits").inc(n_hit)
            reg.counter("cache.misses").inc(int(miss_pos.size))
            reg.gauge("cache.hit_rate").set(self.stats.hit_rate)

        staged = self._staged(ids, miss_pos)
        # gather BEFORE inserting: this call's misses may evict this call's
        # own hits, whose slots must be read out first
        out = slot_gather(self._table,
                          torch.from_numpy(slots).to(self.device), staged)
        if miss_pos.size and self.capacity:
            uniq, first = np.unique(ids[miss_pos], return_index=True)
            rows = staged.index_select(
                0, torch.from_numpy(miss_pos[first]).to(self.device))
            self._insert(uniq.tolist(), rows)
        return out

    def gather_reference(self, ids) -> torch.Tensor:
        """The same gather served entirely from the fallback (sentinels ->
        zero rows), touching no cache state."""
        ids = np.asarray(ids)
        return self._staged(ids, np.nonzero(ids < self.num_rows)[0])

    def check_consistency(self) -> None:
        """Assert every fresh-stamped cached row equals its fallback row
        bit for bit."""
        fresh = [(nid, slot) for nid, (slot, stamp) in self._slot_of.items()
                 if stamp == self.epoch]
        if not fresh:
            return
        nids = torch.tensor([nid for nid, _ in fresh], dtype=torch.int64)
        slots = torch.tensor([slot for _, slot in fresh], dtype=torch.int64)
        assert len(set(slots.tolist())) == len(slots), \
            "slot map corrupt: two ids share a slot"
        got = self._table[slots.to(self.device)].cpu()
        want = self._fallback[nids]
        assert torch.equal(got, want), \
            f"cache rows diverged from fallback for ids {nids.tolist()}"
