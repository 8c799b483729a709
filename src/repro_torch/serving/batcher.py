"""Micro-batching for online inference: synchronous API, async batching.

The serving front half of the classic dynamic-batching server (Clipper /
NVIDIA Triton pattern): callers block on a synchronous ``predict`` while
their requests coalesce behind the scenes into one packed block per
flush, amortizing the serve step's fixed cost across concurrent
requests. Two knobs bound the trade:

* ``max_batch`` — flush as soon as the pending seed total fills a batch
  (throughput bound);
* ``max_delay_s`` — flush whatever is queued once the *oldest* pending
  request has waited this long (the latency SLO; a lone request never
  waits more than one delay window for company).

:class:`MicroBatcher` is the pure, lock-protected queueing core: it owns
tickets and flush composition but runs no model and spawns no threads —
the serve loop (``serving.server``) polls :meth:`next_flush` and fills
tickets. The clock is injectable (``time_fn``) so the property-based
tests drive arrival order and time deterministically, with no sleeps
and no thread scheduling in the loop.

Flush composition is deterministic: strict FIFO, take whole requests
while they fit in ``max_batch``. A request is never split across
flushes, never dropped, never duplicated — the hypothesis-style suite
checks those invariants over arbitrary arrival interleavings, plus the
SLO bound: a request admitted at time t is *composed into* a flush no
later than t + max_delay_s (one flush's model time after that is the
inherent service tail, not a queueing violation).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.sampling.buckets import round_bucket

__all__ = ["Ticket", "Flush", "MicroBatcher"]


class Ticket:
    """One pending request's handle: the caller blocks on :meth:`result`,
    the serve loop calls :meth:`fill` / :meth:`fail` exactly once."""

    def __init__(self, seeds: np.ndarray, submitted_at: float):
        self.seeds = seeds                  # (n,) int64, as submitted
        self.submitted_at = float(submitted_at)
        self._done = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.completed_at: Optional[float] = None
        self.flush_index: Optional[int] = None   # set by the serve loop

    def fill(self, value, now: Optional[float] = None) -> None:
        self._value = value
        self.completed_at = time.monotonic() if now is None else float(now)
        self._done.set()

    def fail(self, err: BaseException, now: Optional[float] = None) -> None:
        self._error = err
        self.completed_at = time.monotonic() if now is None else float(now)
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the serve loop fills this ticket; re-raises a
        serve-side error in the caller's thread."""
        if not self._done.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class Flush:
    """One composed micro-batch: FIFO tickets plus the concatenated seed
    vector and the bucket it rides (``round_bucket`` of the real seed
    count — deterministic in the composition, so identical compositions
    always pack to the same shapes)."""

    tickets: List[Ticket]
    seeds: np.ndarray       # (sum n_i,) int64, ticket order
    bucket: int
    index: int              # monotone flush counter (doubles as rng round)

    @property
    def n_real(self) -> int:
        return int(self.seeds.shape[0])

    def splits(self) -> List[slice]:
        """Per-ticket slices of the seed vector / result rows."""
        out, off = [], 0
        for t in self.tickets:
            out.append(slice(off, off + len(t.seeds)))
            off += len(t.seeds)
        return out


class MicroBatcher:
    """Thread-safe FIFO request queue with size- and deadline-driven
    flush composition. See the module docstring for the contract."""

    def __init__(self, max_batch: int, max_delay_s: float, *,
                 bucket_base: int = 16,
                 time_fn: Callable[[], float] = time.monotonic):
        assert max_batch >= 1, max_batch
        assert max_delay_s >= 0.0, max_delay_s
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.bucket_base = int(bucket_base)
        self._time = time_fn
        self._lock = threading.Lock()
        self._queue: List[Ticket] = []
        self._flushes = 0
        self.submitted = 0

    # -- producer side ----------------------------------------------------
    def submit(self, seeds: Sequence[int]) -> Ticket:
        """Enqueue one request (1..max_batch unique seed ids) and return
        its ticket. Validation errors raise here, in the caller, before
        anything is queued."""
        arr = np.asarray(seeds, np.int64).ravel()
        if arr.size == 0:
            raise ValueError("empty seed set")
        if arr.size > self.max_batch:
            raise ValueError(
                f"request has {arr.size} seeds > max_batch={self.max_batch}; "
                "split it client-side")
        t = Ticket(arr, self._time())
        with self._lock:
            self._queue.append(t)
            self.submitted += 1
        return t

    # -- consumer side ----------------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def deadline(self) -> Optional[float]:
        """Absolute time the oldest pending request must be flushed by,
        or None when idle — the serve loop's wait bound."""
        with self._lock:
            if not self._queue:
                return None
            return self._queue[0].submitted_at + self.max_delay_s

    def ready(self, now: Optional[float] = None) -> bool:
        """Would :meth:`next_flush` return a flush right now? True when a
        full batch is queued or the oldest request's SLO clock ran out."""
        now = self._time() if now is None else float(now)
        with self._lock:
            return self._ready_locked(now)

    def _ready_locked(self, now: float) -> bool:
        if not self._queue:
            return False
        total = sum(len(t.seeds) for t in self._queue)
        if total >= self.max_batch:
            return True
        return now - self._queue[0].submitted_at >= self.max_delay_s

    def next_flush(self, now: Optional[float] = None) -> Optional[Flush]:
        """Compose and dequeue one flush, or None if neither trigger has
        fired. FIFO whole-request packing: take requests in arrival order
        while the seed total stays <= max_batch; the first one that does
        not fit starts the next flush."""
        now = self._time() if now is None else float(now)
        with self._lock:
            if not self._ready_locked(now):
                return None
            take: List[Ticket] = []
            total = 0
            for t in self._queue:
                if total + len(t.seeds) > self.max_batch:
                    break
                take.append(t)
                total += len(t.seeds)
            del self._queue[: len(take)]
            idx = self._flushes
            self._flushes += 1
        seeds = np.concatenate([t.seeds for t in take])
        return Flush(tickets=take, seeds=seeds,
                     bucket=round_bucket(len(seeds), base=self.bucket_base),
                     index=idx)

    def drain(self, now: Optional[float] = None) -> List[Flush]:
        """Flush everything queued regardless of triggers (shutdown
        path): repeated forced compositions until the queue is empty."""
        out: List[Flush] = []
        while True:
            with self._lock:
                if not self._queue:
                    return out
                # force readiness by pretending the SLO expired
                take: List[Ticket] = []
                total = 0
                for t in self._queue:
                    if total + len(t.seeds) > self.max_batch:
                        break
                    take.append(t)
                    total += len(t.seeds)
                del self._queue[: len(take)]
                idx = self._flushes
                self._flushes += 1
            seeds = np.concatenate([t.seeds for t in take])
            out.append(Flush(tickets=take, seeds=seeds,
                             bucket=round_bucket(len(seeds),
                                                 base=self.bucket_base),
                             index=idx))
