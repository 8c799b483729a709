"""Seed-node loaders: shuffled epochs, static batch shapes, a host
double buffer.

Port of ``src/repro/sampling/loader.py`` for one shard. Every batch is
padded to exactly ``batch_size`` seeds (the real count rides along for
loss masking), and the epoch permutation is the reference's numpy
generator keyed ``(seed, epoch)``, so both packages walk the same
batches in the same order. :func:`prefetch` runs a (sample + pack)
generator one item (or ``depth`` items) ahead in a background thread, so
the host prepares batch *b+1* while the device runs batch *b*;
:func:`resilient_prefetch` rebuilds a dead producer from the count of
items already delivered, a bounded number of times. Sharding the seeds
over data-parallel workers (``shard_seeds``, the lockstep padding) comes
with the distributed slice (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch import obs

__all__ = ["seed_batches", "num_seed_batches", "prefetch",
           "resilient_prefetch"]


def num_seed_batches(n_seeds: int, batch_size: int) -> int:
    """Batches per epoch: ``ceil(n_seeds / batch_size)``."""
    return -(-n_seeds // batch_size)


def seed_batches(seeds, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, epoch: int = 0
                 ) -> Iterator[tuple[np.ndarray, int]]:
    """Yield ``(padded_seeds, n_real)`` minibatches of seed node ids.

    ``padded_seeds`` always has ``batch_size`` entries: a short tail batch
    repeats its first seed (the trainer masks the pads out of the loss and
    routes them to the sentinel before device sampling). The permutation is
    deterministic per ``(seed, epoch)``."""
    ids = np.asarray(seeds)
    if shuffle:
        rng = np.random.default_rng((int(seed), int(epoch)))
        ids = ids[rng.permutation(len(ids))]
    for b in range(num_seed_batches(len(ids), batch_size)):
        chunk = ids[b * batch_size: (b + 1) * batch_size]
        n_real = len(chunk)
        if n_real < batch_size:
            pad = np.full(batch_size - n_real, chunk[0], ids.dtype)
            chunk = np.concatenate([chunk, pad])
        yield chunk, n_real


_DONE = object()


def prefetch(it: Iterator, depth: int = 1) -> Iterator:
    """Run ``it`` one (or ``depth``) item(s) ahead in a daemon thread.
    Items arrive in order; an exception in the producer re-raises at the
    consumer's next pull. Closing the consumer stops and joins the
    producer (it owns ``it`` and closes it)."""
    q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
    stop = threading.Event()

    def put(entry) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            try:
                for item in it:
                    if not put((None, item)):
                        return
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
        except BaseException as exc:   # noqa: BLE001 — re-raised at consumer
            put((exc, None))
            return
        put((None, _DONE))

    t = threading.Thread(target=work, daemon=True, name="repro-prefetch")
    t.start()
    try:
        while True:
            # how long the step waited for the host pipeline
            with obs.span("loader.stall"):
                exc, item = q.get()
            if exc is not None:
                raise exc
            if item is _DONE:
                return
            yield item
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def resilient_prefetch(make_iter: Callable[[int], Iterator], *,
                       depth: int = 1, max_restarts: int = 2,
                       on_restart: Optional[Callable[[int, int, BaseException],
                                                     None]] = None
                       ) -> Iterator:
    """:func:`prefetch` with a bounded restart of a dead producer.

    ``make_iter(start)`` rebuilds the stream from item ``start`` (the
    streams here are deterministic per (seed, epoch, batch), so skipping
    the first ``start`` items gives the tail the dead producer owed).
    When the producer raises, the pipeline is torn down and rebuilt from
    the count of items already delivered, at most ``max_restarts`` times;
    past that the producer's exception propagates. ``on_restart(n,
    delivered, exc)`` sees each recovery. An exception thrown into this
    generator at a ``yield`` (the consumer's) is not a producer fault:
    the pull happens inside the ``try``, the yield outside it."""
    delivered = 0
    restarts = 0
    while True:
        it = prefetch(make_iter(delivered), depth=depth)
        try:
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    return
                except Exception as exc:
                    restarts += 1
                    if restarts > max_restarts:
                        raise
                    if on_restart is not None:
                        on_restart(restarts, delivered, exc)
                    break          # rebuild the stream from ``delivered``
                delivered += 1
                yield item
        finally:
            it.close()
