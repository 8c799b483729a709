"""Seed-node loaders: shuffled epochs, static batch shapes, a host
double buffer.

Port of ``src/repro/sampling/loader.py``. Every batch is padded to
exactly ``batch_size`` seeds (the real count rides along for loss
masking), and the epoch permutation is the reference's numpy generator
keyed ``(seed, epoch)``, so both packages walk the same batches in the
same order. :func:`prefetch` runs a (sample + pack) generator one item
(or ``depth`` items) ahead in a background thread, so the host prepares
batch *b+1* while the device runs batch *b*; :func:`resilient_prefetch`
rebuilds a dead producer from the count of items already delivered, a
bounded number of times.

Data parallelism: :func:`shard_seeds` splits a seed set round-robin over
a mesh's ``'data'`` axis, and ``seed_batches(..., num_shards=,
shard_index=)`` walks one shard of the epoch permutation all shards
agree on. **Lockstep contract**: once the step carries a collective (the
gradient sync of ``train/gnn_minibatch``), every shard must take the
same number of steps an epoch, or the odd one waits forever in the
collective. Round-robin shard lengths differ by up to one, so
``seed_batches`` pads every shard to the common count
(:func:`num_seed_batches`): a shorter shard's tail is a full-size batch
with ``n_real == 0`` (a fully masked loss, zero local gradient, still in
the collective).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch import obs

__all__ = ["seed_batches", "shard_seeds", "num_seed_batches", "prefetch",
           "resilient_prefetch"]


def shard_seeds(seeds, mesh, *, axis: str = "data") -> list[np.ndarray]:
    """Partition ``seeds`` over ``mesh``'s ``axis``, one array a shard,
    round-robin (so R-MAT's id-local communities skew no shard); an axis
    absent from the mesh means one shard."""
    from repro_torch.dist.mesh import axis_shard_count
    n = axis_shard_count(mesh, axis)
    seeds = np.asarray(seeds)
    return [seeds[i::n] for i in range(n)]


def num_seed_batches(n_seeds: int, batch_size: int, drop_last: bool = False,
                     *, num_shards: int = 1) -> int:
    """Batches *each shard* yields an epoch under the lockstep contract:
    without ``drop_last`` the longest shard's count
    (``ceil(ceil(n / shards) / batch)``), shorter shards padding with
    ``n_real == 0`` tail batches; with ``drop_last`` the shortest
    shard's (``floor(floor(n / shards) / batch)``). Either way it does not
    depend on the shard index."""
    num_shards = max(int(num_shards), 1)
    if drop_last:
        return (n_seeds // num_shards) // batch_size
    longest = -(-n_seeds // num_shards)
    return -(-longest // batch_size)


def seed_batches(seeds, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, epoch: int = 0, drop_last: bool = False,
                 num_shards: int = 1, shard_index: int = 0,
                 ) -> Iterator[tuple[np.ndarray, int]]:
    """Yield ``(padded_seeds, n_real)`` minibatches of seed node ids.

    ``padded_seeds`` always has ``batch_size`` entries: a short tail batch
    repeats its first seed, an empty lockstep tail its shard's first seed
    (the trainer masks the pads out of the loss and routes them to the
    sentinel before device sampling). The permutation is deterministic per
    ``(seed, epoch)`` and the same for every shard; shard
    ``shard_index`` walks its round-robin slice of it, so the shards'
    real seeds are one pass over ``seeds``. Every shard yields
    ``num_seed_batches(len(seeds), batch_size, drop_last,
    num_shards=num_shards)`` batches."""
    ids = np.asarray(seeds)
    if shuffle:
        rng = np.random.default_rng((int(seed), int(epoch)))
        ids = ids[rng.permutation(len(ids))]
    shard = ids[shard_index::num_shards] if num_shards > 1 else ids
    n_batches = num_seed_batches(len(ids), batch_size, drop_last,
                                 num_shards=num_shards)
    # the lockstep invariant: the common count covers every shard's real
    # batches, and under drop_last every shard can fill it
    real = (len(shard) // batch_size if drop_last
            else -(-len(shard) // batch_size))
    if (real > n_batches) if not drop_last else (real < n_batches):
        raise AssertionError((len(ids), num_shards, shard_index, real,
                              n_batches))
    pad_value = shard[0] if len(shard) else (ids[0] if len(ids) else 0)
    for b in range(n_batches):
        chunk = shard[b * batch_size: (b + 1) * batch_size]
        n_real = len(chunk)
        if n_real < batch_size:
            pad = np.full(batch_size - n_real,
                          chunk[0] if n_real else pad_value, ids.dtype)
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
