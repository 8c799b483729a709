"""Online GNN inference serving: ego-sampled micro-batched prediction.

:class:`GNNServer` turns layer-keyed GraphSAGE/GIN weights into a
synchronous ``predict(seeds) -> logits`` service on one device:

* callers' requests coalesce in a :class:`~.batcher.MicroBatcher` (flush
  on ``max_batch`` or the ``max_delay_s`` latency SLO, whichever first);
* each flush samples one ego network around the union of its seed sets
  with the host :class:`~repro_torch.sampling.NeighborSampler` —
  full-neighbor (``mode="full"``, exact) or fixed-fanout
  (``mode="sampled"``, deterministic per ``(seed, flush index)``);
* the blocks ride the bucket ladder and
  :class:`~repro_torch.sampling.BlockPlanCache` (TuningDB-persisted
  plans), are packed on the host and moved to the device, where sum/mean
  aggregation runs the hand-written ELL/SELL kernels;
* features come from the device-resident LRU
  :class:`~.feature_cache.FeatureCache`.

``mode="historical"`` serves one full-neighbour hop over cached
layer-(L-1) embeddings plus the final layer; the embedding matrix comes
from the exact offline sweep
(:func:`~repro_torch.train.gnn_minibatch.layerwise_inference` with
``upto=L-1``), and :meth:`GNNServer.refresh_embeddings` recomputes it and
bumps the cache epoch, so stale entries read as misses and refill.
:meth:`GNNServer.offline_logits` is the exact offline answer for every
node through the same plan cache.

The serve step is the training forward of the reference
(``make_block_model``'s ``apply_blocks``), called directly: PyTorch runs
eagerly, so where the reference jit-compiles the apply once per bucket,
here the bucket ladder only bounds the shapes.

Threading: one daemon serve loop owns all device work; callers only
enqueue tickets and block on them. ``start=False`` skips the thread —
tests drive flushes with :meth:`GNNServer.run_pending`. An exception in
a flush fails that flush's tickets; the server keeps serving.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import sparse as sp
from repro_torch.core.patch import patched
from repro_torch.sampling import (BlockPlanCache, NeighborSampler, pack_block,
                                  plan_buckets)
from repro_torch.serving.batcher import Flush, MicroBatcher, Ticket
from repro_torch.serving.feature_cache import FeatureCache
from repro_torch.train.gnn_minibatch import (_block_arch,
                                             layerwise_inference,
                                             make_block_model)

__all__ = ["GNNServer", "SERVE_MODES"]

SERVE_MODES = ("full", "sampled", "historical")


def _infer_dims(params) -> list[int]:
    """Per-layer dims from the layer-keyed params."""
    dims = []
    for i in range(len(params)):
        p = params[f"l{i}"]
        if "w_self" in p:                        # sage
            d_in, d_out = p["w_self"].shape
        else:                                    # gin
            d_in, d_out = p["w1"].shape[0], p["w2"].shape[1]
        dims.append(int(d_in))
        if i == len(params) - 1:
            dims.append(int(d_out))
    return dims


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises
    (no quiet move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class GNNServer:
    """Micro-batched online inference over one graph + trained params.

    ``dataset`` is a ``repro_torch.data.GraphDataset``; ``params`` the
    layer-keyed weights (moved to ``device``). ``mode``: ``"full"`` (every
    hop takes the full in-neighborhood) or ``"sampled"`` (``fanouts``
    neighbors per hop, outermost first) or ``"historical"`` (one
    full-neighbour hop over the cached layer-(L-1) embeddings and the
    final layer; :meth:`refresh_embeddings` after weight or feature
    updates). ``cache_capacity`` rows of features (or historical
    embeddings) stay on the device. ``tune=False`` pins every block plan
    to the trusted segment reduce. ``faults`` (a
    ``repro_torch.testing.FaultPlan``) injects a failure before a flush
    (``flush_exception_at``): that flush's tickets fail with it and the
    server goes on serving. ``device`` defaults to the card.
    """

    def __init__(self, params, dataset, *, arch: str = "sage-sum",
                 fanouts=(10, 10), mode: str = "full",
                 max_batch: int = 64, max_delay_s: float = 0.010,
                 cache_capacity: int = 4096,
                 bucket_base: int = 128, seed_bucket_base: int = 16,
                 tune: bool = True, tuning_db=None, use_isplib: bool = True,
                 sample_seed: int = 0, faults=None, start: bool = True,
                 device="cuda"):
        if mode not in SERVE_MODES:
            raise ValueError(f"mode must be one of {SERVE_MODES}, "
                             f"got {mode!r}")
        self.device = resolve_device(device)
        self.arch = arch
        self.mode = mode
        self.fanouts = tuple(fanouts)
        self.use_isplib = bool(use_isplib)
        self.bucket_base = int(bucket_base)
        self.faults = faults
        self.params = {layer: {k: v.to(self.device) for k, v in p.items()}
                       for layer, p in params.items()}
        self.dims = _infer_dims(self.params)
        self.n_layers = len(self.dims) - 1
        assert self.n_layers == len(self.fanouts), \
            (self.n_layers, self.fanouts)
        _, semiring = _block_arch(arch)

        csr = sp.csr_from_coo(dataset.coo)
        self.num_nodes = int(csr.nrows)
        self.x = dataset.x
        self.sampler = NeighborSampler(csr, self.fanouts, seed=sample_seed)
        self.plan_cache = BlockPlanCache(semiring=semiring, tune=tune,
                                         db=tuning_db)
        _, _, self._apply_blocks, _ = make_block_model(
            arch, self.dims[0], self.dims[1] if self.n_layers > 1
            else self.dims[-1], self.dims[-1], self.n_layers)
        # raw features, or (historical) the layer-(L-1) embedding matrix
        self.cache = FeatureCache(
            self._hidden_matrix() if mode == "historical" else dataset.x,
            cache_capacity, device=self.device)

        self.batcher = MicroBatcher(max_batch, max_delay_s,
                                    bucket_base=seed_bucket_base)
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()        # stats below
        self.flushes = 0
        self.flush_errors = 0
        self.served_requests = 0
        self.latencies_s: list[float] = []
        self.queue_waits_s: list[float] = []
        self.flush_sizes: list[int] = []
        if start:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="gnn-serve-loop")
            self._thread.start()

    # -- request API ------------------------------------------------------
    def submit(self, seeds: Sequence[int]) -> Ticket:
        """Enqueue one request (unique node ids) and return its ticket
        without blocking. Validation errors raise here, in the caller."""
        arr = np.asarray(seeds, np.int64).ravel()
        if arr.size and (arr.min() < 0 or arr.max() >= self.num_nodes):
            raise ValueError(f"seed ids out of range [0, {self.num_nodes})")
        if np.unique(arr).size != arr.size:
            raise ValueError("seed ids within one request must be unique")
        t = self.batcher.submit(arr)
        with self._cv:
            self._cv.notify()
        return t

    def predict(self, seeds: Sequence[int], timeout: Optional[float] = 30.0
                ) -> np.ndarray:
        """Synchronous inference: ``(len(seeds), num_classes)`` logits."""
        t = self.submit(seeds)
        if self._thread is None:
            self.run_pending(force=True)
        return t.result(timeout)

    # -- serve loop -------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            fl = self.batcher.next_flush()
            if fl is not None:
                self._execute(fl)
                continue
            dl = self.batcher.deadline()
            now = time.monotonic()
            wait = 0.05 if dl is None else min(max(dl - now, 1e-4), 0.05)
            with self._cv:
                if self._stop.is_set():
                    break
                self._cv.wait(timeout=wait)
        for fl in self.batcher.drain():
            self._execute(fl)

    def run_pending(self, *, force: bool = False, now: Optional[float] = None
                    ) -> int:
        """Drive the batcher from the calling thread (``start=False``):
        execute every composable flush (all of them when ``force``).
        Returns the number of flushes executed."""
        n = 0
        if force:
            for fl in self.batcher.drain():
                self._execute(fl)
                n += 1
            return n
        while True:
            fl = self.batcher.next_flush(now)
            if fl is None:
                return n
            self._execute(fl)
            n += 1

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the serve loop, draining (and answering) anything queued."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for fl in self.batcher.drain():
            self._execute(fl)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- flush execution ---------------------------------------------------
    def sample_blocks(self, uniq: np.ndarray, flush_index: int):
        """(blocks, fanouts-for-bucketing, params-view) for one flush's
        unique seeds."""
        if self.mode == "historical":
            # one full-neighbour hop over the historical matrix + last layer
            return ([self.sampler.full_block(uniq)], (None,),
                    {"l0": self.params[f"l{self.n_layers - 1}"]})
        if self.mode == "full":
            fo = (None,) * self.n_layers
            return self.sampler.sample(uniq, round=flush_index,
                                       fanouts=fo), fo, self.params
        return (self.sampler.sample(uniq, round=flush_index), self.fanouts,
                self.params)

    def _execute(self, flush: Flush) -> None:
        t_exec = time.monotonic()
        waits = [t_exec - t.submitted_at for t in flush.tickets]
        if obs.enabled():
            tracer = obs.get_tracer()
            now_ns = time.perf_counter_ns()
            for w in waits:
                dur = int(w * 1e9)
                tracer.add_span("serve.queue_wait", now_ns - dur, dur,
                                flush=flush.index)
        try:
            if self.faults is not None:
                self.faults.before_flush(flush.index)
            with obs.span("serve.flush", index=flush.index,
                          n_real=flush.n_real, n_tickets=len(flush.tickets)):
                out = self.run_flush(flush)
        except Exception as exc:                # the boundary: to tickets
            now = time.monotonic()
            with self._lock:
                self.flushes += 1
                self.flush_errors += 1
            if obs.enabled():
                obs.metrics().counter("serve.flush_errors").inc()
            for t in flush.tickets:
                t.fail(exc, now)
            return
        now = time.monotonic()
        with self._lock:
            self.flushes += 1
            self.served_requests += len(flush.tickets)
            self.flush_sizes.append(flush.n_real)
            self.queue_waits_s.extend(waits)
            for t in flush.tickets:
                t.flush_index = flush.index
                self.latencies_s.append(now - t.submitted_at)
        if obs.enabled():
            reg = obs.metrics()
            reg.counter("serve.requests").inc(len(flush.tickets))
            reg.counter("serve.flushes").inc()
            lat_h = reg.histogram("serve.latency_s")
            for t in flush.tickets:
                lat_h.observe(now - t.submitted_at)
            wait_h = reg.histogram("serve.queue_wait_s")
            for w in waits:
                wait_h.observe(w)
        for t, sl in zip(flush.tickets, flush.splits()):
            t.fill(out[sl], now)

    def pack_flush(self, blocks, fo, bucket: int):
        """(packed blocks on the device, layer buckets) for one flush."""
        buckets = plan_buckets(blocks, batch_size=bucket, fanouts=fo,
                               base=self.bucket_base)
        # per-layer operand widths: the cache's row width feeds the
        # outermost block; deeper blocks see the hidden dims
        first = self.n_layers - len(blocks)       # historical: the last
        ks = [self.cache.k] + [self.dims[first + i]
                               for i in range(1, len(blocks))]
        pbs = []
        for blk, bk, k in zip(blocks, buckets, ks):
            plan = self.plan_cache.plan_for(blk, n_dst=bk.n_dst,
                                            n_src=bk.n_src, nnz=bk.nnz,
                                            k_hint=k)
            pb = pack_block(blk, n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz,
                            plan=plan, ell_width=bk.ell_width,
                            sell_steps=bk.sell_steps)
            pbs.append(sp.to_device(pb, self.device))
        return pbs, buckets

    def run_flush(self, flush: Flush) -> np.ndarray:
        """Sample, pack, gather, apply — one micro-batch end to end, under
        the server's patch state. Returns per-submitted-seed logit rows in
        seed order. A flush's result depends only on its seeds, index
        (the sampling round) and bucket, so another server over the same
        graph and params recomputes it from those three."""
        with patched(self.use_isplib):
            return self._run_model(flush)

    def _run_model(self, flush: Flush) -> np.ndarray:
        with obs.span("serve.sample", n_seeds=int(flush.seeds.size)):
            uniq, inverse = np.unique(flush.seeds, return_inverse=True)
            blocks, fo, params = self.sample_blocks(uniq, flush.index)
        with obs.span("serve.pack"):
            pbs, buckets = self.pack_flush(blocks, fo, flush.bucket)
        # the outermost block's padded source ids, with the cache's
        # padding sentinel (== num_rows -> zero row)
        with obs.span("serve.gather", n_src=int(buckets[0].n_src)):
            src = np.full(buckets[0].n_src, self.cache.num_rows, np.int64)
            src[: blocks[0].n_src] = blocks[0].src_ids
            h = self.cache.gather(src)
        with obs.span("serve.apply"):
            out = self._apply_blocks(params, pbs, h)
            out = out.cpu().numpy()    # device sync: the span ends honest
        return out[: len(uniq)][inverse]

    # -- historical embeddings and the offline answer ----------------------
    def _layerwise(self, upto=None) -> torch.Tensor:
        with patched(self.use_isplib):
            return layerwise_inference(
                self.params, self.sampler, self.x.to(self.device),
                arch=self.arch, dims=self.dims, plan_cache=self.plan_cache,
                bucket_base=self.bucket_base, upto=upto)

    def _hidden_matrix(self) -> np.ndarray:
        """The offline sweep up to the penultimate layer: the historical
        matrix (``x`` itself for a 1-layer model)."""
        return self._layerwise(upto=self.n_layers - 1).cpu().numpy()

    def refresh_embeddings(self) -> None:
        """Recompute the historical layer-(L-1) matrix offline and publish
        it under a bumped cache epoch: stale entries turn into misses and
        refill from the new matrix."""
        assert self.mode == "historical", self.mode
        self.cache.set_epoch(self.cache.epoch + 1,
                             fallback=self._hidden_matrix())

    def offline_logits(self) -> np.ndarray:
        """The exact offline answer for every node: the layer-wise
        full-neighbour sweep through the same plan cache."""
        return self._layerwise().cpu().numpy()

    # -- telemetry -----------------------------------------------------------
    def latency_stats(self) -> dict:
        """p50/p99/mean request latency, queue-wait percentiles and flush
        counters so far; every key is always present (0.0 when idle)."""
        with self._lock:
            lat = np.asarray(self.latencies_s, np.float64)
            waits = np.asarray(self.queue_waits_s, np.float64)
            sizes = list(self.flush_sizes)
            out = dict(requests=self.served_requests, flushes=self.flushes,
                       flush_errors=self.flush_errors,
                       cache_hit_rate=self.cache.stats.hit_rate)
        out.update(
            p50_ms=float(np.percentile(lat, 50) * 1e3) if len(lat) else 0.0,
            p99_ms=float(np.percentile(lat, 99) * 1e3) if len(lat) else 0.0,
            mean_ms=float(lat.mean() * 1e3) if len(lat) else 0.0,
            queue_wait_p50_ms=(float(np.percentile(waits, 50) * 1e3)
                               if len(waits) else 0.0),
            queue_wait_p99_ms=(float(np.percentile(waits, 99) * 1e3)
                               if len(waits) else 0.0),
            mean_flush_size=float(np.mean(sizes)) if sizes else 0.0)
        return out
