"""Minibatch neighbour-sampled GNN training + exact layer-wise inference.

Port of ``src/repro/train/gnn_minibatch.py`` for one device. Each step
trains on a seed minibatch expanded by a k-hop sampler:

* ``sampler="host"`` — the numpy :class:`~repro_torch.sampling.
  NeighborSampler` samples, the bucket ladder and
  :class:`~repro_torch.sampling.BlockPlanCache` size and plan every
  block, ``pack_block`` packs it on the host, and a prefetch thread
  (``sampling.loader.prefetch``) does all that one batch ahead of the
  device;
* ``sampler="device"`` — the graph moves to the device once
  (``sampling.device_graph``) and every step samples, relabels and packs
  on the device (``kernels/sample``'s hand kernels on the card) before
  its forward and backward. The host feeds only the seed ids (one copy
  per epoch) and the round counter. The reference fuses sample + pack +
  step into one jitted program; here the same property is that a step
  never waits on the host: nothing in it reads the device. Finite fanouts
  and sum/mean aggregation only (device capacity padding is inert under
  sum).

Evaluation is exact: :func:`layerwise_inference` sweeps every node
through each layer over full neighbourhoods. ``use_isplib`` flips the
patch registry (tuned packed kernels vs trusted segment ops). The
params are the reference's layer-keyed dict, so ``params_from_jax``
weights start a run here as they start one there.

The non-finite guard (``skip_nonfinite``) decides on the device: a
non-finite loss or gradient zeroes the gradients and keeps the old params
and Adam moments by ``torch.where``; the skip is counted in device
counters read once per epoch. The AdamW step count is a device tensor
held by the same select, so a skipped step leaves the bias corrections
where they were, as in the reference.

Data parallelism, checkpoint/resume, fault injection, the straggler
watchdog and measured tuning come with later slices (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import sparse as sp
from repro_torch.core.patch import patched
from repro_torch.models.gnn import layers as L
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.optimizer import tree_map
from repro_torch.sampling import (BlockPlanCache, DeviceSampler,
                                  NeighborSampler, block_spmm_global,
                                  device_graph_from_csr, gather_rows,
                                  num_seed_batches, pack_block, plan_buckets,
                                  prefetch, round_bucket, seed_batches)
from repro_torch.train.gnn import accuracy, loss_and_grads

__all__ = ["MB_ARCHS", "SAMPLERS", "MinibatchTrainResult",
           "make_block_model", "init_step_stats", "make_minibatch_step",
           "make_device_minibatch_step", "layerwise_inference",
           "train_gnn_minibatch"]

MB_ARCHS = ("sage-sum", "sage-mean", "sage-max", "gin")
SAMPLERS = ("host", "device")


@dataclasses.dataclass
class MinibatchTrainResult:
    """What a run did. The reference's trace counts (``n_traces``) have no
    counterpart in eager PyTorch and are left out; ``first_epoch_s`` is
    the epoch the reference calls its compile epoch."""

    arch: str
    dataset: str
    use_isplib: bool
    fanouts: tuple
    batch_size: int
    losses: list
    train_acc: float
    test_acc: float
    epoch_time_s: float      # mean wall-clock of the epochs after the first
    first_epoch_s: float     # the first epoch (kernel builds, warm-up)
    infer_time_s: float      # one layer-wise full-neighbour inference pass
    n_buckets: int           # distinct bucket signatures seen
    plan_kinds: tuple        # kernel kinds the bucket plans picked
    epochs: int
    steps_per_epoch: int
    sampler: str = "host"
    sample_time_s: float = 0.0     # the sample(+pack) stage of one epoch
    skipped_steps: int = 0         # updates skipped by the non-finite guard
    overflow_edges: int = 0        # device-sampler capacity-dropped edges
    capacity_escalations: int = 0  # device capacity doublings
    probed_caps: Optional[tuple] = None   # device capacities, first build
    src_caps: Optional[tuple] = None      # device capacities at the end
    device: str = "cuda"
    final_params: Any = dataclasses.field(default=None, repr=False)


def _block_arch(arch: str):
    """(aggr-or-None, semiring) for a minibatch-capable arch."""
    if arch not in MB_ARCHS:
        raise ValueError(f"minibatch arch must be one of {MB_ARCHS}, "
                         f"got {arch!r}")
    if arch == "gin":
        return None, "sum"
    aggr = arch.split("-")[1]
    return aggr, aggr


def make_block_model(arch: str, in_dim: int, hidden: int, out_dim: int,
                     n_layers: int):
    """init/apply over a block stack, shared by the minibatch trainer and
    online serving. Params are layer-keyed ('l0', 'l1', ...) with the
    reference's per-layer structure.

    Returns ``(init, conv, apply_blocks, dims)``: ``init(generator,
    device="cuda")`` draws the params from a ``torch.Generator``;
    ``conv(p_l, pb, h)`` applies one layer over one packed block;
    ``apply_blocks(params, pbs, h)`` folds a whole block stack with
    inter-layer relu (none after the last layer)."""
    aggr, _ = _block_arch(arch)
    dims = [in_dim] + [hidden] * (n_layers - 1) + [out_dim]
    init_one = L.init_gin if arch == "gin" else L.init_sage

    def init(generator: torch.Generator, device="cuda"):
        return {f"l{i}": init_one(generator, dims[i], dims[i + 1],
                                  device=device)
                for i in range(n_layers)}

    def conv(p_l, pb, h):
        if arch == "gin":
            return L.gin_conv_block(p_l, pb, h)
        return L.sage_conv_block(p_l, pb, h, aggr=aggr)

    def apply_blocks(params, pbs, h):
        for i, pb in enumerate(pbs):
            h = conv(params[f"l{i}"], pb, h)
            if i < len(pbs) - 1:
                h = torch.relu(h)
        return h

    return init, conv, apply_blocks, dims


def init_step_stats(device="cuda") -> obs.DeviceCounters:
    """The counters a step carries on the device: ``skipped`` (updates
    vetoed by the non-finite guard) and ``overflow`` (device-sampler
    capacity-dropped edges). ``drain()`` reads them, once per epoch."""
    return obs.device_counters("skipped", "overflow", device=device)


def _step_tail(opt, p, s, loss, grads, stats, ovf, *,
               skip_nonfinite: bool):
    """Everything between the gradients and the applied update, shared by
    both samplers: the non-finite guard, decided and applied on the device
    (gradients zeroed, then the new params and the whole Adam state, step
    count included, discarded by ``torch.where`` when anything was
    non-finite), the update, and the counters."""
    ok = None
    if skip_nonfinite:
        flat: list = []
        tree_map(flat.append, grads)
        ok = torch.isfinite(loss)
        for g in flat:
            ok = ok & torch.isfinite(g).all()
        grads = tree_map(lambda g: torch.where(ok, g, 0.0), grads)
        loss = torch.where(torch.isfinite(loss), loss, 0.0)
    updates, s_new = opt.update(grads, s, p)
    p_new = apply_updates(p, updates)
    if skip_nonfinite:
        keep = lambda a, b: torch.where(ok, a, b)     # noqa: E731
        p_new = tree_map(keep, p_new, p)
        s_new = type(s_new)(*(tree_map(keep, a, b)
                              for a, b in zip(s_new, s)))
        stats = stats.add("skipped", (~ok).to(torch.int32))
    if ovf is not None:
        stats = stats.add("overflow", ovf)
    return p_new, s_new, loss, grads, stats


def make_minibatch_step(apply_blocks, opt, *, batch_size: int,
                        skip_nonfinite: bool = True):
    """The host-sampled update: ``step(params, opt_state, pbs, seed_ids,
    n_real, x, y, stats) -> (params, opt_state, loss, grads, stats)``.
    ``pbs`` are packed blocks on the device, ``seed_ids`` the padded
    ``(batch_size,)`` seed tensor there, ``n_real`` the host count of
    real seeds (the rest are masked out of the loss)."""

    def step(p, s, pbs, seed_ids, n_real, x, y, stats):
        mask = torch.arange(batch_size, device=x.device) < n_real
        h = gather_rows(x, pbs[0].src_ids)
        loss, grads = loss_and_grads(apply_blocks, p, pbs, h,
                                     y[seed_ids.long()], mask)
        return _step_tail(opt, p, s, loss, grads, stats, None,
                          skip_nonfinite=skip_nonfinite)

    return step


def make_device_minibatch_step(apply_blocks, opt, dev_sampler, *,
                               batch_size: int,
                               skip_nonfinite: bool = True):
    """The device-sampled update: ``step(params, opt_state, seeds, n_real,
    rnd, x, y, stats) -> (params, opt_state, loss, grads, stats)``.

    ``seeds`` is the padded ``(batch_size,)`` seed tensor on the device,
    ``n_real`` and the round counter ``rnd`` host ints. Pad seeds are
    routed to the ``num_nodes`` sentinel before sampling (degree-0
    frontier rows, inert blocks) and masked out of the loss. Sampling runs
    outside autograd (it is integer work), and its capacity-overflow count
    joins the device counters. Nothing in the step reads the device."""
    num_nodes = dev_sampler.graph.num_nodes

    def step(p, s, seeds, n_real, rnd, x, y, stats):
        mask = torch.arange(batch_size, device=seeds.device) < n_real
        with torch.no_grad():
            pbs, ovf = dev_sampler.sample_blocks_stats(
                torch.where(mask, seeds, num_nodes), rnd)
        h = gather_rows(x, pbs[0].src_ids)
        loss, grads = loss_and_grads(apply_blocks, p, pbs, h,
                                     y[seeds.long()], mask)
        return _step_tail(opt, p, s, loss, grads, stats, ovf,
                          skip_nonfinite=skip_nonfinite)

    return step


@torch.no_grad()
def layerwise_inference(params, sampler: NeighborSampler, x: torch.Tensor,
                        *, arch: str, dims: list[int],
                        plan_cache: BlockPlanCache, batch_size: int = 1024,
                        bucket_base: int = 128,
                        upto: Optional[int] = None) -> torch.Tensor:
    """Exact logits for every node, one layer at a time (the DGL inference
    pattern): layer l runs for *all* nodes over their *full*
    neighbourhoods before layer l+1 starts, so the result has no sampling
    noise while memory stays O(batch x max_deg x K). Runs on ``x``'s
    device, under the current patch state.

    Blocks ride the same bucket ladder and plan cache as training, packed
    once per batch and plan and reused across layers; the dense operand is
    the full current-layer matrix, so ELL plans read it in place
    (``kernels/ops.gathered_ell_spmm``). ``upto`` stops after that many
    layers and returns the hidden matrix (relu after every computed layer,
    all of them non-final): the historical-embedding matrix of serving."""
    aggr, _ = _block_arch(arch)
    n = sampler.num_nodes
    n_layers = len(dims) - 1
    n_run = n_layers if upto is None else int(upto)
    assert 0 <= n_run <= n_layers, (upto, n_layers)
    device = x.device

    def infer_layer(p_l, pb, h, relu_after):
        agg = block_spmm_global(pb, h, aggr or "sum")
        pos = pb.dst_pos.long()
        dst_gids = torch.where(pos < pb.n_src,
                               pb.src_ids[pos.clamp(0, pb.n_src - 1)],
                               h.shape[0])
        h_dst = gather_rows(h, dst_gids)
        if arch == "gin":
            z = (1.0 + p_l["eps"]) * h_dst + agg
            z = torch.relu(z @ p_l["w1"] + p_l["b1"])
            out = z @ p_l["w2"] + p_l["b2"]
        else:
            out = h_dst @ p_l["w_self"] + agg @ p_l["w_neigh"] + p_l["b"]
        return torch.relu(out) if relu_after else out

    batches = []
    for lo in range(0, n, batch_size):
        dst = np.arange(lo, min(lo + batch_size, n))
        blk = sampler.full_block(dst)
        sizes = dict(n_dst=batch_size,
                     n_src=round_bucket(blk.n_src, base=bucket_base),
                     nnz=round_bucket(blk.nnz, base=bucket_base))
        width = round_bucket(int(blk.degrees().max()) if blk.nnz else 1,
                             base=8)
        batches.append((dst, blk, sizes, width, {}))

    h = x
    for li in range(n_run):
        rows = []
        for dst, blk, sizes, width, packed in batches:
            plan = plan_cache.plan_for(blk, k_hint=h.shape[1], **sizes)
            psig = (plan.kind, plan.sell_c, plan.sell_sigma)
            pb = packed.get(psig)
            if pb is None:
                pb = packed[psig] = sp.to_device(
                    pack_block(blk, plan=plan, ell_width=width, **sizes),
                    device)
            out = infer_layer(params[f"l{li}"], pb, h,
                              relu_after=li < n_layers - 1)
            rows.append(out[: len(dst)])
        h = torch.cat(rows, dim=0)
    return h


def train_gnn_minibatch(arch: str, dataset, *, fanouts=(10, 10),
                        batch_size: int = 256, hidden: int = 128,
                        epochs: int = 5, lr: float = 1e-2,
                        weight_decay: float = 5e-4, use_isplib: bool = True,
                        tune: bool = True, seed: int = 0,
                        bucket_base: int = 128, infer_batch: int = 1024,
                        sampler: str = "host", skip_nonfinite: bool = True,
                        device_caps=None, max_escalations: int = 2,
                        params: dict | None = None, profile: bool = False,
                        device="cuda") -> MinibatchTrainResult:
    """Neighbour-sampled minibatch training on ``dataset`` (a
    ``data.graphs.GraphDataset``), one layer per fanout entry (outermost
    first), on ``device``.

    The initial weights come from a ``torch.Generator`` seeded with
    ``seed`` unless ``params`` hands over a starting point (a test starts
    both packages from the same weights that way). Epoch ``e``, batch
    ``b`` samples with round ``e * 100003 + b`` on either sampler, as the
    reference does.

    ``sampler="device"`` samples on the device (see the module
    docstring). Its per-hop capacities are probed from three host-sampled
    batches (1.5x the largest source count seen), unless ``device_caps``
    (innermost first) pins them; the per-layer plans come from the same
    ``BlockPlanCache`` sweep as the host path, restricted to ELL/trusted.
    Edges dropped to capacity overflow are counted on the device; at an
    epoch boundary with new drops the capacities double and the sampler is
    rebuilt, at most ``max_escalations`` times.

    ``profile=True`` turns the ``repro_torch.obs`` tracer on for the run
    (if it is off): ``train.epoch`` / ``train.step`` / ``train.infer`` and,
    on the host path, ``loader.sample`` / ``loader.pack`` / ``loader.h2d``
    / ``loader.stall`` spans, with a device sync after every step
    (attribution mode, not benchmarking)."""
    _, semiring = _block_arch(arch)
    n_layers = len(fanouts)
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS}, "
                         f"got {sampler!r}")
    if sampler == "device":
        if semiring not in ("sum", "mean"):
            raise ValueError("sampler='device' supports sum/mean "
                             "aggregation only (capacity padding is inert "
                             f"under sum); arch {arch!r} needs {semiring}")
        if any(f is None for f in fanouts):
            raise ValueError("sampler='device' needs finite fanouts")
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    with contextlib.ExitStack() as ctx:
        if profile and not obs.enabled():
            ctx.enter_context(obs.profiled(ops=True, fresh=False))
        ctx.enter_context(patched(use_isplib))
        csr = sp.csr_from_coo(dataset.coo)
        host_sampler = NeighborSampler(csr, fanouts, seed=seed)
        init, _, apply_blocks, dims = make_block_model(
            arch, dataset.num_features, hidden, dataset.num_classes,
            n_layers)
        if params is None:
            params = init(torch.Generator().manual_seed(seed), device=device)
        else:
            params = tree_map(lambda p: p.detach().to(device, torch.float32)
                              .clone(), params)
        opt = adamw(lr, weight_decay=weight_decay)
        opt_state = opt.init(params)
        plan_cache = BlockPlanCache(semiring=semiring, tune=tune)
        train_ids = np.nonzero(dataset.train_mask.numpy())[0]
        x = dataset.x.to(device)
        y = dataset.y.to(device)
        steps_per_epoch = num_seed_batches(len(train_ids), batch_size)

        dev = probed = src_caps = None
        if sampler == "device":
            dgraph = device_graph_from_csr(csr, device=device)
            probe = [host_sampler.sample(
                train_ids[: min(batch_size, len(train_ids))], round=r)
                for r in range(3)]
            probed = [int(1.5 * max(p[n_layers - 1 - j].n_src
                                    for p in probe))
                      for j in range(n_layers)]
            src_caps = [int(c) for c in device_caps] \
                if device_caps is not None else list(probed)

            def build_device(caps):
                d = DeviceSampler(dgraph, fanouts, batch_size=batch_size,
                                  seed=seed, base=bucket_base, src_caps=caps)
                d.set_plans([
                    plan_cache.plan_for(blk, n_dst=bk.n_dst, n_src=bk.n_src,
                                        nnz=bk.nnz, k_hint=k, sell_ok=False)
                    for blk, bk, k in zip(probe[0], d.buckets, dims)])
                return d, make_device_minibatch_step(
                    apply_blocks, opt, d, batch_size=batch_size,
                    skip_nonfinite=skip_nonfinite)

            dev, step = build_device(src_caps)
        else:
            step = make_minibatch_step(apply_blocks, opt,
                                       batch_size=batch_size,
                                       skip_nonfinite=skip_nonfinite)

        signatures: set = set()
        stats = init_step_stats(device)

        def epoch_batches(epoch: int):
            return list(seed_batches(train_ids, batch_size, shuffle=True,
                                     seed=seed, epoch=epoch))

        def pack_all(blocks, buckets):
            pbs = []
            for blk, bk, k in zip(blocks, buckets, dims):
                plan = plan_cache.plan_for(blk, n_dst=bk.n_dst,
                                           n_src=bk.n_src, nnz=bk.nnz,
                                           k_hint=k)
                pbs.append(pack_block(
                    blk, n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz,
                    plan=plan, ell_width=bk.ell_width,
                    sell_steps=bk.sell_steps))
            return pbs

        def batch_stream(epoch: int):
            """Host half of the pipeline (the prefetch thread): sample,
            bucket, pack and move one batch per step."""
            for bi, (seed_ids, n_real) in enumerate(epoch_batches(epoch)):
                with obs.span("loader.sample", batch=bi):
                    blocks = host_sampler.sample(
                        seed_ids[:n_real], round=epoch * 100003 + bi)
                with obs.span("loader.pack", batch=bi):
                    buckets = plan_buckets(blocks, batch_size=batch_size,
                                           fanouts=fanouts,
                                           base=bucket_base)
                    pbs = pack_all(blocks, buckets)
                sig = tuple(pb.bucket_signature for pb in pbs)
                with obs.span("loader.h2d", batch=bi):
                    pbs = [sp.to_device(pb, device) for pb in pbs]
                    sids = torch.from_numpy(seed_ids).to(device)
                yield pbs, sids, n_real, sig

        def run_epoch(epoch: int):
            nonlocal params, opt_state, stats
            last = None
            for bi, (pbs, sids, n_real, sig) in enumerate(
                    prefetch(batch_stream(epoch))):
                signatures.add(sig)
                with obs.span("train.step",
                              step=epoch * steps_per_epoch + bi):
                    params, opt_state, last, _, stats = step(
                        params, opt_state, pbs, sids, n_real, x, y, stats)
                    if profile:   # the span times execution, not enqueue
                        sync()
            return last

        def run_epoch_device(epoch: int):
            """The host feeds the epoch's seeds (one copy) and the round
            counter; sampling, packing and the update run on the device."""
            nonlocal params, opt_state, stats
            batches = epoch_batches(epoch)
            seeds = torch.from_numpy(
                np.stack([b[0] for b in batches]).astype(np.int32)).to(device)
            last = None
            for bi, (_, n_real) in enumerate(batches):
                signatures.add(dev.signature)
                with obs.span("train.step",
                              step=epoch * steps_per_epoch + bi,
                              sampler="device"):
                    params, opt_state, last, _, stats = step(
                        params, opt_state, seeds[bi], n_real,
                        epoch * 100003 + bi, x, y, stats)
                    if profile:
                        sync()
            return last

        epoch_fn = run_epoch_device if sampler == "device" else run_epoch
        losses: list = []
        first_epoch = later = 0.0
        escalations = ovf_seen = 0
        for ep in range(epochs):
            t0 = time.perf_counter()
            with obs.span("train.epoch", epoch=ep):
                loss = epoch_fn(ep)
                sync()
            dt = time.perf_counter() - t0
            if ep == 0:
                first_epoch = dt
            else:
                later += dt
            losses.append(float(loss))          # once per epoch
            if dev is not None:
                # capacity-overflow escalation, at the epoch boundary
                ovf_now = int(stats["overflow"])
                if ovf_now > ovf_seen and escalations < max_escalations:
                    escalations += 1
                    src_caps = [2 * c for c in src_caps]
                    warnings.warn(
                        f"device sampler dropped {ovf_now - ovf_seen} edges "
                        f"to capacity overflow in epoch {ep}; escalating "
                        f"capacities to {src_caps} "
                        f"({escalations}/{max_escalations})")
                    dev, step = build_device(src_caps)
                ovf_seen = ovf_now
        epoch_time = later / (epochs - 1) if epochs > 1 else first_epoch

        def measure_sample_stage() -> float:
            """Wall-clock of the sample(+pack) stage alone over epoch 0's
            batches: the numpy sample/bucket/pack loop, or the device
            ``sample_blocks`` (after one warm-up call)."""
            batches = epoch_batches(0)
            if sampler == "device":
                seeds = torch.from_numpy(np.stack(
                    [b[0] for b in batches]).astype(np.int32)).to(device)
                n = dgraph.num_nodes
                ar = torch.arange(batch_size, device=device)

                def samp(bi):
                    return dev.sample_blocks(torch.where(
                        ar < batches[bi][1], seeds[bi], n), bi)
                with torch.no_grad():
                    samp(0)
                    sync()
                    t0 = time.perf_counter()
                    for bi in range(len(batches)):
                        samp(bi)
                    sync()
                return time.perf_counter() - t0
            t0 = time.perf_counter()
            for bi, (sids, nr) in enumerate(batches):
                blocks = host_sampler.sample(sids[:nr], round=bi)
                pack_all(blocks, plan_buckets(blocks, batch_size=batch_size,
                                              fanouts=fanouts,
                                              base=bucket_base))
            return time.perf_counter() - t0

        sample_time = measure_sample_stage()

        t0 = time.perf_counter()
        with obs.span("train.infer"):
            logits = layerwise_inference(params, host_sampler, x, arch=arch,
                                         dims=dims, plan_cache=plan_cache,
                                         batch_size=infer_batch,
                                         bucket_base=bucket_base)
            sync()
        infer_time = time.perf_counter() - t0
        train_acc = float(accuracy(logits, y, dataset.train_mask.to(device)))
        test_acc = float(accuracy(logits, y, dataset.test_mask.to(device)))

        drained = stats.drain()         # the one host read of the counters
        obs.metrics().counter("train.skipped_steps").inc(drained["skipped"])
        obs.metrics().counter("train.overflow_edges").inc(
            drained["overflow"])

    return MinibatchTrainResult(
        arch=arch, dataset=dataset.name, use_isplib=use_isplib,
        fanouts=tuple(fanouts), batch_size=batch_size, losses=losses,
        train_acc=train_acc, test_acc=test_acc, epoch_time_s=epoch_time,
        first_epoch_s=first_epoch, infer_time_s=infer_time,
        n_buckets=len(signatures), plan_kinds=plan_cache.kinds(),
        epochs=epochs, steps_per_epoch=steps_per_epoch, sampler=sampler,
        sample_time_s=sample_time, skipped_steps=drained["skipped"],
        overflow_edges=drained["overflow"],
        capacity_escalations=escalations,
        probed_caps=tuple(probed) if probed is not None else None,
        src_caps=tuple(src_caps) if src_caps is not None else None,
        device=str(device), final_params=params)
