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

Measured tuning (``measure_tuning=True``) times each bucket's candidate
kernels on the run's device over the bucket's first block, and never
while a step runs on the same card: the device sampler plans on its
probe blocks before the first step; with the host sampler, a batch
whose buckets are not all planned is handed to the consumer (the
training loop's thread) unpacked, and the prefetch thread waits until
the consumer has planned and packed it, so no step and no transfer of
the pipeline overlaps a timed window.

**Fault tolerance** (``ckpt_dir=``, ``faults=``, ``watchdog=``), the
reference's contract. ``ckpt_dir`` checkpoints ``(params, opt_state)``
and the loader position (the global step ``epoch * steps_per_epoch +
batch``) through :class:`repro_torch.ckpt.Checkpointer`. Every random
stream here is stateless (the epoch permutation is keyed ``(seed,
epoch)``, host draws by the round counter, device draws by ``(seed,
round, hop, node, slot)``), and a step repeats bit for bit on the card
(the ordered segment sums), so resuming is a pure fast-forward: skip the
first batches of the restart epoch without sampling them, and the
replayed tail is the schedule the killed run would have run, so a killed
and resumed run ends with bitwise-identical params and Adam moments. The
prefetch worker restarts a bounded number of times from the delivered
batch count (``sampling.loader.resilient_prefetch``); ``faults`` (a
:class:`repro_torch.testing.FaultPlan`) injects each failure mode at the
trainer's injection points; ``watchdog`` (a
``train.fault_tolerance.StragglerWatchdog``) observes step wall-clock.

**Data parallelism** (``mesh=``, a :class:`repro_torch.dist.Mesh`) is
lockstep, one process a rank (the reference runs every shard in one
process under ``shard_map``): the seed stream splits over the mesh's
``'data'`` axis under the loader's lockstep contract (every shard the
same number of batches an epoch; a short shard's tail is an ``n_real ==
0`` batch), each rank samples its own shard (host draws with round
``(epoch * 100003 + batch) * shards + shard``; the device sampler adds
the shard to the replicated round counter), and the gradients are
reduced over the axis (``dist.collectives.sync_grads``: the exact fp32
mean, or the int8 shared-scale wire with ``grad_sync='int8'``) between
the gradients and the update. Every rank holds the whole graph and
replicated params and applies the identical update, so the replicas
stay bitwise equal. The non-finite guard's verdict is a collective
(``all_agree``), so one rank's NaN skips the step on every rank.
Checkpointing a data-parallel run waits for ROADMAP.md queue 1, item 5b
(data-parallel resume, after queue 3 item 9).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ckpt import Checkpointer, checkpoint_extra, latest_step
from repro_torch.core import sparse as sp
from repro_torch.core.patch import patched
from repro_torch.dist.collectives import (all_agree, pmean, psum,
                                          replicas_equal, sync_grads,
                                          wire_bytes)
from repro_torch.dist.mesh import axis_shard_count
from repro_torch.models.gnn import layers as L
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.optimizer import tree_map
from repro_torch.sampling import (BlockPlanCache, DeviceSampler,
                                  NeighborSampler, block_spmm_global,
                                  device_graph_from_csr, gather_rows,
                                  num_seed_batches, pack_block, plan_buckets,
                                  resilient_prefetch, round_bucket,
                                  seed_batches)
from repro_torch.train.gnn import accuracy, loss_and_grads

__all__ = ["MB_ARCHS", "SAMPLERS", "GRAD_SYNC_WIRES", "MinibatchTrainResult",
           "make_block_model", "init_step_stats", "make_minibatch_step",
           "make_device_minibatch_step", "layerwise_inference",
           "train_gnn_minibatch"]

MB_ARCHS = ("sage-sum", "sage-mean", "sage-max", "gin")
GRAD_SYNC_WIRES = ("fp32", "int8")
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
    num_shards: int = 1      # the mesh's 'data'-axis degree
    grad_sync: str = "fp32"  # the gradient sync's wire ('fp32' | 'int8')
    sync_bytes_per_step: int = 0   # a rank's gradient bytes on the wire
    sampler: str = "host"
    sample_time_s: float = 0.0     # the sample(+pack) stage of one epoch
    skipped_steps: int = 0         # updates skipped by the non-finite guard
    overflow_edges: int = 0        # device-sampler capacity-dropped edges
    capacity_escalations: int = 0  # device capacity doublings
    probed_caps: Optional[tuple] = None   # probed capacities (None: given)
    src_caps: Optional[tuple] = None      # device capacities at the end
    prefetch_restarts: int = 0     # prefetch-worker recoveries
    resumed_step: int = -1         # global step restored from (-1: fresh)
    ckpt_saves: int = 0            # checkpoints written by this run
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


def _check_wire(grad_sync: str) -> None:
    if grad_sync not in GRAD_SYNC_WIRES:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNC_WIRES}, "
                         f"got {grad_sync!r}")


def _step_tail(opt, p, s, loss, grads, stats, ovf, *, mesh=None,
               grad_sync: str = "fp32", skip_nonfinite: bool,
               nan_inject=None, step_idx=None):
    """Everything between the gradients and the applied update, shared by
    both samplers, in the reference's order:

    1. the test harness's NaN: ``nan_inject=(step, shard)`` adds NaN to
       every gradient on the device when ``step_idx`` is that step (and,
       on a mesh of more than one shard, this rank is that shard); both
       are host ints, so nothing is read back;
    2. the local non-finite verdict (loss and every gradient);
    3. on a mesh, the verdict made global by ``all_agree``, a collective
       every rank issues, so every rank keeps or skips alike;
    4. a skipped step's gradients zeroed *before* the sync (the int8
       wire's shared scale is a max over ``|g|``: a NaN synced first
       would poison every rank);
    5. on a mesh, ``sync_grads`` over ``'data'`` and the loss averaged;
    6. the update, whose new params and whole Adam state (step count
       included) ``torch.where`` discards on a skip, and the counters."""
    if nan_inject is not None and step_idx == nan_inject[0] and (
            axis_shard_count(mesh) <= 1 or
            mesh.index("data") == nan_inject[1]):
        grads = tree_map(lambda g: g + float("nan"), grads)
    ok = None
    if skip_nonfinite:
        flat: list = []
        tree_map(flat.append, grads)
        ok = torch.isfinite(loss)
        for g in flat:
            ok = ok & torch.isfinite(g).all()
        if mesh is not None:
            ok = all_agree(ok, mesh, "data")
        grads = tree_map(lambda g: torch.where(ok, g, 0.0), grads)
        loss = torch.where(torch.isfinite(loss), loss, 0.0)
    if mesh is not None:
        grads = sync_grads(grads, mesh, "data", wire=grad_sync)
        loss = pmean(loss, mesh, "data")
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


def make_minibatch_step(apply_blocks, opt, *, batch_size: int, mesh=None,
                        grad_sync: str = "fp32",
                        skip_nonfinite: bool = True, nan_inject=None):
    """The host-sampled update: ``step(params, opt_state, pbs, seed_ids,
    n_real, x, y, stats, step_idx=None) -> (params, opt_state, loss,
    grads, stats)``. ``pbs`` are packed blocks on the device, ``seed_ids``
    the padded ``(batch_size,)`` seed tensor there, ``n_real`` the host
    count of real seeds (the rest are masked out of the loss), ``step_idx``
    the host global step (read by ``nan_inject``, the test harness's
    ``(step, shard)``).

    With ``mesh`` (a ``dist.Mesh``) the step is this rank's part of a
    lockstep data-parallel step: its own shard's batch, the gradients
    reduced over the mesh's ``'data'`` axis (``grad_sync``: ``'fp32'``
    the exact mean, ``'int8'`` the shared-scale wire) before the update,
    the returned loss the ranks' mean and the returned grads the synced
    tree. Every rank of the axis must call it."""
    _check_wire(grad_sync)

    def step(p, s, pbs, seed_ids, n_real, x, y, stats, step_idx=None):
        mask = torch.arange(batch_size, device=x.device) < n_real
        h = gather_rows(x, pbs[0].src_ids)
        loss, grads = loss_and_grads(apply_blocks, p, pbs, h,
                                     y[seed_ids.long()], mask)
        return _step_tail(opt, p, s, loss, grads, stats, None, mesh=mesh,
                          grad_sync=grad_sync,
                          skip_nonfinite=skip_nonfinite,
                          nan_inject=nan_inject, step_idx=step_idx)

    return step


def make_device_minibatch_step(apply_blocks, opt, dev_sampler, *,
                               batch_size: int, mesh=None,
                               grad_sync: str = "fp32",
                               skip_nonfinite: bool = True, nan_inject=None):
    """The device-sampled update: ``step(params, opt_state, seeds, n_real,
    rnd, x, y, stats, step_idx=None) -> (params, opt_state, loss, grads,
    stats)`` (``step_idx`` and ``nan_inject`` as in
    :func:`make_minibatch_step`).

    ``seeds`` is the padded ``(batch_size,)`` seed tensor on the device,
    ``n_real`` and the round counter ``rnd`` host ints. Pad seeds are
    routed to the ``num_nodes`` sentinel before sampling (degree-0
    frontier rows, inert blocks) and masked out of the loss. Sampling runs
    outside autograd (it is integer work), and its capacity-overflow count
    joins the device counters. Nothing in the step reads the device.

    With ``mesh``, as :func:`make_minibatch_step`; the rank samples with
    round ``rnd`` plus its shard index (``rnd`` is the replicated counter
    ``(epoch * 100003 + batch) * shards``, so the shards draw disjoint
    streams), and the overflow count is summed over the axis, so the
    counters stay equal on every rank."""
    _check_wire(grad_sync)
    num_nodes = dev_sampler.graph.num_nodes
    shard = mesh.index("data") if mesh is not None else 0

    def step(p, s, seeds, n_real, rnd, x, y, stats, step_idx=None):
        mask = torch.arange(batch_size, device=seeds.device) < n_real
        with torch.no_grad():
            pbs, ovf = dev_sampler.sample_blocks_stats(
                torch.where(mask, seeds, num_nodes), rnd + shard)
            if mesh is not None:
                ovf = psum(ovf, mesh, "data")
        h = gather_rows(x, pbs[0].src_ids)
        loss, grads = loss_and_grads(apply_blocks, p, pbs, h,
                                     y[seeds.long()], mask)
        return _step_tail(opt, p, s, loss, grads, stats, ovf, mesh=mesh,
                          grad_sync=grad_sync,
                          skip_nonfinite=skip_nonfinite,
                          nan_inject=nan_inject, step_idx=step_idx)

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
                        tune: bool = True, measure_tuning: bool = False,
                        seed: int = 0, tuning_db=None, mesh=None,
                        grad_sync: str = "fp32",
                        double_buffer: bool = True, bucket_base: int = 128,
                        infer_batch: int = 1024, sampler: str = "host",
                        skip_nonfinite: bool = True,
                        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                        ckpt_keep: int = 3, resume: bool = True,
                        faults=None, prefetch_restarts: int = 2,
                        device_caps=None, max_escalations: int = 2,
                        watchdog=None, params: dict | None = None,
                        profile: bool = False,
                        device="cuda") -> MinibatchTrainResult:
    """Neighbour-sampled minibatch training on ``dataset`` (a
    ``data.graphs.GraphDataset``), one layer per fanout entry (outermost
    first), on ``device``.

    ``mesh`` (a ``repro_torch.dist.Mesh``; every rank of it calls this
    with the same arguments) engages lockstep data parallelism over the
    mesh's ``'data'`` axis (see the module docstring), on the mesh's
    device: this rank trains on its shard of the seeds, the gradients
    are reduced over the axis before each update (``grad_sync``:
    ``'fp32'`` exact, ``'int8'`` the shared-scale wire), and the params,
    drawn from the same seed on every rank, are checked to be bitwise
    equal across the ranks before the first step. ``mesh`` with
    ``ckpt_dir`` raises: data-parallel checkpointing and resume are
    ROADMAP.md queue 1, item 5b.

    The initial weights come from a ``torch.Generator`` seeded with
    ``seed`` unless ``params`` hands over a starting point (a test starts
    both packages from the same weights that way). Epoch ``e``, batch
    ``b`` samples with round ``e * 100003 + b`` on either sampler, as the
    reference does. The host sampler runs one batch ahead of the step in
    a prefetch thread; ``double_buffer=False`` runs it in turn with the
    steps instead (the results are the same).

    ``sampler="device"`` samples on the device (see the module
    docstring). Its per-hop capacities are probed from three host-sampled
    batches (1.5x the largest source count seen), unless ``device_caps``
    (innermost first) pins them, and a checkpoint's capacities take
    precedence over both (a resumed run must truncate as the killed one
    did); given capacities leave two of the three batches unsampled. The
    per-layer plans come from the first batch, through the same
    ``BlockPlanCache``
    sweep as the host path, restricted to ELL/trusted. Edges dropped to
    capacity overflow are counted on the device; at an epoch boundary
    with new drops the capacities double and the sampler is rebuilt, at
    most ``max_escalations`` times.

    Fault tolerance (the module docstring has the contract):

    * ``ckpt_dir``: every ``ckpt_every`` steps, and at the end (blocking),
      ``{"params", "opt_state"}`` and the resume state (``extra``:
      ``losses``, the device ``src_caps``, the ``skipped`` and
      ``overflow`` counts and the ``escalations``) are saved; with
      ``resume`` the newest committed step is restored and the loader
      fast-forwards to it, the restored counters carrying into the
      result. ``ckpt_keep`` bounds the steps kept. Each save is a
      ``train.ckpt`` span (the counters' read, the one sync a save costs,
      and the host copy), the restore a ``train.restore`` span.
    * ``skip_nonfinite`` (default on): a non-finite loss or gradient
      skips that update, decided on the device, counted in
      ``skipped_steps``.
    * a dead host prefetch worker is rebuilt from the delivered batch
      count, at most ``prefetch_restarts`` times an epoch.
    * ``faults`` (a ``repro_torch.testing.FaultPlan``) injects failures:
      ``step_exception_at`` / ``straggler_at`` before the step,
      ``nan_grad_at`` inside it on the device, ``prefetch_death_at`` in
      the host stream. ``watchdog`` (a ``train.fault_tolerance.
      StragglerWatchdog``) observes each step's wall-clock from the
      second executed epoch on (the first is dominated by kernel builds
      and plans), with a device sync after every step.

    ``measure_tuning=True`` times each bucket's candidates on ``device``
    (see the module docstring for when); ``tuning_db`` (a
    ``core.autotune.TuningDB``) serves per-bucket plans this device kind
    has measured before and records new ones.

    ``profile=True`` turns the ``repro_torch.obs`` tracer on for the run
    (if it is off): ``train.epoch`` / ``train.step`` / ``train.infer`` and,
    on the host path, ``loader.sample`` / ``loader.pack`` / ``loader.h2d``
    / ``loader.stall`` spans, with a device sync after every step
    (attribution mode, not benchmarking)."""
    _, semiring = _block_arch(arch)
    _check_wire(grad_sync)
    n_layers = len(fanouts)
    if mesh is not None and ckpt_dir is not None:
        raise NotImplementedError(
            "train_gnn_minibatch(mesh=..., ckpt_dir=...): checkpointing and "
            "resuming a data-parallel run wait for ROADMAP.md queue 1, item "
            "5b (data-parallel resume, after queue 3 item 9)")
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
    device = mesh.device if mesh is not None else torch.device(device)
    num_shards = axis_shard_count(mesh, "data") if mesh is not None else 1
    shard = mesh.index("data") if mesh is not None else 0
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
        plan_cache = BlockPlanCache(semiring=semiring, tune=tune,
                                    measure=measure_tuning, db=tuning_db,
                                    device=device)
        if mesh is not None and not replicas_equal(params, mesh, "data"):
            raise RuntimeError("the ranks' initial params differ: every "
                               "rank must start from the same weights")
        train_ids = np.nonzero(dataset.train_mask.numpy())[0]
        x = dataset.x.to(device)
        y = dataset.y.to(device)
        steps_per_epoch = num_seed_batches(len(train_ids), batch_size,
                                           num_shards=num_shards)

        # -- checkpoint / resume: a committed step N means "N steps done"
        ckpt = None
        resumed_step = -1
        start_step = 0
        prior_losses: list = []
        restored_caps = None
        skipped_base = overflow_base = escalations = ckpt_saves = 0
        n_prefetch_restarts = 0
        if ckpt_dir is not None:
            ckpt = Checkpointer(ckpt_dir, keep=ckpt_keep)
            if resume and latest_step(ckpt_dir) is not None:
                with obs.span("train.restore"):
                    restored, start_step = ckpt.restore(
                        {"params": params, "opt_state": opt_state})
                params, opt_state = restored["params"], restored["opt_state"]
                resumed_step = start_step
                extra = checkpoint_extra(ckpt_dir, start_step)
                prior_losses = list(extra.get("losses", []))
                restored_caps = extra.get("src_caps")
                skipped_base = int(extra.get("skipped", 0))
                overflow_base = int(extra.get("overflow", 0))
                escalations = int(extra.get("escalations", 0))

        nan_inject = faults.nan_grad_at if faults is not None else None
        dev = probed = src_caps = None
        if sampler == "device":
            dgraph = device_graph_from_csr(csr, device=device)
            # checkpointed caps > pinned > probed; the plans need the
            # first probe batch only, the probed capacities all three
            given = restored_caps if restored_caps is not None \
                else device_caps
            probe = [host_sampler.sample(
                train_ids[: min(batch_size, len(train_ids))], round=r)
                for r in range(3 if given is None else 1)]
            if given is None:
                probed = [int(1.5 * max(p[n_layers - 1 - j].n_src
                                        for p in probe))
                          for j in range(n_layers)]
            src_caps = [int(c) for c in (probed if given is None
                                         else given)]

            def build_device(caps):
                d = DeviceSampler(dgraph, fanouts, batch_size=batch_size,
                                  seed=seed, base=bucket_base, src_caps=caps)
                d.set_plans([
                    plan_cache.plan_for(blk, n_dst=bk.n_dst, n_src=bk.n_src,
                                        nnz=bk.nnz, k_hint=k, sell_ok=False)
                    for blk, bk, k in zip(probe[0], d.buckets, dims)])
                return d, make_device_minibatch_step(
                    apply_blocks, opt, d, batch_size=batch_size, mesh=mesh,
                    grad_sync=grad_sync, skip_nonfinite=skip_nonfinite,
                    nan_inject=nan_inject)

            dev, step = build_device(src_caps)
        else:
            step = make_minibatch_step(apply_blocks, opt,
                                       batch_size=batch_size, mesh=mesh,
                                       grad_sync=grad_sync,
                                       skip_nonfinite=skip_nonfinite,
                                       nan_inject=nan_inject)

        signatures: set = set()
        wire_tag = grad_sync if num_shards > 1 else None   # span attribute
        stats = init_step_stats(device)
        losses: list = [float(v) for v in prior_losses]

        def save_state(nsteps: int, last, *, blocking: bool = False):
            """Checkpoint the state and the resume metadata after
            ``nsteps`` steps. Reading the counters is a device sync, paid
            at the checkpoint cadence only."""
            nonlocal ckpt_saves
            ep_losses = list(losses)
            if nsteps % steps_per_epoch == 0 and last is not None and \
                    len(ep_losses) < nsteps // steps_per_epoch:
                # on an epoch boundary, before the epoch loop appends this
                # epoch's loss: include it, so the restored history
                # matches the resumed epoch count
                ep_losses.append(float(last))
            with obs.span("train.ckpt", step=nsteps):
                drained = stats.drain()
                extra = {"losses": ep_losses, "src_caps": src_caps,
                         "skipped": skipped_base + drained["skipped"],
                         "overflow": overflow_base + drained["overflow"],
                         "escalations": escalations}
                ckpt.save(nsteps, {"params": params, "opt_state": opt_state},
                          blocking=blocking, extra=extra)
            ckpt_saves += 1

        def epoch_batches(epoch: int):
            """This rank's shard of the epoch (every shard the same count
            of batches: the lockstep contract)."""
            return list(seed_batches(train_ids, batch_size, shuffle=True,
                                     seed=seed, epoch=epoch,
                                     num_shards=num_shards,
                                     shard_index=shard))

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

        def stage(blocks, buckets, seed_ids, bi):
            """Plan, pack and move one sampled batch."""
            with obs.span("loader.pack", batch=bi):
                pbs = pack_all(blocks, buckets)
            sig = tuple(pb.bucket_signature for pb in pbs)
            with obs.span("loader.h2d", batch=bi):
                pbs = [sp.to_device(pb, device) for pb in pbs]
                sids = torch.from_numpy(seed_ids).to(device)
            return pbs, sids, sig

        def batch_stream(epoch: int, planned: threading.Event,
                         start: int = 0):
            """Host half of the pipeline (the prefetch thread): sample,
            bucket, pack and move one batch per step, from batch
            ``start`` on (the batches before it are skipped without
            sampling: the resume fast-forward and the prefetch restart).
            A batch with a bucket still to measure goes to the consumer
            unpacked (``(None, ...)``), and this thread waits on
            ``planned`` until the consumer has planned and packed it."""
            for bi, (seed_ids, n_real) in enumerate(epoch_batches(epoch)):
                if bi < start:
                    continue
                with obs.span("loader.sample", batch=bi):
                    blocks = host_sampler.sample(
                        seed_ids[:n_real],
                        round=(epoch * 100003 + bi) * num_shards + shard)
                with obs.span("loader.pack", batch=bi):
                    buckets = plan_buckets(blocks, batch_size=batch_size,
                                           fanouts=fanouts,
                                           base=bucket_base)
                if any(plan_cache.will_measure(
                        n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz,
                        k_hint=k) for bk, k in zip(buckets, dims)):
                    yield None, (blocks, buckets, seed_ids, bi), n_real
                    planned.wait()
                    planned.clear()
                    continue
                pbs, sids, sig = stage(blocks, buckets, seed_ids, bi)
                yield (pbs, sids, sig), None, n_real

        watch_on = False          # set after the first executed epoch

        def before_step(gstep: int) -> float:
            t0 = time.perf_counter() if watchdog is not None else 0.0
            if faults is not None:      # after t0: an injected straggler's
                faults.before_step(gstep)   # delay lands in the window
            return t0

        def after_step(gstep: int, t0: float, last) -> None:
            if watchdog is not None and watch_on:
                sync()
                watchdog.observe(gstep, time.perf_counter() - t0)
            if ckpt is not None and ckpt_every > 0 and \
                    (gstep + 1) % ckpt_every == 0:
                save_state(gstep + 1, last)

        def run_epoch(epoch: int, start: int = 0):
            nonlocal params, opt_state, stats, n_prefetch_restarts
            last = None
            planned = threading.Event()

            def on_restart(n, delivered, exc):
                nonlocal n_prefetch_restarts
                n_prefetch_restarts += 1
                warnings.warn(f"prefetch worker died ({exc!r}); restarted "
                              f"from batch {start + delivered} (restart "
                              f"{n})")

            def make_stream(delivered: int):
                planned.clear()         # a dead producer's flag is stale
                s = batch_stream(epoch, planned, start + delivered)
                return faults.wrap_stream(s) if faults is not None else s

            stream = resilient_prefetch(
                make_stream, max_restarts=prefetch_restarts,
                on_restart=on_restart) if double_buffer else make_stream(0)
            try:
                for bi, (ready, raw, n_real) in enumerate(stream, start):
                    if ready is None:       # measured here, between steps
                        ready = stage(*raw)
                        planned.set()
                    pbs, sids, sig = ready
                    gstep = epoch * steps_per_epoch + bi
                    t0 = before_step(gstep)
                    signatures.add(sig)
                    with obs.span("train.step", step=gstep,
                                  grad_sync=wire_tag):
                        params, opt_state, last, _, stats = step(
                            params, opt_state, pbs, sids, n_real, x, y,
                            stats, step_idx=gstep)
                        if profile:   # the span times execution, not enqueue
                            sync()
                    after_step(gstep, t0, last)
            finally:
                planned.set()           # never leave the producer waiting
                stream.close()
            return last

        def run_epoch_device(epoch: int, start: int = 0):
            """The host feeds the epoch's seeds (one copy) and the round
            counter; sampling, packing and the update run on the device."""
            nonlocal params, opt_state, stats
            batches = epoch_batches(epoch)
            seeds = torch.from_numpy(
                np.stack([b[0] for b in batches]).astype(np.int32)).to(device)
            last = None
            for bi in range(start, len(batches)):
                gstep = epoch * steps_per_epoch + bi
                t0 = before_step(gstep)
                signatures.add(dev.signature)
                with obs.span("train.step", step=gstep, sampler="device",
                              grad_sync=wire_tag):
                    params, opt_state, last, _, stats = step(
                        params, opt_state, seeds[bi], batches[bi][1],
                        (epoch * 100003 + bi) * num_shards, x, y, stats,
                        step_idx=gstep)
                    if profile:
                        sync()
                after_step(gstep, t0, last)
            return last

        epoch_fn = run_epoch_device if sampler == "device" else run_epoch
        start_epoch, start_batch = divmod(start_step, steps_per_epoch)
        first_epoch = later = 0.0
        executed = ovf_seen = 0
        loss = None
        try:
            for ep in range(start_epoch, epochs):
                t0 = time.perf_counter()
                with obs.span("train.epoch", epoch=ep):
                    loss = epoch_fn(ep, start_batch if ep == start_epoch
                                    else 0)
                    sync()
                dt = time.perf_counter() - t0
                if executed == 0:
                    first_epoch = dt
                else:
                    later += dt
                executed += 1
                watch_on = True
                losses.append(float(loss))          # once per epoch
                if dev is not None:
                    # capacity-overflow escalation, at the epoch boundary
                    # (a schedule point a checkpoint can name)
                    ovf_now = int(stats["overflow"])
                    if ovf_now > ovf_seen and escalations < max_escalations:
                        escalations += 1
                        src_caps = [2 * c for c in src_caps]
                        warnings.warn(
                            f"device sampler dropped {ovf_now - ovf_seen} "
                            f"edges to capacity overflow in epoch {ep}; "
                            f"escalating capacities to {src_caps} "
                            f"({escalations}/{max_escalations})")
                        dev, step = build_device(src_caps)
                    ovf_seen = ovf_now
        except BaseException:
            # let an in-flight save finish, so the directory a restart
            # reads is quiet; then the failure propagates
            if ckpt is not None:
                try:
                    ckpt.wait()
                except Exception:
                    pass
            raise
        epoch_time = later / (executed - 1) if executed > 1 else first_epoch
        if ckpt is not None:
            if epochs * steps_per_epoch > start_step:
                save_state(epochs * steps_per_epoch, loss, blocking=True)
            ckpt.wait()

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
        epochs=epochs, steps_per_epoch=steps_per_epoch,
        num_shards=num_shards, grad_sync=grad_sync,
        sync_bytes_per_step=(wire_bytes(params, grad_sync)
                             if num_shards > 1 else 0),
        sampler=sampler, sample_time_s=sample_time,
        skipped_steps=skipped_base + drained["skipped"],
        overflow_edges=overflow_base + drained["overflow"],
        capacity_escalations=escalations,
        probed_caps=tuple(probed) if probed is not None else None,
        src_caps=tuple(src_caps) if src_caps is not None else None,
        prefetch_restarts=n_prefetch_restarts, resumed_step=resumed_step,
        ckpt_saves=ckpt_saves, device=str(device), final_params=params)
