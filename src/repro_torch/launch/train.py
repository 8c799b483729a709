"""Training launcher CLI: the GNN and LM modes of the reference's launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --mode gnn \
        --arch gcn --dataset reddit --scale 0.03125 --epochs 30 \
        --isplib on [--measure-tuning] [--tuning-db PATH] [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
        --arch phi3.5-moe-42b-a6.6b --smoke --steps 20 [--batch 8] \
        [--seq 128] [--accum 1] [--grad-compression int8] \
        [--ckpt-dir DIR] [--ckpt-every 10] [--resume] [--inject-fault N] \
        [--mesh-data N --grad-sync shardmap] \
        [--mesh-data D --mesh-model M] [--device cpu]

Trains on the card unless ``--device cpu``. GNN: ``--measure-tuning``
times the candidate kernels on that device before training, and
``--tuning-db`` keeps the plans in a ``TuningDB`` file across runs. LM:
``make_train_step`` over batches from ``data/tokens.token_stream`` in a
:class:`~repro_torch.train.fault_tolerance.ResilientLoop`, printing the
reference's step lines: an asynchronous checkpoint every
``--ckpt-every`` steps under ``--ckpt-dir`` (a temporary directory,
removed at exit, when none is given), a straggler watchdog, and on a
failed step a restore of the newest durable step (after an emergency
save of the last good state when the step had not begun to update it in
place). ``--resume`` restores the newest step under ``--ckpt-dir`` and
goes on from there with the token stream at that step;
``--inject-fault N`` fails step N once, before it runs, to drive the
restart. A sticky CUDA error cannot be recovered in the same process:
run the launcher again with ``--resume``. With ``--steps`` >= 20 the
loss must have decreased.

``--mesh-data N --grad-sync shardmap`` trains data-parallel over N
ranks (``train.lm.make_data_parallel_step``; the int8 wire with
``--grad-compression int8``): unless the process already runs under a
launcher that set ``RANK`` / ``WORLD_SIZE`` (``torchrun``; then
``--ckpt-dir`` is needed), it starts the N ranks itself
(``dist.run_ranks``: NCCL with a card a rank, gloo where they share a
card or run on the CPU). Every rank draws the same global batch and
takes its slice; only rank 0 prints and checkpoints. ``--inject-fault``
fails that step on every rank at once, and the ranks restore the same
durable step: rank 0's writer drained, then all ranks at a barrier.

``--mesh-data D --mesh-model M`` with ``--grad-sync gspmd`` (the
default) trains over D x M ranks with the sharding rules
(``train.lm.make_train_step(mesh=)``): each rank holds its slices of
the params and moments (tensor and expert parallelism over ``'model'``)
and takes its ``'data'`` block of the global batch; the gradients are
synced over ``'data'`` (and with ``--grad-compression int8`` the
error feedback runs on each rank's slices, a split leaf onto its whole
leaf's scale). Where ``--mesh-model`` equals the MoE config's
``n_experts · n_expert_replicas`` and ``--seq`` divides by it, the MoE
layers take the manual expert-parallel path (an all-to-all over the
expert-parallel groups). Where the default rules would cut a head (a
``'model'`` axis wider than the KV heads), the attention is kept whole
on every model rank (``dist.partition.WHOLE_ATTENTION_RULES``; the
header says so). Rank 0 checkpoints, the split leaves gathered
over ``'model'`` first, so the files are in the one-rank format; a
restart restores them and every rank takes its slices again.

What is not ported exits 2 before anything is built, naming its ROADMAP
item: ``--resume`` over several ranks (queue 1, item 5b.4), and
``--grad-sync shardmap`` with ``--mesh-model`` > 1 (the explicit
data-parallel step replicates the params over the whole mesh, as the
reference's does: use ``--grad-sync gspmd``).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

_ITEM_5B = "ROADMAP.md queue 1, item 5b"


def _zip_state(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (dicts and
    NamedTuples; None stays None)."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _zip_state(fn, a[k], b[k]) for k in a}
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_zip_state(fn, x, y) for x, y in zip(a, b)))
    return fn(a, b)


class _RankCheckpointer:
    """A rank's view of the one checkpoint directory of a run over
    several ranks: rank 0 writes, every rank reads. A restore first
    drains rank 0's writer and meets the other ranks at a barrier, so
    every rank restores the same durable step. With ``shardings`` (the
    whole state's, when the ranks hold slices) a save first gathers the
    split leaves on every rank, so the files are the one-rank state, and
    a restore reads the whole state and keeps this rank's slices."""

    def __init__(self, ckpt, mesh, shardings=None):
        self.ckpt, self.mesh, self.shardings = ckpt, mesh, shardings
        self.base = ckpt.base
        self.writer = mesh.index("data") == 0 and mesh.index("model") == 0

    def save(self, step, tree, **kw):
        if self.shardings is not None:       # a collective: every rank
            tree = _zip_state(lambda x, s: s.gather(x) if s.is_split
                              else x, tree, self.shardings)
        if self.writer:
            self.ckpt.save(step, tree, **kw)

    def wait(self):
        if self.writer:
            self.ckpt.wait()

    def restore(self, tree_like, shardings=None):
        import torch
        import torch.distributed as dist
        self.wait()
        if dist.is_initialized():
            dist.barrier()
        if self.shardings is None:
            return self.ckpt.restore(tree_like, shardings=shardings)
        dev = self.mesh.device
        whole = _zip_state(
            lambda x, s: torch.empty(tuple(n * s.shards(i) for i, n in
                                           enumerate(x.shape)),
                                     dtype=x.dtype, device=dev),
            tree_like, self.shardings)
        whole, step = self.ckpt.restore(whole, shardings=shardings)
        return _zip_state(lambda x, s: s.local(x).contiguous().clone(),
                          whole, self.shardings), step


def run_gnn(args) -> int:
    from repro_torch.core.autotune import TuningDB
    from repro_torch.data import make_dataset
    from repro_torch.train import train_gnn

    ds = make_dataset(args.dataset, scale=args.scale, seed=args.seed)
    db = TuningDB(args.tuning_db) if args.tuning_db else None
    res = train_gnn(args.arch, ds, hidden=args.hidden, epochs=args.epochs,
                    lr=args.lr, use_isplib=args.isplib == "on",
                    measure_tuning=args.measure_tuning, tuning_db=db,
                    device=args.device)
    print(f"[gnn] {res.arch} on {res.dataset} (iSpLib={res.use_isplib}, "
          f"plan={res.plan_kind})")
    print(f"  per-epoch {res.epoch_time_s * 1e3:.2f} ms | first epoch "
          f"{res.first_epoch_s:.2f} s | train acc {res.train_acc:.3f} | "
          f"test acc {res.test_acc:.3f}")
    return 0


def _lm_rank(mesh, args) -> int:
    """One rank of an LM run over several ranks (``dist.run_ranks``'
    body)."""
    return run_lm(args, mesh)


def run_lm_ranks(args) -> int:
    """``--mesh-data D [--mesh-model M]``: under an outside launcher this
    process is one rank; otherwise start the D x M ranks here."""
    from repro_torch.dist import init_ranks, run_ranks
    n = args.mesh_data * args.mesh_model
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            print(f"--mesh-data {args.mesh_data} x --mesh-model "
                  f"{args.mesh_model} under a launcher of {world} ranks",
                  file=sys.stderr)
            return 2
        import torch.distributed as dist
        mesh = init_ranks(int(os.environ["RANK"]), world, device=args.device,
                          model=args.mesh_model)
        try:
            return run_lm(args, mesh)
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as scratch:
        if args.ckpt_dir is None:           # one directory for every rank
            args.ckpt_dir = os.path.join(scratch, "ckpt")
        rcs = run_ranks(_lm_rank, n, scratch, args=(args,),
                        device=args.device, model=args.mesh_model)
    return max(rcs)


def run_lm(args, mesh=None) -> int:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.lm.transformer import heads_split_cleanly
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if mesh is not None and args.grad_sync == "gspmd":
        with mesh:
            whole = not heads_split_cleanly(cfg)
        if whole:
            from repro_torch.dist import WHOLE_ATTENTION_RULES, use_rules
            with use_rules(WHOLE_ATTENTION_RULES):
                return _run_lm(args, cfg, mesh, whole_attention=True)
    return _run_lm(args, cfg, mesh)


def _run_lm(args, cfg, mesh=None, whole_attention=False) -> int:
    import torch
    from repro_torch.ckpt import Checkpointer, latest_step
    from repro_torch.data import token_stream
    from repro_torch.dist import make_data_mesh, replicas_equal
    from repro_torch.models.lm.moe import _manual_ok
    from repro_torch.train import lm as TL
    from repro_torch.train.fault_tolerance import (ResilientLoop,
                                                   StragglerWatchdog)

    compression = args.grad_compression != "none"
    sharded = False                     # the ranks hold slices of the state
    if args.grad_sync == "shardmap":
        mesh = mesh or make_data_mesh(1, device=args.device)
        device = mesh.device
        step_fn, opt = TL.make_data_parallel_step(
            cfg, mesh, lr=args.lr, accum=args.accum, compression=compression)
    elif mesh is not None:
        device = mesh.device
        sharded = True
        step_fn, opt = TL.make_train_step(cfg, lr=args.lr, accum=args.accum,
                                          compression=compression, mesh=mesh)
    else:
        device = torch.device(args.device)
        step_fn, opt = TL.make_train_step(cfg, lr=args.lr, accum=args.accum,
                                          compression=compression)
    manual = False
    if sharded:
        with mesh:
            manual = _manual_ok(cfg, args.seq, mesh)
    lead = mesh is None or (mesh.index("data") == 0
                            and mesh.index("model") == 0)
    say = print if lead else (lambda *a, **kw: None)
    say(f"[lm] {cfg.name} ({cfg.family}) on {device}" + (
        f", mesh {mesh.shape} ({mesh.backend or 'one rank'}), grad sync "
        f"{'int8' if compression else 'fp32'}"
        + (" (the sharding rules)" if sharded else "")
        + (", the attention whole (the default rules would cut its heads)"
           if whole_attention else "")
        + (", MoE: manual expert parallelism" if manual else "")
        if mesh is not None else ""), flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = TL.make_train_state(cfg, gen, opt, compression=compression,
                                device=device, mesh=mesh if sharded else None)
    if mesh is not None and not replicas_equal(state.params, mesh):
        raise RuntimeError("the ranks' initial params differ")
    rows = slice(None)                  # this rank's rows of the batch
    if sharded:
        part = args.batch // mesh.shape["data"]
        rows = slice(mesh.index("data") * part,
                     (mesh.index("data") + 1) * part)
    with tempfile.TemporaryDirectory() as scratch:
        ckpt_dir = args.ckpt_dir or scratch
        ckpt = Checkpointer(ckpt_dir, keep=3)
        if mesh is not None:
            from repro_torch.dist.partition import state_shardings
            ckpt = _RankCheckpointer(ckpt, mesh, state_shardings(
                mesh, TL.shaped_state(cfg, opt, compression=compression))
                if sharded else None)
        start = 0
        if args.resume and latest_step(ckpt_dir) is not None:
            state, start = ckpt.restore(state)
            say(f"  resumed from step {start}")
        armed = [args.inject_fault is not None]

        def wrapped_step(st, batch):
            if armed[0] and batch["step"] == args.inject_fault:
                armed[0] = False
                raise RuntimeError("injected fault (--inject-fault)")
            return step_fn(st, {k: batch[k] for k in ("tokens", "targets")})
        wrapped_step.in_place = step_fn.in_place

        def batches():
            for i, (toks, tgts) in enumerate(
                    token_stream(args.batch, args.seq, cfg.vocab,
                                 start_step=start)):
                yield {"tokens": torch.from_numpy(toks[rows]).to(device),
                       "targets": torch.from_numpy(tgts[rows]).to(device),
                       "step": start + i}

        losses = []

        def on_metrics(step, metrics):
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % args.log_every == 0:
                say(f"  step {step:5d} loss {loss:.4f} "
                    f"grad_norm {float(metrics['grad_norm']):.3f}",
                    flush=True)

        loop = ResilientLoop(wrapped_step, ckpt, ckpt_every=args.ckpt_every,
                             watchdog=StragglerWatchdog())
        t0 = time.perf_counter()
        state, end = loop.run(state, batches(), start_step=start,
                              num_steps=args.steps, on_metrics=on_metrics)
        dt = time.perf_counter() - t0
    say(f"  {args.steps} steps in {dt:.1f}s "
        f"({dt / max(args.steps, 1) * 1e3:.1f} ms/step); "
        f"final loss {losses[-1]:.4f}; restarts={loop.restarts} "
        f"emergency_saves={loop.emergency_saves} last step {end}",
        flush=True)
    if args.steps >= 20:
        if not losses[-1] < losses[0]:
            say(f"  loss did not decrease: {losses[0]:.4f} -> "
                f"{losses[-1]:.4f}", file=sys.stderr)
            return 1
        say("  loss decreased: OK", flush=True)
    elif len(losses) > 1:
        say(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--mode", choices=["gnn", "lm"], required=True)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 1e-2 for gnn, 3e-4 for lm")
    ap.add_argument("--device", default="cuda",
                    help="where to train and measure (default: cuda)")
    # gnn
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--scale", type=float, default=1 / 32)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--isplib", choices=["on", "off"], default="on")
    ap.add_argument("--measure-tuning", action="store_true")
    ap.add_argument("--tuning-db", default=None, metavar="PATH",
                    help="TuningDB file that serves and records plans")
    # lm
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-fault", type=int, default=None, metavar="N",
                    help="fail step N once, before it runs")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel ranks")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor / expert-parallel ranks (--grad-sync "
                         "gspmd)")
    ap.add_argument("--grad-sync", choices=["gspmd", "shardmap"],
                    default="gspmd",
                    help="'gspmd': the sharding rules over --mesh-data x "
                         "--mesh-model ranks; 'shardmap': the explicit "
                         "data-parallel step, gradients reduced by the "
                         "hand-written collective (int8 wire with "
                         "--grad-compression int8)")
    args = ap.parse_args(argv)
    refused = []
    ranks = args.mesh_data * args.mesh_model
    if ranks > 1 and args.resume:
        refused.append(f"--resume over several ranks (sharded restore and "
                       f"data-parallel resume, {_ITEM_5B}.4)")
    if args.mesh_model > 1 and args.grad_sync == "shardmap":
        refused.append("--grad-sync shardmap with --mesh-model > 1 (the "
                       "explicit data-parallel step replicates the params; "
                       "--grad-sync gspmd splits them)")
    if refused:
        print("not ported: " + "; ".join(refused), file=sys.stderr)
        return 2
    if args.resume and args.ckpt_dir is None:
        ap.error("--resume needs --ckpt-dir")
    if args.mesh_data > 1 and args.batch % args.mesh_data:
        ap.error(f"--batch {args.batch} does not split over --mesh-data "
                 f"{args.mesh_data}")
    if args.mesh_model > 1 and args.mode != "lm":
        ap.error("--mesh-model is an LM option")
    if args.lr is None:
        args.lr = 1e-2 if args.mode == "gnn" else 3e-4
    if args.mode == "gnn":
        return run_gnn(args)
    if ranks > 1:
        if "RANK" in os.environ and args.ckpt_dir is None:
            ap.error("several ranks under an outside launcher need "
                     "--ckpt-dir (one directory for every rank)")
        return run_lm_ranks(args)
    return run_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
