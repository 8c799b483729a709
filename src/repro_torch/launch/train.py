"""Training launcher CLI: the GNN and LM modes of the reference's launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --mode gnn \
        --arch gcn --dataset reddit --scale 0.03125 --epochs 30 \
        --isplib on [--measure-tuning] [--tuning-db PATH] [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
        --arch phi3.5-moe-42b-a6.6b --smoke --steps 20 [--batch 8] \
        [--seq 128] [--accum 1] [--grad-compression int8] \
        [--ckpt-dir DIR] [--ckpt-every 10] [--resume] [--inject-fault N] \
        [--device cpu]

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
loss must have decreased. The reference's mesh flags (``--mesh-data``,
``--mesh-model``, ``--grad-sync``) are not ported (ROADMAP.md queue 1,
item 5): given, they exit 2.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

_NOT_PORTED = {
    "mesh_data": "item 5 (distributed)",
    "mesh_model": "item 5 (distributed)",
    "grad_sync": "item 5 (distributed)",
}


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


def run_lm(args) -> int:
    import torch
    from repro_torch.ckpt import Checkpointer, latest_step
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import token_stream
    from repro_torch.train import lm as TL
    from repro_torch.train.fault_tolerance import (ResilientLoop,
                                                   StragglerWatchdog)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(args.device)
    print(f"[lm] {cfg.name} ({cfg.family}) on {device}")
    compression = args.grad_compression != "none"
    step_fn, opt = TL.make_train_step(cfg, lr=args.lr, accum=args.accum,
                                      compression=compression)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = TL.make_train_state(cfg, gen, opt, compression=compression,
                                device=device)
    with tempfile.TemporaryDirectory() as scratch:
        ckpt_dir = args.ckpt_dir or scratch
        ckpt = Checkpointer(ckpt_dir, keep=3)
        start = 0
        if args.resume and latest_step(ckpt_dir) is not None:
            state, start = ckpt.restore(state)
            print(f"  resumed from step {start}")
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
                yield {"tokens": torch.from_numpy(toks).to(device),
                       "targets": torch.from_numpy(tgts).to(device),
                       "step": start + i}

        losses = []

        def on_metrics(step, metrics):
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"  step {step:5d} loss {loss:.4f} "
                      f"grad_norm {float(metrics['grad_norm']):.3f}",
                      flush=True)

        loop = ResilientLoop(wrapped_step, ckpt, ckpt_every=args.ckpt_every,
                             watchdog=StragglerWatchdog())
        t0 = time.perf_counter()
        state, end = loop.run(state, batches(), start_step=start,
                              num_steps=args.steps, on_metrics=on_metrics)
        dt = time.perf_counter() - t0
    print(f"  {args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1) * 1e3:.1f} ms/step); "
          f"final loss {losses[-1]:.4f}; restarts={loop.restarts} "
          f"emergency_saves={loop.emergency_saves} last step {end}")
    if args.steps >= 20:
        if not losses[-1] < losses[0]:
            print(f"  loss did not decrease: {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}", file=sys.stderr)
            return 1
        print("  loss decreased: OK")
    elif len(losses) > 1:
        print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}")
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
    # the reference's flags that wait for a later slice
    ap.add_argument("--mesh-data", type=int, default=None)
    ap.add_argument("--mesh-model", type=int, default=None)
    ap.add_argument("--grad-sync", default=None)
    args = ap.parse_args(argv)
    refused = [f"--{k.replace('_', '-')}: ROADMAP.md queue 1, {item}"
               for k, item in _NOT_PORTED.items()
               if getattr(args, k) not in (None, False)]
    if refused:
        print("not ported yet: " + "; ".join(refused), file=sys.stderr)
        return 2
    if args.resume and args.ckpt_dir is None:
        ap.error("--resume needs --ckpt-dir")
    if args.lr is None:
        args.lr = 1e-2 if args.mode == "gnn" else 3e-4
    return run_gnn(args) if args.mode == "gnn" else run_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
