"""Training launcher CLI — the GNN mode of the reference's launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --mode gnn \
        --arch gcn --dataset reddit --scale 0.03125 --epochs 30 \
        --isplib on [--measure-tuning] [--tuning-db PATH] [--device cpu]

Trains on the card unless ``--device cpu``; ``--measure-tuning`` times
the candidate kernels on that device before training, and
``--tuning-db`` keeps the plans in a ``TuningDB`` file across runs.
``--mode lm`` is not ported: LM training is ROADMAP.md queue 1, item 2,
and the launcher exits with an error rather than run part of it.
"""
from __future__ import annotations

import argparse
import sys


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--mode", choices=["gnn", "lm"], required=True)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--scale", type=float, default=1 / 32)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--isplib", choices=["on", "off"], default="on")
    ap.add_argument("--measure-tuning", action="store_true")
    ap.add_argument("--tuning-db", default=None, metavar="PATH",
                    help="TuningDB file that serves and records plans")
    ap.add_argument("--device", default="cuda",
                    help="where to train and measure (default: cuda)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        print("--mode lm: LM training is not ported yet (ROADMAP.md "
              "queue 1, item 2)", file=sys.stderr)
        return 2
    return run_gnn(args)


if __name__ == "__main__":
    raise SystemExit(main())
