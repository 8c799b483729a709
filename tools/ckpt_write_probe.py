"""Time an in-place LM train step on the card while a checkpoint write
runs in a background thread, writer by writer.

    PYTHONPATH=src python tools/ckpt_write_probe.py [--arch gemma-7b]
        [--layers 1] [--seq 2048] [--steps 3] [--max-steps 60]
        [--dir build/ckpt_probe]

Builds the model's train state on the card (bf16 params, fp32 moments),
copies it to host memory once, then for each writer runs ``--steps``
train steps while the writer writes that host copy under ``--dir``:
``none`` (no write), ``checkpointer`` (``repro_torch.ckpt.save_checkpoint``:
``np.save`` and an fsync a file), ``numpy`` (``np.save``, no fsync),
``numpy_sync`` (``np.save`` and an fsync a file), ``raw`` (``os.write``
of each array's bytes, an fsync a file) and ``raw_nosync``
(``--writers`` picks some); steps go on while the write runs, up to
``--max-steps``. Each step's start (s after the write began), wall ms
and host ms (until the step has enqueued its work: the step reads
nothing back), the write's seconds and each file's write and fsync
times are printed as one JSON line, with the card's name and power
limit. The directory is removed after each writer.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _write_raw(base: Path, arrays, sync: bool, files: list) -> None:
    for i, arr in enumerate(arrays):
        t0 = time.perf_counter()
        fd = os.open(base / f"arr_{i:05d}.bin",
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            view = memoryview(np.ascontiguousarray(arr)).cast("B")
            while view:
                view = view[os.write(fd, view):]
            t1 = time.perf_counter()
            if sync:
                os.fsync(fd)
        finally:
            os.close(fd)
        files.append((arr.nbytes, t0, t1, time.perf_counter()))


def _write_numpy(base: Path, arrays, sync: bool, files: list) -> None:
    for i, arr in enumerate(arrays):
        t0 = time.perf_counter()
        with open(base / f"arr_{i:05d}.npy", "wb") as f:
            np.save(f, arr, allow_pickle=False)
            f.flush()
            t1 = time.perf_counter()
            if sync:
                os.fsync(f.fileno())
        files.append((arr.nbytes, t0, t1, time.perf_counter()))


def main() -> int:
    import torch
    from repro_torch.ckpt import checkpointer as ck
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.train import lm as TL

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--max-steps", type=int, default=60)
    ap.add_argument("--dir", default="build/ckpt_probe")
    ap.add_argument("--writers", default="none,checkpointer,numpy,"
                    "numpy_sync,raw,raw_nosync")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ckpt_write_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    step_fn, opt = TL.make_train_step(cfg)
    state = TL.make_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), opt)
    toks, tgts = synthetic_lm_batch(1, args.seq, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).cuda(),
             "targets": torch.from_numpy(tgts).cuda()}

    def step():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3

    for _ in range(2):
        step()
    t0 = time.perf_counter()
    host = [leaf.detach().to("cpu", copy=True)
            for leaf in ck._flatten(state)]
    copy_s = time.perf_counter() - t0
    arrays = [ck._to_numpy(t)[0] for t in host]
    nbytes = sum(a.nbytes for a in arrays)
    base = Path(args.dir)
    files: list = []
    synced = ck._write_synced

    def timed_synced(path, write):
        """The checkpointer's file write, timed (write, then fsync)."""
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            write(f)
            f.flush()
            t1 = time.perf_counter()
            os.fsync(f.fileno())
        files.append((os.path.getsize(path), t0, t1, time.perf_counter()))

    def checkpointer():
        ck._write_synced = timed_synced
        try:
            ck.save_checkpoint(str(base), 1, host)
        finally:
            ck._write_synced = synced

    every = {
        "none": None,
        "checkpointer": checkpointer,
        "numpy": lambda: _write_numpy(base, arrays, False, files),
        "numpy_sync": lambda: _write_numpy(base, arrays, True, files),
        "raw": lambda: _write_raw(base, arrays, True, files),
        "raw_nosync": lambda: _write_raw(base, arrays, False, files),
    }
    writers = [(w, every[w]) for w in args.writers.split(",")]
    out = dict(card=card, arch=args.arch, layers=args.layers,
               state_bytes=nbytes, host_copy_s=copy_s, writers=[])
    for name, write in writers:
        shutil.rmtree(base, ignore_errors=True)
        base.mkdir(parents=True)
        files.clear()
        done: dict = {}

        def run():
            t = time.perf_counter()
            write()
            done["write_s"] = time.perf_counter() - t

        th = threading.Thread(target=run) if write else None
        t_write = time.perf_counter()
        if th:
            th.start()
        steps = [(time.perf_counter() - t_write, *step())
                 for _ in range(args.steps)]
        alive = bool(th and th.is_alive())
        while th and th.is_alive() and len(steps) < args.max_steps:
            # steps over the rest of the write
            steps.append((time.perf_counter() - t_write, *step()))
        if th:
            th.join()
        out["writers"].append(dict(
            writer=name, step_at_s=[round(t, 3) for t, _, _ in steps],
            step_ms=[round(w, 2) for _, w, _ in steps],
            host_ms=[round(h, 2) for _, _, h in steps],
            write_s=done.get("write_s"),
            write_outlasted_first_steps=alive,
            files=[dict(bytes=b, at_s=round(t0 - t_write, 3),
                        write_s=round(t1 - t0, 3), fsync_s=round(t2 - t1, 3))
                   for b, t0, t1, t2 in files]))
        print(json.dumps(out["writers"][-1]), flush=True)
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
