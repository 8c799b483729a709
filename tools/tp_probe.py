"""Phase 18 of ``chip_smoke.py`` (tensor and expert parallelism, two
model ranks on the one card) alone: build the kernels, run phases 10 and
12 (phi3.5-moe served and trained on one card, which write the digests
phase 18 is held against), then ``chip_smoke.tp_phase``, which prints its
checks and timings and raises on a failed check. Needs one CUDA card and
the toolkit; ~6 min with the build. Its details go to
``chiprun_out/tp_probe.json``.

    python tools/tp_probe.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.build import build_kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    t = time.time()
    built = build_kernels()
    print(f"build {time.time() - t:.1f} s {sorted(built)}", flush=True)
    out = {}
    for name, phase in (("serve_lm", cs.lm_phase),
                        ("train_lm", cs.lm_train_phase)):
        t = time.time()
        res = phase()
        out[name] = dict(seconds=time.time() - t)
        print(f"{name}: {out[name]['seconds']:.1f} s", flush=True)
        del res
        torch.cuda.empty_cache()
    t = time.time()
    out["tensor_parallel"] = cs.tp_phase()
    print(f"phase 18: {time.time() - t:.1f} s", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tp_probe.json").write_text(json.dumps(out, indent=1,
                                                      default=str))
    print("phase 18 passed", flush=True)
    return 0


if __name__ == "__main__":      # the ranks are spawned: they import this
    sys.exit(main())
