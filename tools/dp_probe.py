"""Phase 16 of ``chip_smoke.py`` (data parallelism, two ranks on the one
card) alone: build the kernels, make reddit at scale 1 and run
``chip_smoke.dp_phase``, which prints its checks and timings and raises on
a failed check. Needs one CUDA card and the toolkit; ~5 min with the
build. Its details go to ``chiprun_out/dp_probe.json``.

    python tools/dp_probe.py
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
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    t = time.time()
    built = build_kernels()
    print(f"build {time.time() - t:.1f} s {sorted(built)}", flush=True)
    from repro_torch.data import make_dataset
    t = time.time()
    ds = make_dataset("reddit", scale=1)
    print(f"dataset {time.time() - t:.1f} s", flush=True)
    out = cs.dp_phase(ds)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "dp_probe.json").write_text(json.dumps(out, indent=1,
                                                      default=str))
    print("phase 16 passed", flush=True)
    return 0


if __name__ == "__main__":      # the ranks are spawned: they import this
    sys.exit(main())
