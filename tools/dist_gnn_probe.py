"""Phase 17 of ``chip_smoke.py`` (distributed GNN message passing, four
ranks on the one card) alone: build the kernels, make reddit at scale 1
and run ``chip_smoke.dg_phase``, which prints its checks and timings and
raises on a failed check. Needs one CUDA card and the toolkit; ~3 min
with the build. Its details go to ``chiprun_out/dist_gnn_probe.json``.

    python tools/dist_gnn_probe.py
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
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    t = time.time()
    built = build_kernels()
    print(f"build {time.time() - t:.1f} s {sorted(built)}", flush=True)
    from repro_torch.data import make_dataset
    t = time.time()
    ds = make_dataset("reddit", scale=1)
    print(f"dataset {time.time() - t:.1f} s", flush=True)
    out = cs.dg_phase(ds)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "dist_gnn_probe.json").write_text(json.dumps(out, indent=1,
                                                            default=str))
    print("phase 17 passed", flush=True)
    return 0


if __name__ == "__main__":      # the ranks are spawned: they import this
    sys.exit(main())
