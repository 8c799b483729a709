"""Phase 19 of ``chip_smoke.py`` (the manual expert-parallel MoE, sixteen
model ranks on the one card) alone: build the kernels, then
``chip_smoke.ep_phase``, which runs the one-card oracle, starts the
sixteen ranks, prints its checks and timings and raises on a failed
check. ``--pipeline`` also runs phase 17's pipeline case in four ranks of
its own (``chip_smoke.pp_case``). Needs one CUDA card and the toolkit;
~3 min with the build. Its details go to ``chiprun_out/ep_probe.json``.

    python tools/ep_probe.py [--pipeline]
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def pp_rank(mesh) -> dict:
    """Phase 17's pipeline case in one of four ranks of its own."""
    import chip_smoke as cs
    return cs.pp_case(mesh.device)


def main() -> int:
    ap = argparse.ArgumentParser(prog="python tools/ep_probe.py")
    ap.add_argument("--pipeline", action="store_true",
                    help="also run phase 17's pipeline case in four ranks")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.dist import run_ranks
    from repro_torch.kernels.build import build_kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    t = time.time()
    built = build_kernels()
    print(f"build {time.time() - t:.1f} s {sorted(built)}", flush=True)
    out = {}
    if args.pipeline:
        t = time.time()
        pps = run_ranks(pp_rank, cs.PP_STAGES, str(ROOT / "build"),
                        device=cs.DEVICE, timeout_s=cs.DG_TIMEOUT_S)
        bad = [p for p in pps if not (p["max_abs_err"] <= cs.PP_ATOL
                                      and p["replicated"]
                                      and not p["launches"])]
        print(f"pipeline ({pps[0]['shape']}): max |diff| "
              f"{[p['max_abs_err'] for p in pps]} (atol {cs.PP_ATOL}), ms "
              f"{[round(p['ms'], 1) for p in pps]}, "
              f"{time.time() - t:.1f} s", flush=True)
        out["pipeline"] = pps
        if bad:
            raise AssertionError(f"the pipeline failed on the card: {bad}")
    t = time.time()
    out["expert_parallel"] = cs.ep_phase()
    print(f"phase 19: {time.time() - t:.1f} s", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ep_probe.json").write_text(json.dumps(out, indent=1,
                                                      default=str))
    print("phase 19 passed", flush=True)
    return 0


if __name__ == "__main__":      # the ranks are spawned: they import this
    sys.exit(main())
