"""Hold the BSR SpMM and bf16 flash attention kernels against their plain
versions at small shapes, then time them at the main path's sizes beside
the same kernels of another checkout, in turns (other, this, this,
other). Needs one CUDA card and ``nvcc``.

    python tools/compare_kernels.py [--other DIR] [--variants]

``--other DIR``: the root of a second checkout (e.g. the parent commit
unpacked with ``git archive``); its kernels build into
``DIR/build/kernels``. ``--variants``: also time source variants of
``csrc/bsr_spmm.cu`` with one part of the work taken out (the wgmma
products, two of the three split passes, the B split, the TMA loads, the
A split), each compiled into ``build/variants/`` and loaded in place of
the kernel: what each costs on the critical path. The variants' results
are wrong by construction; only their times mean anything.

Timings: a synthetic 518 x 518 grid of 230,000 dense 128 x 128 tiles
(5 % of entries nonzero) at K = 256, the tile count and shape of
ogbn-proteins at scale 1/2 in ``chip_smoke.py`` phase 7, once with the
tiles skewed over the block rows and once spread evenly; flash attention
at B 4, 32 / 8 heads, S = T = 2,048, D 128, causal, bf16 (phase 10's
prefill), beside ``scaled_dot_product_attention``. CUDA events, the mean
of 5 (BSR) or 20 (flash) calls after 2 warm-up calls. Prints one JSON
line per timing run.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
VARIANT_DIR = ROOT / "build" / "variants"

# (source text, replacement) edits of csrc/bsr_spmm.cu
_MMA = ["        hopper::WgmmaTf32RS<FK>::mma(acc, a_lo[p][ks], dh, 1);\n",
        "        hopper::WgmmaTf32RS<FK>::mma(acc, a_hi[p][ks], dl, 1);\n"]
VARIANTS = {
    "one_pass": [(m, "") for m in _MMA],
    "no_mma": [(m, "") for m in _MMA] + [
        ("        hopper::WgmmaTf32RS<FK>::mma(acc, a_hi[p][ks], dh, 1);\n",
         "")],
    "no_split_b": [("      for (int i = threadIdx.x; i < C::kBBytes / 16; "
                    "i += kConsumers) {", "      for (int i = threadIdx.x; "
                    "i < 0; i += kConsumers) {")],
    "no_load": [
        ("""        hopper::tma_load_2d(st, &tiles, &full[stage], col,
                            b * br + half * ROWS);""", ""),
        ("""        hopper::tma_load_3d(st + C::kABytes, &h_t, &full[stage], 0, kt * FK,
                            chunk32);""", ""),
        ("""        hopper::mbar_arrive_expect_tx(&full[stage],
                                      C::kABytes + C::kBBytes);""",
         "        hopper::mbar_arrive(&full[stage]);")],
    "no_split_a": [("""          a_lo[p][ks][q] =
              hopper::tf32_rna(x - __uint_as_float(a_hi[p][ks][q]));""",
                    "          a_lo[p][ks][q] = 0;")],
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def synth_bsr(n_brows, n_bcols, nblocks, br, bc, seed, skew):
    """Random tiles (5 % nonzero) over sorted block rows, drawn with row
    weights u^4 + 0.05 (``skew``) or evenly."""
    import torch
    from repro_torch.core import sparse as tsp
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.rand(n_brows, generator=g, device="cuda") ** 4 + 0.05
         if skew else torch.ones(n_brows, device="cuda"))
    rows = torch.multinomial(w, nblocks, replacement=True, generator=g)
    rows = torch.sort(rows).values.to(torch.int32)
    cols = torch.randint(0, n_bcols, (nblocks,), generator=g, device="cuda",
                         dtype=torch.int32)
    blocks = torch.randn((nblocks, br, bc), generator=g, device="cuda")
    blocks *= torch.rand((nblocks, br, bc), generator=g, device="cuda") < 0.05
    return tsp.BSR(blk_row=rows, blk_col=cols, blocks=blocks,
                   nrows=n_brows * br, ncols=n_bcols * bc, br=br, bc=bc,
                   n_real_blocks=nblocks)


def check():
    """Both kernels against their plain versions: BSR within
    ``split_tf32_bound`` and bitwise across two launches, flash within
    2^-7 x max|plain|."""
    import dataclasses
    import torch
    from repro_torch.kernels.bsr_spmm import (bsr_spmm_cuda, bsr_spmm_plain,
                                              split_tf32_bound)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    worst = 0.0
    for br, bc in ((32, 128), (64, 128), (128, 128), (256, 128), (128, 256),
                   (64, 64), (128, 32)):
        for k in (1, 16, 112, 256, 300):
            a = synth_bsr(5, 4, 13, br, bc, seed=br + bc + k, skew=True)
            h = torch.randn((a.ncols - 7, k), device="cuda")
            out = bsr_spmm_cuda(a, h)
            want = bsr_spmm_plain(a, h)
            mag = bsr_spmm_plain(dataclasses.replace(a, blocks=a.blocks.abs()),
                                 h.abs())
            nz = (a.blocks != 0).sum(dim=2, dtype=torch.int32)
            d = torch.zeros((a.n_block_rows, a.br), dtype=torch.int32,
                            device="cuda")
            d.index_add_(0, a.blk_row.long(), nz)
            bound = split_tf32_bound(d.reshape(-1).float()[:, None], mag)
            ratio = float(((out - want).abs() / (bound + 1e-30)).max())
            worst = max(worst, ratio)
            assert ratio <= 1.0, (br, bc, k, ratio)
            assert torch.equal(out, bsr_spmm_cuda(a, h)), "not deterministic"
    log(f"bsr: worst |diff| / bound {worst:.4f}")
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for b, hq, hkv, s, t, d, causal, window in [
            (1, 2, 2, 128, 128, 128, True, None),
            (2, 4, 1, 200, 330, 64, True, None),
            (1, 4, 4, 77, 77, 32, True, None),
            (1, 8, 2, 300, 300, 128, False, None),
            (1, 4, 1, 257, 400, 64, True, 100),
            (2, 4, 4, 64, 64, 32, False, 20),
            (1, 2, 2, 1, 150, 128, True, None)]:
        q, k, v = (torch.randn((b, n, m, d), generator=g, device="cuda")
                   .bfloat16() for n, m in ((hq, s), (hkv, t), (hkv, t)))
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        ratio = float((out.float() - want.float()).abs().max()
                      / want.float().abs().max())
        worst = max(worst, ratio)
        assert ratio <= 2.0 ** -7, ratio
    log(f"flash: worst |diff| / max|plain| {worst:.5f}")


def time_run(tag: str, variant: str | None) -> dict:
    import torch
    import repro_torch.kernels.ops  # noqa: F401  (package import order)
    if variant:
        import repro_torch.kernels.build as kb
        lib = ctypes.CDLL(str(VARIANT_DIR / f"lib{variant}.so"))
        for fn_name, argtypes in kb._SIGNATURES["bsr_spmm"].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        kb._LOADED["bsr_spmm"] = lib
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    res = dict(tag=tag)
    for skew in (True, False):
        a = synth_bsr(518, 518, 230_000, 128, 128, seed=1, skew=skew)
        h = torch.randn((a.ncols - 50, 256), device="cuda")
        res["bsr_ms" if skew else "bsr_even_ms"] = cuda_ms(
            lambda: bsr_spmm_cuda(a, h), reps=5)
        del a
    if variant:
        return res
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((4, 32, 2048, 128), generator=g, device="cuda").bfloat16()
    k = torch.randn((4, 8, 2048, 128), generator=g, device="cuda").bfloat16()
    v = torch.randn((4, 8, 2048, 128), generator=g, device="cuda").bfloat16()
    res["flash_ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v), reps=20)
    import torch.nn.functional as F
    res["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=20)
    return res


def build_variants():
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "bsr_spmm.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: source text not found")
            text = text.replace(old, new)
        path = VARIANT_DIR / f"bsr_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(VARIANT_DIR / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--time", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:                      # one timing run, in its own process
        print(json.dumps(time_run(args.time, args.variant)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    import repro_torch.kernels.ops  # noqa: F401  (package import order)
    from repro_torch.kernels.build import build_kernels
    t0 = time.perf_counter()
    build_kernels(["bsr_spmm", "flash_attention"])
    if args.variants:
        build_variants()
    log(f"build {time.perf_counter() - t0:.1f} s")
    check()

    def run(tag, root=ROOT, variant=None):
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        if root != ROOT:
            env["REPRO_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
        cmd = [sys.executable, str(Path(__file__).resolve()), "--time", tag]
        if variant:
            cmd += ["--variant", variant]
        r = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"timing run {tag} failed:\n{r.stderr}")
        log(r.stdout.strip())

    order = ["other", "this", "this", "other"] if args.other else ["this"]
    for tag in order:
        run(tag, args.other if tag == "other" else ROOT)
    if args.variants:
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            run(f"variant {name}", variant=name)
    return 0


if __name__ == "__main__":
    if "--time" not in sys.argv:       # a timing run imports $PYTHONPATH's
        sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
