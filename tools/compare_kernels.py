"""Hold the BSR SpMM, bf16 flash attention and its backward, bf16 ragged
GEMM and its dX, scaled block SDDMM, SELL SpMM, FusedMM, sampling-hop and
ordered segment-sum kernels against their plain versions at small shapes,
then time them at
the main path's sizes beside the same kernels of another checkout, in
turns (other, this, this, other). Needs one CUDA card and ``nvcc``.

    python tools/compare_kernels.py [--other DIR] [--variants]
        [--kernels bsr,flash,ragged,sddmm,sell,fusedmm,sample,segsum,edgedots,
                   flashbwd,dx]

``--other DIR``: the root of a second checkout (e.g. the parent commit
unpacked with ``git archive``); its kernels build into
``DIR/build/kernels``. ``--variants``: also time source variants with one
part of the work taken out or one route forced, each compiled into
``build/variants/`` and loaded in place of the kernel: of
``csrc/bsr_spmm.cu`` the wgmma products, two of the three split passes,
the B split, the TMA loads, the A split (what each costs on the critical
path; their results are wrong by construction, only their times mean
anything); of ``csrc/sddmm.cu`` the scaled kernel with its dense-slice
route taken out (every slice per nonzero, exact, as at any fill below
the threshold) and with its per-nonzero y reads taken out (D % 4 == 0,
wrong by construction), timed over the fill sweep; of
``csrc/sell_spmm.cu`` one and eight gathered rows in flight a lane
(exact); of ``csrc/fusedmm.cu`` every tile on the edge route, every tile
on the tile route (both exact), the edge route without its per-tile
barrier (exact where no tile is dense), and batches of 2 and 8 edges
(the latter also with one CTA an SM's registers), timed over the fill
sweep and on the proteins graph; of ``csrc/segment_sum.cu`` one, four and
eight gathered rows in flight a lane in place of two on its sliced route
(all exact), timed at the segment-sum sizes below; of
``csrc/flash_attention_bwd.cu`` a 3-stage ring in place of 2 at D 64 /
128 (exact), a 2-stage ring in place of 4 at D 80 (exact), at D 80 the
S / dP products, the dV / dK / dQ products or P's 2^x taken out, and, at D 256,
the S / dP products, the dV / dK / dQ products or the barrier before P
and dS are written again taken out; of ``csrc/flash_attention.cu``, timed
at hubert's shape alone, the D 80 forward without its ping-pong (both
warpgroups issue their products at once, then both run their softmax),
with 2 or 4 ring stages in place of 3 (all exact), and with its S
products, its P V products, its K / V loads,
its softmax, its 2^x taken out or the 2^x as the bare ex2.approx.ftz
instruction (wrong by construction; only their times mean anything).
``--variants a,b``: only the variants named. ``--kernels``: check and
time only these (default all eleven).

Timings (CUDA events, the mean of a few calls after 2 warm-up calls):
- BSR: a synthetic 518 x 518 grid of 230,000 dense 128 x 128 tiles (5 %
  of entries nonzero) at K = 256, the tile count and shape of
  ogbn-proteins at scale 1/2 in ``chip_smoke.py`` phase 7, once with the
  tiles skewed over the block rows and once spread evenly;
- flash attention at B 4, 32 / 8 heads, S = T = 2,048, D 128, causal,
  bf16 (phase 10's prefill), at gemma-7b's B 1, 16 heads of 256, and at
  hubert-xlarge's B 4, 16 / 16 heads of 80, S = T = 4,096, non-causal
  (phase 15's; also its device ms), beside
  ``scaled_dot_product_attention``;
- the flash backward (``flashbwd``) at phase 12's shape (B 4, 32 / 8
  heads, S = T = 2,048, D 128, causal, bf16) and at gemma-7b's (B 1,
  16 / 16 heads of 256, S = T = 2,048, causal, bf16: each checkout's own
  D 256 instance) and at hubert-xlarge's (as the forward), each with its
  two kernels' device ms, beside SDPA's backward. The outputs at
  hubert's shape (the forward's O and LSE, the backward's dQ, dK, dV)
  are kept from each checkout's first timing run, and the largest
  difference between the two checkouts' is printed;
- the ragged GEMM's dX (``dx``) at phase 12's shape (dY 20,480 x 6,400,
  W 16 x 4,096 x 6,400, bf16) as each checkout's backward calls it: the
  kernel reading W transposed in place where the checkout's wrapper takes
  it, else on a contiguous copy of Wᵀ made in the call, beside
  ``torch.bmm`` on the transposed view;
- the ragged GEMM at phase 10's shapes, 16 experts in order: the prefill
  gate 20,480 x 4,096 x 6,400 and down 20,480 x 6,400 x 4,096, the decode
  gate 2,048 x 4,096 x 6,400, bf16, beside ``torch.bmm`` over the
  (E, C, D) buffer;
- the SDDMM scaled by A at D = 256 on a synthetic 259 x 259 grid of 239
  tiles of 128 x 128 a block row (61,901 tiles, ogbn-proteins at scale
  1/4 in phase 9), x and y of 33,152 rows, at 0.7 % fill (phase 9's) and
  50 % beside ``torch.sparse.sampled_addmm`` on the same pattern in CSR,
  the unscaled kernel at 0.7 %, and the scaled kernel over a fill sweep
  (0.7, 2, 4, 8, 16, 50 %);
- SELL (C = 8) on a synthetic reddit-shaped matrix (232,965 rows: one of
  30,614 entries, seven of 14,300, the rest 22 sqrt(n / (i + 1)) for the
  i-th, ~10 M entries; columns drawn with density falling as
  1 / sqrt(column)) at K = 602 and 256, beside ``torch.sparse.mm`` on the
  same matrix in CSR, and, where the wrapper takes ``chunk``, at K = 602
  over the chunk sweep ``SELL_CHUNKS``;
- FusedMM at D = K = 256 (softmax) on A of ogbn-proteins at scale 1/4
  (phase 9's graph, hub rows included) and on the SDDMM's synthetic grid
  (no hub rows) over the same fill sweep, sigmoid and none at 0.7 %,
  beside ``scaled_dot_product_attention`` with the dense boolean mask at
  0.7 %;
- the sampling hop on a synthetic reddit-sized graph (232,965 nodes,
  ~10 M edges) at phase 8's two hop shapes (20,992 x 10 and 1,024 x 25):
  the fused ``sample_hop`` (where the checkout has it) beside the hop as
  separate calls, the standalone ``segment_sample`` / ``expand_indptr`` /
  ``flat_gather`` and ``torch.take`` (ms and host µs a call),
  ``DeviceSampler.sample_blocks`` a batch of 1,024 seeds and one
  device-sampled GraphSAGE-mean training step over it (hidden 256, 602
  random features);
- the ordered segment sum (``segsum``) as each checkout runs it: gat's
  dh on ogbn-proteins at scale 1/4 (phase 9's graph, 7.0 M edges in the
  cached column order) at K = 256 and 112 through ``gather_scale_sum``
  and as the bare kernel, reddit's trusted candidate
  at K = 256 (the synthetic reddit-shaped matrix above, 10.3 M slots),
  the minibatch block's trusted forward at K = 602 and ELL backward at
  K = 256 (synthetic blocks of phase 8's shapes), each beside
  ``torch.sparse.mm``; each size also as the bare kernel on operands
  sorted beforehand (the device sort of a block's backward outside the
  timed window; 20 calls under CUDA events, and in a profiler trace);
  and a patched gat training step (loss and gradients) on the same graph
  with A pinned to BSR 128 x 128;
- the per-edge SDDMM (``edgedots``) on the same graph at D = K = 256:
  the gat backward's two dot products as one dual launch where the
  checkout has the kernel, else the two plain calls it ran on the card,
  the single launch, and ``torch.sparse.sampled_addmm``.
Prints one JSON line per timing run.
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
_BSR_VARIANTS = {
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
# variant name -> (kernel library it replaces, [(source text, replacement)])
VARIANTS = {name: ("bsr_spmm", edits)
            for name, edits in _BSR_VARIANTS.items()}
VARIANTS["sddmm_no_dense_route"] = ("sddmm", [
    ("    if (total * kDenseDiv > kRows * BC) {", "    if (false) {"),
    ("static constexpr int kCap = kRows * BC / kDenseDiv;",
     "static constexpr int kCap = kRows * BC;")])
VARIANTS["sddmm_no_y_reads"] = ("sddmm", [
    ("yr && c < d ? __ldg(reinterpret_cast<const float4*>(yr + c))",
     "yr && c < d ? make_float4(1.f, 1.f, 1.f, 1.f)")])
_SEG_LOADS = "constexpr int kLoads = 2;"
for _n in (1, 4, 8):
    VARIANTS[f"segsum_loads_{_n}"] = ("segment_sum", [
        (_SEG_LOADS, f"constexpr int kLoads = {_n};")])
VARIANTS["sell_in_flight_1"] = ("sell_spmm", [
    ("constexpr int kInFlight = 4;", "constexpr int kInFlight = 1;")])
VARIANTS["sell_in_flight_8"] = ("sell_spmm", [
    ("constexpr int kInFlight = 4;", "constexpr int kInFlight = 8;")])
_FUSED_ROUTE = "    if (total * kDenseDiv > kRows * BC) {"
VARIANTS["fusedmm_edge_only"] = ("fusedmm", [(_FUSED_ROUTE, "    if (false) {")])
VARIANTS["fusedmm_tile_only"] = ("fusedmm", [(_FUSED_ROUTE, "    if (true) {")])
_FUSED_BATCH = "constexpr int batch() { return NQ <= 2 ? 4 : 2; }"
VARIANTS["fusedmm_batch_2"] = ("fusedmm", [
    (_FUSED_BATCH, "constexpr int batch() { return 2; }")])
VARIANTS["fusedmm_batch_8"] = ("fusedmm", [
    (_FUSED_BATCH, "constexpr int batch() { return NQ <= 2 ? 8 : 2; }")])
VARIANTS["fusedmm_batch_8_one_cta"] = ("fusedmm", [
    (_FUSED_BATCH, "constexpr int batch() { return NQ <= 2 ? 8 : 2; }"),
    ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")])
VARIANTS["fusedmm_no_tile_barrier"] = ("fusedmm", [
    (_FUSED_ROUTE, "    if (false) {"),
    ("    __syncthreads();\n    int total = 0;", "    int total = 0;")])
# the D 64 / 128 design's ring (the D 256 design has no room for a third
# stage)
VARIANTS["flashbwd_stages_3"] = ("flash_attention_bwd", [
    ("kStages = D == 80 ? 4 : 2;", "kStages = D == 80 ? 4 : 3;")])
VARIANTS["flashbwd_d80_stages_2"] = ("flash_attention_bwd", [
    ("kStages = D == 80 ? 4 : 2;", "kStages = 2;")])
# the D 80 forward without its ping-pong (the overlap of one warpgroup's
# products with the other's softmax taken out), and with another ring
# depth; all exact
VARIANTS["flash_d80_no_pingpong"] = ("flash_attention", [
    ("constexpr bool kPingPong = true;", "constexpr bool kPingPong = false;")])
VARIANTS["flash_d80_stages_2"] = ("flash_attention", [
    ("  static constexpr int kStages = 3;", "  static constexpr int kStages = 2;")])
VARIANTS["flash_d80_stages_4"] = ("flash_attention", [
    ("  static constexpr int kStages = 3;", "  static constexpr int kStages = 4;")])
# the D 80 forward with one part of its work taken out (wrong by
# construction; only the times mean anything): the S products, the P V
# products, the K / V loads (the barriers complete on the arrival alone),
# the softmax of every tile past the first, the softmax's 2^x (P = the
# scaled score less the max), and the 2^x as the bare ex2.approx.ftz
# instruction (close, not exact)
_P_EXP = "p[e] = exp2f(sc[8 * kk + e] + neg[h]);"
VARIANTS["flash_d80_no_scores"] = ("flash_attention", [
    ("kk < kD / 16; ++kk)\n      hopper::WgmmaBf16SS", "kk < 0; ++kk)\n      hopper::WgmmaBf16SS")])
VARIANTS["flash_d80_no_pv"] = ("flash_attention", [
    ("kk < kBK / 16; ++kk)\n      hopper::WgmmaBf16RS<kD",
     "kk < 0; ++kk)\n      hopper::WgmmaBf16RS<kD")])
VARIANTS["flash_d80_no_kv_loads"] = ("flash_attention", [
    ("hopper::mbar_arrive_expect_tx(&k_full[stage], C::kKVBytes);\n#pragma unroll\n        for (int a = 0; a < C::kAtoms; ++a)",
     "hopper::mbar_arrive_expect_tx(&k_full[stage], 0);\n#pragma unroll\n        for (int a = 0; a < 0; ++a)"),
    ("hopper::mbar_arrive_expect_tx(&v_full[stage], C::kKVBytes);\n#pragma unroll\n        for (int a = 0; a < C::kAtoms; ++a)",
     "hopper::mbar_arrive_expect_tx(&v_full[stage], 0);\n#pragma unroll\n        for (int a = 0; a < 0; ++a)")])
VARIANTS["flash_d80_no_softmax"] = ("flash_attention", [
    ("    softmax((long long)walk.tile(i) * kBK);\n", "")])
VARIANTS["flash_d80_no_exp"] = ("flash_attention", [
    (_P_EXP, "p[e] = sc[8 * kk + e] + neg[h];")])
VARIANTS["flash_d80_fast_exp"] = ("flash_attention", [
    (_P_EXP, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p[e]) : '
             '"f"(sc[8 * kk + e] + neg[h]));')])
# the backward (every wgmma instance; read at D 80) with its S / dP
# products, its dV / dK / dQ products or P's 2^x taken out
VARIANTS["flashbwd_d80_no_scores"] = ("flash_attention_bwd", [
    ("kk < D / 16; ++kk)\n        hopper::WgmmaBf16SS<64>",
     "kk < 0; ++kk)\n        hopper::WgmmaBf16SS<64>")])
VARIANTS["flashbwd_d80_no_grads"] = ("flash_attention_bwd", [
    ("kk < 4; ++kk)\n        hopper::WgmmaBf16RS<D, 1>",
     "kk < 0; ++kk)\n        hopper::WgmmaBf16RS<D, 1>")])
VARIANTS["flashbwd_d80_no_exp"] = ("flash_attention_bwd", [
    ("const float pv = exp2f(sc[idx] * scale_log2 - lse2(idx));",
     "const float pv = sc[idx] * scale_log2 - lse2(idx);")])
# the D 256 design with one part of its work taken out (wrong by
# construction; only the times mean anything): the S and dP products, the
# dV / dK / dQ products, the barrier before P / dS are written again
VARIANTS["flashbwd_d256_no_scores"] = ("flash_attention_bwd", [
    ("kk < C::kD / 16", "kk < 0")])
VARIANTS["flashbwd_d256_no_grads"] = ("flash_attention_bwd", [
    ("for (int kk = 0; kk < 4; ++kk)\n      hopper::WgmmaBf16SS<128, 1>",
     "for (int kk = 0; kk < 0; ++kk)\n      hopper::WgmmaBf16SS<128, 1>")])
VARIANTS["flashbwd_d256_no_war_barrier"] = ("flash_attention_bwd", [
    ("    hopper::named_barrier_sync(3, 256);\n", ""),
    ("again\n    hopper::named_barrier_sync(2, 256);\n", "again\n")])
SDDMM_FILLS = (0.007, 0.02, 0.04, 0.08, 0.16, 0.5)
SELL_CHUNKS = (256, 512, 2048)     # beside the wrapper's CHUNK_STEPS
CACHE_DIR = ROOT / "build" / "compare_cache"


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


def device_ms(fn, name: str, reps: int = 10):
    """Device ms a call of the kernels whose names contain ``name``, from
    a ``torch.profiler`` trace of ``reps`` calls (a traced warm-up call
    discarded, then a quarter second with nothing launched, as
    ``chip_smoke.profiled`` does); None where the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    got = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.setdefault(
                     "events", p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.25)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    us = sum(float(getattr(e, "self_device_time_total", 0.0))
             for e in got["events"] if name in e.key)
    return us / reps / 1e3 if us else None


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


def check_bsr():
    """BSR against its plain version within ``split_tf32_bound`` and
    bitwise across two launches."""
    import dataclasses
    import torch
    from repro_torch.kernels.bsr_spmm import (bsr_spmm_cuda, bsr_spmm_plain,
                                              split_tf32_bound)
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


def check_flash():
    """bf16 flash attention within 2^-7 x max|plain|."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for b, hq, hkv, s, t, d, causal, window in [
            (1, 2, 2, 128, 128, 128, True, None),
            (2, 4, 1, 200, 330, 64, True, None),
            (1, 4, 4, 77, 77, 32, True, None),
            (1, 8, 2, 300, 300, 128, False, None),
            (1, 4, 1, 257, 400, 64, True, 100),
            (2, 4, 4, 64, 64, 32, False, 20),
            (1, 2, 2, 1, 150, 128, True, None),
            (1, 4, 4, 300, 300, 80, False, None),
            (2, 4, 2, 200, 333, 80, True, None),
            (1, 4, 1, 257, 400, 80, True, 100)]:
        q, k, v = (torch.randn((b, n, m, d), generator=g, device="cuda")
                   .bfloat16() for n, m in ((hq, s), (hkv, t), (hkv, t)))
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        ratio = float((out.float() - want.float()).abs().max()
                      / want.float().abs().max())
        worst = max(worst, ratio)
        assert ratio <= 2.0 ** -7, ratio
    log(f"flash: worst |diff| / max|plain| {worst:.5f}")


def check_ragged():
    """bf16 ragged GEMM against its plain version within 2^-7 x
    max|plain|, on the wgmma instance (D, F multiples of 8) and the wmma
    one, bitwise across two launches."""
    import torch
    from repro_torch.kernels.ragged_gemm import (ragged_gemm_cuda,
                                                 ragged_gemm_plain)
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for e, t, d, f in ((3, 640, 256, 200), (16, 2048, 4096, 6400),
                       (5, 1280, 512, 6408), (4, 512, 100, 72)):
        x = torch.randn((t, d), generator=g, device="cuda").bfloat16()
        w = torch.randn((e, d, f), generator=g, device="cuda").bfloat16()
        te = torch.randint(0, e, (t // 128,), generator=g, device="cuda",
                           dtype=torch.int32)
        out = ragged_gemm_cuda(x, w, te)
        want = ragged_gemm_plain(x, w, te)
        ratio = float((out.float() - want.float()).abs().max()
                      / want.float().abs().max())
        worst = max(worst, ratio)
        assert ratio <= 2.0 ** -7, (e, t, d, f, ratio)
        assert torch.equal(out, ragged_gemm_cuda(x, w, te)), \
            "not deterministic"
    log(f"ragged: worst |diff| / max|plain| {worst:.5f}, instances "
        f"{ragged_gemm_cuda.launches_by_instance}")


def _bwd_inputs(b, hq, hkv, s, t, d, causal, window, seed):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    q, k, v, do = rn(b, hq, s, d), rn(b, hkv, t, d), rn(b, hkv, t, d), \
        rn(b, hq, s, d)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    return q, k, v, o, do, lse


def check_flashbwd():
    """bf16 flash backward within 2^-7 x max|plain|, bitwise repeatable."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    worst = 0.0
    for b, hq, hkv, s, t, d, causal, window in (
            (1, 8, 2, 256, 256, 128, True, None),
            (2, 4, 1, 200, 333, 64, True, 100),
            (1, 4, 4, 300, 300, 128, False, 64),
            (1, 4, 1, 200, 333, 256, True, None),
            (1, 4, 2, 150, 150, 256, False, 70),
            (1, 4, 4, 300, 300, 80, False, None),
            (2, 4, 2, 200, 333, 80, True, 100)):
        args = _bwd_inputs(b, hq, hkv, s, t, d, causal, window, s + t)
        kw = dict(causal=causal, window=window)
        got = flash_attention_bwd_cuda(*args, **kw)
        want = flash_attention_bwd_plain(*args, **kw)
        for g_, w_ in zip(got, want):
            err = float((g_.float() - w_.float()).abs().max()
                        / w_.float().abs().max())
            assert err <= 2.0 ** -7, (b, hq, s, t, d, err)
            worst = max(worst, err)
        again = flash_attention_bwd_cuda(*args, **kw)
        assert all(torch.equal(a, c) for a, c in zip(got, again))
    log(f"flash backward: worst |diff| / max|plain| {worst:.5f}")


def _dx(dy, w, te):
    """dX as this checkout's backward makes it: W read in place where the
    wrapper takes it, else a contiguous Wᵀ (the earlier backward)."""
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    try:
        return ragged_gemm_cuda(dy, w, te, direction="backward")
    except ValueError:
        return ragged_gemm_cuda(dy, w.transpose(1, 2).contiguous(), te,
                                direction="backward")


def _dx_inputs(t, d, f, e, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn((t, f), generator=g, device="cuda").bfloat16()
    w = torch.randn((e, d, f), generator=g, device="cuda").bfloat16()
    te = (torch.arange(t // 128, device="cuda") * e // (t // 128)).to(
        torch.int32)
    return dy, w, te


def check_dx():
    """The ragged GEMM's dX within 2^-7 x max|plain|."""
    from repro_torch.kernels.ragged_gemm import ragged_gemm_plain
    worst = 0.0
    for t, d, f, e in ((2048, 4096, 6400, 16), (1024, 520, 200, 4)):
        dy, w, te = _dx_inputs(t, d, f, e, t + d)
        got = _dx(dy, w, te)
        want = ragged_gemm_plain(dy, w.transpose(1, 2).contiguous(), te)
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert err <= 2.0 ** -7, (t, d, f, err)
        worst = max(worst, err)
    log(f"dX: worst |diff| / max|plain| {worst:.5f}")


def check_sddmm():
    """Scaled SDDMM against the plain tile products within 2 (D + 1) eps
    sum|x y| |a| at fills on both sides of the dense-slice threshold,
    bitwise across two launches."""
    import dataclasses
    import torch
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda, sddmm_bsr_plain
    worst = 0.0
    for bc in (128, 256):
        for fill in (0.007, 0.05, 0.5, 1.0):
            for d in (16, 130, 256):
                a = synth_grid(4, 5, 3, 128, bc, fill, seed=bc + d)
                x = torch.randn((a.nrows - 5, d), device="cuda") / d ** 0.5
                y = torch.randn((a.ncols - 3, d), device="cuda")
                out = sddmm_bsr_cuda(a, x, y)
                want = sddmm_bsr_plain(a, x, y)
                mag = sddmm_bsr_plain(dataclasses.replace(
                    a, blocks=a.blocks.abs()), x.abs(), y.abs())
                ratio = float(((out - want).abs()
                               / (2 * (d + 1) * 2.0 ** -24 * mag + 1e-30))
                              .max())
                worst = max(worst, ratio)
                assert ratio <= 1.0, (bc, fill, d, ratio)
                assert bool((out[a.blocks == 0] == 0).all())
                assert torch.equal(out, sddmm_bsr_cuda(a, x, y)), \
                    "not deterministic"
    log(f"sddmm scaled: worst |diff| / bound {worst:.4f}")


def synth_grid(n_brows, n_bcols, per_row, br, bc, fill, seed):
    """``per_row`` tiles in every block row at distinct, sorted block
    columns, random values at a ``fill`` fraction of positions."""
    import torch
    from repro_torch.core import sparse as tsp
    g = torch.Generator(device="cuda").manual_seed(seed)
    keys = torch.rand((n_brows, n_bcols), generator=g, device="cuda")
    cols = keys.argsort(dim=1)[:, :per_row].sort(dim=1).values
    rows = torch.arange(n_brows, device="cuda").repeat_interleave(per_row)
    nb = rows.numel()
    blocks = torch.randn((nb, br, bc), generator=g, device="cuda")
    blocks *= torch.rand((nb, br, bc), generator=g, device="cuda") < fill
    return tsp.BSR(blk_row=rows.to(torch.int32),
                   blk_col=cols.reshape(-1).to(torch.int32), blocks=blocks,
                   nrows=n_brows * br, ncols=n_bcols * bc, br=br, bc=bc,
                   n_real_blocks=nb)


def grid_csr(a):
    """A's pattern and values in CSR (int32 indices), rows sorted, for
    ``torch.sparse.sampled_addmm``; built a few block rows at a time."""
    import torch
    per_row = a.nblocks // a.n_block_rows
    tiles = a.blocks.view(a.n_block_rows, per_row, a.br, a.bc)
    cols_of = a.blk_col.view(a.n_block_rows, per_row).long()
    crow = [torch.zeros(1, dtype=torch.int64, device="cuda")]
    col, val = [], []
    for r0 in range(0, a.n_block_rows, 16):
        t = tiles[r0:r0 + 16].permute(0, 2, 1, 3)       # (r, i, tile, j)
        nz = (t != 0).reshape(-1, per_row * a.bc)
        idx = nz.nonzero()
        rows_of = torch.arange(r0, r0 + t.shape[0], device="cuda")
        tile_col = cols_of[rows_of].repeat_interleave(a.br, 0)
        col.append((tile_col[idx[:, 0], idx[:, 1] // a.bc] * a.bc +
                    idx[:, 1] % a.bc).to(torch.int32))
        val.append(t.reshape(nz.shape)[nz])
        crow.append(crow[-1][-1] + nz.sum(1).cumsum(0))
    crow = torch.cat(crow).to(torch.int32)
    return torch.sparse_csr_tensor(crow, torch.cat(col), torch.cat(val),
                                   (a.nrows, a.ncols))


def sell_bound_ratio(a, h, out):
    """max |kernel - plain| / (2 d eps sum|terms|) over every element, d
    the row's real slots (chip_smoke.py's per-row bound)."""
    import dataclasses
    import torch
    from repro_torch.kernels.sell_spmm import sell_spmm_plain
    want = sell_spmm_plain(a, h)
    mag = sell_spmm_plain(dataclasses.replace(a, val=a.val.abs()), h.abs())
    real = (a.idx < a.ncols).to(torch.int32)
    per = torch.zeros((a.nslices, a.c), dtype=torch.int32, device=h.device)
    per.index_add_(0, a.slice_of.long(), real)
    d = per.reshape(-1)[a.inv_perm.long()].float()[:, None]
    return float(((out - want).abs() / (2 * 2.0 ** -24 * d * mag + 1e-30))
                 .max())


def skewed_sell(n, m, hub, rest, c, seed, pad=0):
    """A SELL operand with one hub row of ``hub`` entries among rows of up
    to ``rest`` entries, some rows empty, and ``pad`` sentinel steps
    appended to the last slice."""
    import numpy as np
    from repro_torch.core import sparse as tsp
    from repro_torch.sampling.blocks import _pad_sell_steps
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, rest + 1, n)
    deg[rng.integers(0, n)] = hub
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([rng.choice(m, d, replace=d > m) for d in deg])
    key = np.unique(rows * m + cols)
    coo = tsp.coo_from_edges(key % m, key // m, rng.standard_normal(
        key.size).astype(np.float32), n, m)
    sell = tsp.sell_from_coo(coo, c=c)
    return _pad_sell_steps(sell, sell.n_steps + pad)


def check_sell():
    """SELL against its plain version within the per-row bound on hub
    rows past 4 chunks, slices of exactly a multiple of the chunk and one
    step more, padded steps, C 8 / 16 / 32 / 48, K 602 / 256 / 7; both
    routes; bitwise across two launches."""
    import torch
    from repro_torch.core import sparse as tsp
    from repro_torch.kernels.sell_spmm import sell_spmm_cuda
    worst = 0.0
    for c in (8, 16, 32, 48):
        for k in (602, 256, 7):
            for chunk in (64, 96, 4096):
                a = tsp.to_device(skewed_sell(120, 400, 300, 40, c,
                                              seed=c + k, pad=37), "cuda")
                h = torch.randn((400, k), device="cuda")
                out = sell_spmm_cuda(a, h, chunk=chunk)
                ratio = sell_bound_ratio(a, h, out)
                worst = max(worst, ratio)
                assert ratio <= 1.0, (c, k, chunk, ratio)
                assert torch.equal(out, sell_spmm_cuda(a, h, chunk=chunk)), \
                    "not deterministic"
    log(f"sell: worst |diff| / bound {worst:.4f}, routes "
        f"{sell_spmm_cuda.launches_by_instance}")


def synth_reddit():
    """The synthetic reddit-shaped SELL (C = 8) and the same matrix in CSR
    on the card, built once and cached under build/compare_cache."""
    import numpy as np
    import torch
    from repro_torch.core import sparse as tsp
    path = CACHE_DIR / "sell_reddit.pt"
    if not path.exists():
        rng = np.random.default_rng(0)
        n = 232_965
        deg = (22 * np.sqrt(n / np.arange(1, n + 1))).astype(np.int64)
        deg[0], deg[1:8] = 30_614, 14_300
        rows = np.repeat(rng.permutation(n), deg)
        head = int(deg[:8].sum())
        cols = np.concatenate([
            np.concatenate([rng.choice(n, d, replace=False) for d in deg[:8]]),
            (n * rng.random(rows.size - head) ** 2).astype(np.int64)])
        key = np.unique(rows * n + cols)
        coo = tsp.coo_from_edges(key % n, key // n, rng.standard_normal(
            key.size).astype(np.float32), n, n)
        sell = tsp.sell_from_coo(coo, c=8)
        crow = np.zeros(n + 1, np.int64)
        crow[1:] = np.cumsum(np.bincount(key // n, minlength=n))
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        torch.save(dict(sell=sell, crow=torch.from_numpy(crow),
                        col=torch.from_numpy(key % n),
                        val=coo.val[: coo.nse].clone()), path)
    got = torch.load(path, weights_only=False)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        csr = torch.sparse_csr_tensor(got["crow"], got["col"], got["val"],
                                      size=(got["sell"].nrows,) * 2)
    return tsp.to_device(got["sell"], "cuda"), csr.to("cuda")


def check_sell_reddit():
    import torch
    from repro_torch.kernels.sell_spmm import (sell_spmm_cuda, split_chunks,
                                               sell_workspace_bytes)
    a, _ = synth_reddit()
    h = torch.randn((a.ncols, 256), device="cuda")
    ratio = sell_bound_ratio(a, h, sell_spmm_cuda(a, h))
    assert ratio <= 1.0, ratio
    log(f"sell reddit-shaped: {a.nse} entries, {a.n_steps} steps, "
        f"{a.nslices} slices; split chunks {split_chunks(a)}, workspace "
        f"{sell_workspace_bytes(a.n_steps, a.c, 602) / 1e6:.1f} MB at "
        f"K = 602; |diff| / bound {ratio:.4f} at K = 256")


def time_sell(res: dict, sweep_only: bool = False) -> dict:
    import inspect
    import torch
    from repro_torch.kernels.sell_spmm import sell_spmm_cuda
    a, csr = synth_reddit()
    for k in (602, 256):
        h = torch.randn((a.ncols, k), device="cuda")
        res[f"sell_k{k}_ms"] = cuda_ms(lambda: sell_spmm_cuda(a, h), reps=5)
        if not sweep_only:
            res[f"sparse_mm_k{k}_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, h),
                                                reps=5)
        if k == 602 and "chunk" in inspect.signature(
                sell_spmm_cuda).parameters:
            for chunk in SELL_CHUNKS:
                res[f"sell_k{k}_chunk{chunk}_ms"] = cuda_ms(
                    lambda: sell_spmm_cuda(a, h, chunk=chunk), reps=5)
        del h
    return res


def check_fusedmm():
    """FusedMM against its plain version (atol 1e-4 x max|h| for softmax,
    x max|plain| otherwise, chip_smoke.py's check_fused) at bc 128 and
    256, br 32 and 128, D 16 / 130 / 256, K 256 / 602 (two launches),
    tiles from 0.7 % to 100 % filled (both routes), x and y short of the
    operand; bitwise across two launches."""
    import torch
    from repro_torch.kernels.fusedmm import (fusedmm_bsr_cuda,
                                             fusedmm_bsr_plain,
                                             tiles_by_route)
    worst = 0.0
    for bc in (128, 256):
        for br in (32, 128):
            for d, k in ((16, 256), (130, 602), (256, 256)):
                for op in ("softmax", "sigmoid", "none"):
                    a = synth_grid(3, 4, 3, br, bc, 0.01, seed=br + bc + d)
                    a.blocks[1] = torch.randn_like(a.blocks[1]) * (
                        torch.rand_like(a.blocks[1]) < 0.5)
                    a.blocks[4] = torch.randn_like(a.blocks[4])
                    x = torch.randn((a.nrows - 5, d), device="cuda") / d ** .5
                    y = torch.randn((a.ncols - 3, d), device="cuda")
                    h = torch.randn((a.ncols - 3, k), device="cuda")
                    out = fusedmm_bsr_cuda(a, x, y, h, edge_op=op)
                    want = fusedmm_bsr_plain(a, x, y, h, edge_op=op)
                    scale = (h if op == "softmax" else want).abs().max()
                    ratio = float((out - want).abs().max() / (1e-4 * scale))
                    worst = max(worst, ratio)
                    assert ratio <= 1.0, (bc, br, d, k, op, ratio)
                    assert torch.equal(out, fusedmm_bsr_cuda(
                        a, x, y, h, edge_op=op)), "not deterministic"
    log(f"fusedmm: worst |diff| / atol {worst:.4f}, tiles by route "
        f"{tiles_by_route()}")


def proteins_bsr():
    """A of ogbn-proteins at scale 1/4 (the gat graph of chip_smoke.py
    phase 9, its R-MAT hub rows included) as 128 x 128 BSR on the card;
    the edges are generated once and cached under build/compare_cache."""
    import numpy as np
    from repro_torch.core import sparse as tsp
    path = CACHE_DIR / "proteins_quarter.npz"
    if not path.exists():
        from repro_torch.data import make_dataset
        ds = make_dataset("ogbn-proteins", scale=1 / 4)
        n = ds.coo.nse
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        np.savez(path, row=ds.coo.row[:n].numpy(), col=ds.coo.col[:n].numpy(),
                 n=ds.coo.nrows)
    got = np.load(path)
    coo = tsp.coo_from_edges(got["col"], got["row"], None, int(got["n"]),
                             int(got["n"]))
    return tsp.to_device(tsp.bsr_from_coo(coo, br=128, bc=128), "cuda")


def time_fusedmm(res: dict, sweep_only: bool = False) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fusedmm import fusedmm_bsr_cuda
    a = proteins_bsr()
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn((a.nrows, 256), generator=g, device="cuda") / s
               for s in (16, 1, 1))
    res["fusedmm_softmax_proteins_ms"] = cuda_ms(
        lambda: fusedmm_bsr_cuda(a, q, k, v), reps=3)
    del a, q, k, v
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(3)
    n = 259 * 128
    x = torch.randn((n, 256), generator=g, device="cuda") / 16
    y = torch.randn((n, 256), generator=g, device="cuda")
    h = torch.randn((n, 256), generator=g, device="cuda")
    for fill in SDDMM_FILLS:
        a = synth_grid(259, 259, 239, 128, 128, fill, seed=1)
        ops = ("softmax",) if sweep_only or fill != 0.007 else \
            ("softmax", "sigmoid", "none")
        for op in ops:
            res[f"fusedmm_{op}_fill{fill}_ms"] = cuda_ms(
                lambda: fusedmm_bsr_cuda(a, x, y, h, edge_op=op), reps=3)
        if not sweep_only and fill == 0.007:
            tile = a.blocks != 0
            mask = torch.zeros((n, n), dtype=torch.bool, device="cuda")
            b, i, j = tile.nonzero(as_tuple=True)
            mask[a.blk_row[b].long() * 128 + i, a.blk_col[b].long() * 128
                 + j] = True
            del tile, b, i, j
            try:
                res["sdpa_dense_mask_fill0.007_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        x[None, None], y[None, None], h[None, None],
                        attn_mask=mask, scale=1.0), reps=3)
            except RuntimeError as err:       # a yardstick only
                res["sdpa_error"] = str(err)[:200]
            del mask
        del a
        torch.cuda.empty_cache()
    return res


def time_run(tag: str, variant: str | None, kernels) -> dict:
    import repro_torch.kernels.ops  # noqa: F401  (package import order)
    res = dict(tag=tag)
    if variant:
        import repro_torch.kernels.build as kb
        lib_name = VARIANTS[variant][0]
        lib = ctypes.CDLL(str(VARIANT_DIR / f"lib{variant}.so"))
        for fn_name, argtypes in kb._SIGNATURES[lib_name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        kb._LOADED[lib_name] = lib
        timer = {"sddmm": time_sddmm, "sell_spmm": time_sell,
                 "fusedmm": time_fusedmm,
                 "segment_sum": time_segsum,
                 "flash_attention": time_flash,
                 "flash_attention_bwd": time_flashbwd}.get(lib_name)
        if timer is time_flashbwd:
            return timer(res)
        if timer is time_flash:
            return time_flash_d80(res)
        return timer(res, sweep_only=True) if timer else time_bsr(res)
    for name in kernels:
        TIMERS[name](res)
    return res


def time_bsr(res: dict) -> dict:
    import torch
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    for skew in (True, False):
        a = synth_bsr(518, 518, 230_000, 128, 128, seed=1, skew=skew)
        h = torch.randn((a.ncols - 50, 256), device="cuda")
        res["bsr_ms" if skew else "bsr_even_ms"] = cuda_ms(
            lambda: bsr_spmm_cuda(a, h), reps=5)
        del a
    return res


def time_flash(res: dict) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((4, 32, 2048, 128), generator=g, device="cuda").bfloat16()
    k = torch.randn((4, 8, 2048, 128), generator=g, device="cuda").bfloat16()
    v = torch.randn((4, 8, 2048, 128), generator=g, device="cuda").bfloat16()
    res["flash_ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v), reps=20)
    res["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=20)
    # gemma-7b's heads of 256 (a checkout without that instance: None)
    q, k, v = (torch.randn((1, 16, 2048, 256), generator=g,
                           device="cuda").bfloat16() for _ in range(3))
    try:
        res["flash_d256_ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v),
                                       reps=20)
    except ValueError:
        res["flash_d256_ms"] = None
    res["sdpa_d256_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=20)
    del q, k, v
    return time_flash_d80(res, keep=True)


# hubert-xlarge's attention: B 4, 16 / 16 heads of 80, S = T = 4,096,
# non-causal (chip_smoke.py phase 15)
HUBERT_ATTN = (4, 16, 16, 4096, 4096, 80, False, None)


def _keep(res: dict, what: str, tensors: dict) -> None:
    """Save a first timing run's outputs (``this`` / ``other``) for the
    comparison of the two checkouts."""
    import torch
    if res["tag"] in ("this", "other"):
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        path = CACHE_DIR / f"out_{what}_{res['tag']}.pt"
        if not path.exists():
            torch.save({n: x.cpu() for n, x in tensors.items()}, path)


def time_flash_d80(res: dict, keep: bool = False) -> dict:
    """The forward at hubert's shape: ms, the kernel's device ms, SDPA,
    and its largest difference from the plain version over the plain
    version's largest value."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    q, k, v, _, _, _ = _bwd_inputs(*HUBERT_ATTN, 2)
    kw = dict(causal=False)
    res["flash_d80_ms"] = cuda_ms(lambda: flash_attention_cuda(
        q, k, v, return_lse=True, **kw), reps=20)
    res["flash_d80_device_ms"] = device_ms(lambda: flash_attention_cuda(
        q, k, v, return_lse=True, **kw), "flash_attention_wgmma")
    res["sdpa_d80_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=False), reps=20)
    want = flash_attention_plain(q, k, v, **kw).float()
    res["flash_d80_err_over_max"] = float(
        (flash_attention_cuda(q, k, v, **kw).float() - want).abs().max()
        / want.abs().max())
    del want
    if keep:
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        _keep(res, "flash_d80", {"o": o, "lse": lse})
    return res


def time_flashbwd(res: dict) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    args = _bwd_inputs(4, 32, 8, 2048, 2048, 128, True, None, 0)
    res["flash_bwd_ms"] = cuda_ms(lambda: flash_attention_bwd_cuda(*args),
                                  reps=20)
    for part in ("dkdv", "dq"):       # the kernels' names: flash_bwd_<part>
        res[f"flash_bwd_{part}_device_ms"] = device_ms(
            lambda: flash_attention_bwd_cuda(*args), f"flash_bwd_{part}")
    q, k, v, _, do, _ = args
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         enable_gqa=True)
    res["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), reps=20)
    # gemma-7b's heads of 256 (each checkout's own D 256 instance)
    del args, q, k, v, do, qg, kg, vg, out
    args = _bwd_inputs(1, 16, 16, 2048, 2048, 256, True, None, 1)
    res["flash_bwd_d256_ms"] = cuda_ms(
        lambda: flash_attention_bwd_cuda(*args), reps=20)
    for part in ("dkdv", "dq"):
        res[f"flash_bwd_d256_{part}_device_ms"] = device_ms(
            lambda: flash_attention_bwd_cuda(*args), f"flash_bwd_{part}")
    q, k, v, _, do, _ = args
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    res["sdpa_bwd_d256_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), reps=20)
    # hubert-xlarge's heads of 80, non-causal
    del args, q, k, v, do, qg, kg, vg, out
    args = _bwd_inputs(*HUBERT_ATTN, 2)
    kw = dict(causal=False)
    res["flash_bwd_d80_ms"] = cuda_ms(
        lambda: flash_attention_bwd_cuda(*args, **kw), reps=20)
    for part in ("dkdv", "dq"):
        res[f"flash_bwd_d80_{part}_device_ms"] = device_ms(
            lambda: flash_attention_bwd_cuda(*args, **kw), f"flash_bwd_{part}")
    _keep(res, "flashbwd_d80", dict(zip(
        ("dq", "dk", "dv"), flash_attention_bwd_cuda(*args, **kw))))
    q, k, v, _, do, _ = args
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=False)
    res["sdpa_bwd_d80_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), reps=20)
    return res


def time_dx(res: dict) -> dict:
    import torch
    e = 16
    dy, w, te = _dx_inputs(20480, 4096, 6400, e, 0)
    res["dx_ms"] = cuda_ms(lambda: _dx(dy, w, te), reps=20)
    yb, wt = dy.view(e, -1, dy.shape[1]), w.transpose(1, 2)
    res["bmm_dx_ms"] = cuda_ms(lambda: torch.bmm(yb, wt), reps=20)
    return res


def time_ragged(res: dict) -> dict:
    import torch
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    g = torch.Generator(device="cuda").manual_seed(0)
    e = 16
    for key, (t, d, f) in (("prefill_gate", (20480, 4096, 6400)),
                           ("prefill_down", (20480, 6400, 4096)),
                           ("decode_gate", (2048, 4096, 6400))):
        x = torch.randn((t, d), generator=g, device="cuda").bfloat16()
        w = torch.randn((e, d, f), generator=g, device="cuda").bfloat16()
        te = (torch.arange(t // 128, device="cuda") * e // (t // 128)).to(
            torch.int32)
        xb = x.view(e, t // e, d)
        res[f"ragged_{key}_ms"] = cuda_ms(lambda: ragged_gemm_cuda(x, w, te),
                                          reps=20)
        res[f"bmm_{key}_ms"] = cuda_ms(lambda: torch.bmm(xb, w), reps=20)
        del x, w, xb
    return res


def time_sddmm(res: dict, sweep_only: bool = False) -> dict:
    import torch
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((259 * 128, 256), generator=g, device="cuda") / 16
    y = torch.randn((259 * 128, 256), generator=g, device="cuda")
    for fill in SDDMM_FILLS:
        a = synth_grid(259, 259, 239, 128, 128, fill, seed=1)
        res[f"sddmm_scaled_fill{fill}_ms"] = cuda_ms(
            lambda: sddmm_bsr_cuda(a, x, y), reps=5)
        if not sweep_only and fill in (0.007, 0.5):
            if fill == 0.007:
                res["sddmm_unscaled_fill0.007_ms"] = cuda_ms(
                    lambda: sddmm_bsr_cuda(a, x, y, scale_by_a=False),
                    reps=3)
                res["sddmm_scaled_fill0.007_device_ms"] = device_ms(
                    lambda: sddmm_bsr_cuda(a, x, y), "sddmm_nnz_kernel")
            try:
                csr, yt = grid_csr(a), y.t().contiguous()
                res[f"sampled_addmm_fill{fill}_ms"] = cuda_ms(
                    lambda: torch.sparse.sampled_addmm(csr, x, yt, beta=0.0),
                    reps=3)
                del csr, yt
            except RuntimeError as err:       # a yardstick only
                res[f"sampled_addmm_fill{fill}_error"] = str(err)[:200]
        del a
        torch.cuda.empty_cache()
    return res


def synth_sampling_graph():
    """A reddit-sized sentinel-extended CSR for the sampling hop (232,965
    nodes, Pareto(1.5) degrees of median ~19 and mean ~45 capped at
    30,000, ~10 M edges, random neighbours), the same in every checkout."""
    import numpy as np
    import torch
    from repro_torch.core import sparse as sp
    rng = np.random.default_rng(0)
    n = 232_965
    deg = np.minimum((rng.pareto(1.5, n) + 1.0) * 15.0, 30_000).astype(
        np.int64)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    nse = int(indptr[-1])
    indices = rng.integers(0, n, nse).astype(np.int32)
    val = rng.random(nse).astype(np.float32)
    row_ids = np.repeat(np.arange(n, dtype=np.int32), deg)
    return sp.CSR(indptr=torch.from_numpy(indptr.astype(np.int32)),
                  indices=torch.from_numpy(indices),
                  val=torch.from_numpy(val),
                  row_ids=torch.from_numpy(row_ids), nrows=n, ncols=n,
                  nse=nse)


def sampling_hop_inputs(g, f, width, seed):
    """A frontier of ``f`` distinct ids (the last 64 the num_nodes
    sentinel, as a padded batch has) over the device graph ``g``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ids = rng.choice(g.num_nodes, f, replace=False).astype(np.int32)
    ids[-64:] = g.num_nodes
    return torch.from_numpy(np.sort(ids)).cuda()


def unfused_hop(g, frontier, rnd, width, hop):
    """The hop as separate calls: indptr gathers, ``segment_sample``, the
    mask, ``expand_indptr`` and two ``flat_gather`` launches (the device
    sampler's hop before the fused kernel)."""
    from repro_torch.kernels import sample as ks
    start = g.indptr[frontier.clamp(0, g.num_nodes).long()]
    deg = g.indptr[(frontier + 1).clamp(0, g.num_nodes).long()] - start
    ranks = ks.segment_sample(deg, frontier, rnd, width=width, fanout=width,
                              seed=0, hop=hop)
    valid = ks.sample_valid_mask(deg, width=width, fanout=width)
    pos = ks.expand_indptr(start, ranks, valid, sentinel=g.nse)
    return ks.flat_gather(g.indices, pos), ks.flat_gather(g.val, pos), valid


def check_sample():
    """The fused hop against its plain version and the unfused hop,
    bitwise, at both of phase 8's hop shapes on the synthetic graph."""
    import torch
    from repro_torch.kernels import sample as ks
    from repro_torch.sampling import device_graph_from_csr
    g = device_graph_from_csr(synth_sampling_graph(), device="cuda")
    for f, width, hop in ((20_992, 10, 1), (1024, 25, 0)):
        frontier = sampling_hop_inputs(g, f, width, hop)
        args = (g.indptr, g.indices, g.val, frontier, 7)
        kw = dict(width=width, fanout=width, seed=0, hop=hop, replace=False)
        got = ks.sample_hop(*args, **kw)
        want = ks.sample_hop_plain(*args, **kw)
        old = unfused_hop(g, frontier, 7, width, hop)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, old):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"sample_hop at {f} x {width} differs "
                                     "from its plain version or the "
                                     "unfused hop")
    log(f"sample_hop: bitwise equal to its plain version and to the "
        f"unfused hop at 20,992 x 10 and 1,024 x 25 ({g.nse} edges)")


def host_us(fn, reps=200):
    """Host µs a call takes to enqueue its work (no sync in the loop)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def time_sample(res: dict) -> dict:
    """Both hop shapes: the fused hop (where this checkout has it) and
    the unfused one; the standalone wrappers and ``torch.take`` (ms a
    call and host µs a call); ``sample_blocks`` a batch of 1,024 seeds."""
    import numpy as np
    import torch
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.kernels import sample as ks
    from repro_torch.sampling import DeviceSampler, device_graph_from_csr
    g = device_graph_from_csr(synth_sampling_graph(), device="cuda")
    for f, width, hop in ((20_992, 10, 1), (1024, 25, 0)):
        tag = f"hop{hop}_{f}x{width}"
        frontier = sampling_hop_inputs(g, f, width, hop)
        if hasattr(ks, "sample_hop"):
            fused = (lambda: ks.sample_hop(g.indptr, g.indices, g.val,
                                           frontier, 7, width=width,
                                           fanout=width, seed=0, hop=hop))
            res[f"sample_hop_{tag}_ms"] = cuda_ms(fused, reps=50)
            res[f"sample_hop_{tag}_host_us"] = host_us(fused)
        res[f"unfused_hop_{tag}_ms"] = cuda_ms(
            lambda: unfused_hop(g, frontier, 7, width, hop), reps=50)
        start = g.indptr[frontier.clamp(0, g.num_nodes).long()]
        deg = (g.indptr[(frontier + 1).clamp(0, g.num_nodes).long()]
               - start).contiguous()
        ranks = ks.segment_sample_plain(deg, frontier, 7, width=width,
                                        seed=0, hop=hop, replace=False)
        valid = ks.sample_valid_mask(deg, width=width,
                                     fanout=width).contiguous()
        pos = ks.expand_indptr_plain(start, ranks, valid, sentinel=g.nse)
        calls = {
            "segment_sample": lambda: ks.segment_sample_cuda(
                deg, frontier, 7, width=width, seed=0, hop=hop,
                replace=False),
            "expand_indptr": lambda: ks.expand_indptr_cuda(
                start, ranks, valid, sentinel=g.nse),
            "flat_gather": lambda: ks.flat_gather_cuda(g.indices, pos),
            "torch_take": lambda: torch.take(g.indices, pos.long())}
        for name, fn in calls.items():
            res[f"{name}_{tag}_ms"] = cuda_ms(fn, reps=50)
            res[f"{name}_{tag}_host_us"] = host_us(fn)
    samp = DeviceSampler(g, (10, 25), batch_size=1024, seed=0,
                         src_caps=(20_992, 180_000))
    samp.set_plans([KernelPlan(kind="ell")] * 2)
    rng = np.random.default_rng(5)
    seeds = [torch.from_numpy(rng.choice(g.num_nodes, 1024, replace=False)
                              .astype(np.int32)).cuda() for _ in range(8)]
    with torch.no_grad():
        samp.sample_blocks(seeds[0], 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, sd in enumerate(seeds):
            samp.sample_blocks(sd, i)
        torch.cuda.synchronize()
    res["sample_blocks_ms"] = (time.perf_counter() - t0) / len(seeds) * 1e3
    res["minibatch_step_ms"] = minibatch_step_ms(samp, seeds)
    return res


def minibatch_step_ms(samp, seeds, reps=20):
    """One device-sampled GraphSAGE-mean training step (hidden 256, 602
    random features, 41 classes, AdamW) over ``samp``'s graph, patched:
    host ms a step over ``reps`` steps after 3 warm-up steps."""
    import torch
    from repro_torch.core.patch import patched
    from repro_torch.optim import adamw
    from repro_torch.train import gnn_minibatch as mb
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((samp.graph.num_nodes, 602), generator=g, device="cuda")
    y = torch.randint(0, 41, (samp.graph.num_nodes,), generator=g,
                      device="cuda")
    init, _, apply_blocks, _ = mb.make_block_model("sage-mean", 602, 256,
                                                   41, 2)
    p = init(torch.Generator().manual_seed(0), device="cuda")
    opt = adamw(1e-2, weight_decay=5e-4)
    s = opt.init(p)
    step = mb.make_device_minibatch_step(apply_blocks, opt, samp,
                                         batch_size=1024)
    stats = mb.init_step_stats("cuda")
    with patched(True):
        for i in range(3 + reps):
            if i == 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            p, s, _, _, stats = step(p, s, seeds[i % len(seeds)], 1024, i, x,
                                     y, stats)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def gat_inputs():
    """ogbn-proteins at scale 1/4 (phase 9's graph, 7.0 M edges) with the
    gat bundle pinned to BSR 128 x 128, hidden 256, weights from a seed."""
    import torch
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.data import make_dataset
    from repro_torch.models.gnn import build_bundle, make_gnn
    ds = make_dataset("ogbn-proteins", scale=1 / 4)
    bundle = build_bundle(ds, k_hint=256, arch="gat", plan=KernelPlan(
        kind="bsr", br=128, bc=128, fk=64, k_hint=256)).to("cuda")
    init, apply = make_gnn("gat", ds.num_features, 256, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device="cuda")
    xym = tuple(t.to("cuda") for t in (ds.x, ds.y, ds.train_mask))
    return bundle, apply, params, xym


def check_segsum():
    """The ordered segment sum against its plain version (2 d eps
    sum|terms|) with a hub target and empty targets, twice bitwise, at K
    = 256, 602 and 7 (vectors of 4, 2 and 1 floats)."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_sum import (segment_sum_sorted_cuda,
                                                 segment_sum_sorted_plain)
    rng = np.random.default_rng(0)
    t = np.sort(np.concatenate([rng.integers(0, 500, 6000),
                                np.full(20_000, 17)]))
    offsets = torch.from_numpy(np.searchsorted(t, np.arange(501))
                               .astype(np.int64))
    index = torch.from_numpy(rng.integers(0, 300, t.shape[0])
                             .astype(np.int32))
    weight = torch.from_numpy(rng.standard_normal(t.shape[0])
                              .astype(np.float32))
    d = torch.diff(offsets).float()[:, None]
    for k in (256, 602, 7):
        src = torch.from_numpy(rng.standard_normal((300, k))
                               .astype(np.float32))
        args = [a.cuda() for a in (src, offsets, index, weight)]
        got = segment_sum_sorted_cuda(args[0], args[1], index=args[2],
                                      weight=args[3])
        again = segment_sum_sorted_cuda(args[0], args[1], index=args[2],
                                        weight=args[3])
        want = segment_sum_sorted_plain(src, offsets, index=index,
                                        weight=weight)
        mag = segment_sum_sorted_plain(src.abs(), offsets, index=index,
                                       weight=weight.abs())
        if not torch.equal(got, again) or not bool(
                ((got.cpu() - want).abs() <= 2 * 2.0 ** -24 * d * mag
                 + 1e-30).all()):
            raise AssertionError(f"segment_sum k{k} differs from its plain "
                                 "version or between two launches")
    log("segment_sum: within 2 d eps sum|terms| of its plain version and "
        "bitwise repeatable (a 20,000-slot hub target, empty targets; K = "
        "256, 602, 7)")


def gat_graph():
    """Phase 9's graph (ogbn-proteins at scale 1/4, 7.0 M edges) as a
    trusted ``CachedGraph`` on the card (its cached edge orders are what
    the gat backward's sums walk), and random x, y, h of 256 columns."""
    import torch
    from repro_torch.data import make_dataset
    from repro_torch.core.cache import build_cached_graph
    ds = make_dataset("ogbn-proteins", scale=1 / 4)
    g = build_cached_graph(ds.coo, tune=False).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y, h = (torch.randn((ds.num_nodes, 256), generator=gen,
                           device="cuda") for _ in range(3))
    return g, x, y, h


def _synth_block(n_dst, width, n_src, seed):
    """A synthetic sampled block: ``width`` slots a destination row, the
    sources uniform over ``n_src`` rows, values 1 / width; (row, col,
    val) on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    row = torch.arange(n_dst, device="cuda", dtype=torch.int32) \
        .repeat_interleave(width)
    col = torch.randint(0, n_src, (n_dst * width,), generator=gen,
                        device="cuda", dtype=torch.int32)
    return row, col, torch.full((n_dst * width,), 1.0 / width,
                                device="cuda")


def _order(targets, n, sources):
    """``segment_order`` with the sorted sources where the checkout's
    orders carry them (as a ``CachedGraph`` caches them), else without."""
    import inspect
    from repro_torch.kernels.segment_sum import segment_order
    if "sources" in inspect.signature(segment_order).parameters:
        return segment_order(targets, n, sources=sources)
    return segment_order(targets, n)


def _scale_sum(kseg, src, order, index, weight):
    """``gather_scale_sum`` as the checkout defines it: the parent's takes
    the entries' gather index, this checkout's reads it from the order."""
    import inspect
    if "index" in inspect.signature(kseg.gather_scale_sum).parameters:
        return kseg.gather_scale_sum(src, order, index, weight)
    return kseg.gather_scale_sum(src, order, weight)


def _segsum_kernel(res: dict, name: str, src, offsets, idx, ws) -> None:
    """The bare kernel on operands sorted beforehand (no sort, no index
    or weight gather in the timed window): 20 calls under CUDA events,
    and its device time from a profiler trace of 20 calls (at the block
    sizes a call's host dispatch outlasts the kernel)."""
    from repro_torch.kernels import segment_sum as kseg

    def run():
        return kseg.segment_sum_sorted_cuda(src, offsets, index=idx,
                                            weight=ws)
    res[f"{name}_kernel_ms"] = cuda_ms(run, reps=20)
    res[f"{name}_kernel_device_ms"] = device_ms(run, "segment_sum_kernel",
                                                reps=20)


def time_segsum(res: dict, sweep_only: bool = False) -> dict:
    """The ordered segment sum at the main path's sizes, as each checkout
    runs it: gat's dh (phase 9's graph, A's edges in the cached column
    order) at K = 256 and 112 through ``gather_scale_sum`` (the call the
    backward makes) and as the bare kernel on pre-sorted operands,
    reddit's trusted candidate at K = 256 (the synthetic
    reddit-shaped matrix, 10.3 M slots, ``coo_reduce`` over its row
    order), the minibatch block's trusted forward at K = 602 (a
    synthetic 20,992 x 10 block over 150,000 source rows) and its ELL
    backward at K = 256 (a 1,024 x 25 block over 20,992 rows, the column
    sort included), and the trusted forward of that 1,024 x 25 block at K
    = 256 (the measured tuner's candidate), each beside
    ``torch.sparse.mm`` on the same CSR; and, unless ``sweep_only`` (a
    source variant's run), a patched gat training step (loss and
    gradients)."""
    import warnings
    import torch
    from repro_torch.core import sparse as tsp
    from repro_torch.core.patch import patched
    from repro_torch.core.semiring import get_semiring
    from repro_torch.kernels import segment_sum as kseg
    from repro_torch.kernels.ref import coo_reduce, ell_transpose_reduce
    from repro_torch.train.gnn import loss_and_grads
    add = get_semiring("sum")

    def csr_of(offsets, index, weight, n_cols):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # "sparse CSR is in beta"
            return torch.sparse_csr_tensor(offsets, index.long(), weight,
                                           size=(offsets.shape[0] - 1,
                                                 n_cols))

    g, x, y, h = gat_graph()
    n = g.coo.nse
    row = g.coo.row[:n]
    order = g.col_order
    w = torch.rand(n, device="cuda")
    idx = row.index_select(0, order.perm.long()).to(torch.int32)
    ws = w.index_select(0, order.perm.long())
    for k in (256, 112):
        src = h[:, :k].contiguous()
        res[f"gat_dh_k{k}_ms"] = cuda_ms(
            lambda: _scale_sum(kseg, src, order, row, w))
        _segsum_kernel(res, f"gat_dh_k{k}", src, order.offsets, idx, ws)
        csr = csr_of(order.offsets, idx, ws, src.shape[0])
        res[f"gat_dh_k{k}_sparse_mm_ms"] = cuda_ms(
            lambda: torch.sparse.mm(csr, src))
        del csr, src
    del g, x, y, h, idx, ws, w
    torch.cuda.empty_cache()

    _, rcsr = synth_reddit()
    crow = rcsr.crow_indices()
    rn = crow.shape[0] - 1
    rrow = torch.arange(rn, device="cuda", dtype=torch.int32) \
        .repeat_interleave(torch.diff(crow))
    rcol = rcsr.col_indices().to(torch.int32)
    rval = rcsr.values().float()
    rorder = _order(rrow, rn, rcol)
    hr = torch.randn((rn, 256), device="cuda")
    res["reddit_trusted_k256_ms"] = cuda_ms(
        lambda: coo_reduce(rrow, rcol, rval, rrow.shape[0], rn, hr, add,
                           order=rorder))
    res["reddit_trusted_k256_sparse_mm_ms"] = cuda_ms(
        lambda: torch.sparse.mm(rcsr, hr))
    _segsum_kernel(res, "reddit_trusted_k256", hr, rorder.offsets,
                   rcol.index_select(0, rorder.perm.long()),
                   rval.index_select(0, rorder.perm.long()))
    res["reddit_trusted_slots"] = int(rrow.shape[0])
    del rcsr, rrow, rcol, rval, rorder, hr
    torch.cuda.empty_cache()

    brow, bcol, bval = _synth_block(20_992, 10, 150_000, 1)
    border = _order(brow, 20_992, bcol)
    hb = torch.randn((150_000, 602), device="cuda")
    res["block_fwd_k602_ms"] = cuda_ms(
        lambda: coo_reduce(brow, bcol, bval, brow.shape[0], 20_992, hb, add,
                           order=border))
    bcsr = csr_of(border.offsets, bcol.index_select(
        0, border.perm.long()), bval, 150_000)
    res["block_fwd_k602_sparse_mm_ms"] = cuda_ms(
        lambda: torch.sparse.mm(bcsr, hb))
    _segsum_kernel(res, "block_fwd_k602", hb, border.offsets,
                   bcol.index_select(0, border.perm.long()),
                   bval.index_select(0, border.perm.long()))
    del brow, bcol, bval, border, hb, bcsr
    lrow, lcol, lval = _synth_block(1_024, 25, 20_992, 2)
    ell = tsp.ELL(idx=lcol.view(1_024, 25), val=lval.view(1_024, 25),
                  nrows=1_024, ncols=20_992, nse=lrow.shape[0])
    dout = torch.randn((1_024, 256), device="cuda")
    res["block_bwd_k256_ms"] = cuda_ms(lambda: ell_transpose_reduce(ell,
                                                                    dout))
    eorder = _order(lcol, 20_992, None)        # ell_transpose_ordered's
    _segsum_kernel(res, "block_bwd_k256", dout, eorder.offsets,
                   torch.div(eorder.perm, 25, rounding_mode="floor")
                   .to(torch.int32),
                   lval.index_select(0, eorder.perm.long()))
    lorder = _order(lcol, 20_992, lrow)
    lcsr = csr_of(lorder.offsets, lrow.index_select(
        0, lorder.perm.long()), lval, 1_024)
    res["block_bwd_k256_sparse_mm_ms"] = cuda_ms(
        lambda: torch.sparse.mm(lcsr, dout))
    forder = _order(lrow, 1_024, lcol)
    hs = torch.randn((20_992, 256), device="cuda")
    res["block_fwd_k256_ms"] = cuda_ms(
        lambda: coo_reduce(lrow, lcol, lval, lrow.shape[0], 1_024, hs, add,
                           order=forder))
    _segsum_kernel(res, "block_fwd_k256", hs, forder.offsets,
                   lcol.index_select(0, forder.perm.long()),
                   lval.index_select(0, forder.perm.long()))
    del ell, dout, lcsr, forder, hs
    torch.cuda.empty_cache()
    if sweep_only:
        return res

    bundle, apply, params, (xg, yg, m) = gat_inputs()
    with patched(True):
        res["gat_step_ms"] = cuda_ms(
            lambda: loss_and_grads(apply, params, bundle, xg, yg, m), reps=5)
    del bundle
    torch.cuda.empty_cache()
    return res


def check_edgedots():
    """The per-edge SDDMM against its plain version (2 (D + 1) eps
    sum_d |x_d y_d| an edge) with a hub row, at D = 256, 112 and 7 (off
    16-byte alignment), one product and two, twice bitwise."""
    import numpy as np
    import torch
    from repro_torch.kernels.edge_dots import edge_dots_cuda, edge_dots_plain
    from repro_torch.kernels.ref import edge_dots as plain1
    rng = np.random.default_rng(0)
    row = np.sort(np.concatenate([rng.integers(0, 3000, 60_000),
                                  np.full(18_045, 5)]))
    row = torch.from_numpy(row.astype(np.int32)).cuda()
    col = torch.from_numpy(rng.integers(0, 2800, row.shape[0])
                           .astype(np.int32)).cuda()
    for d, off in ((256, 0), (112, 0), (7, 1)):
        mats = [torch.randn(n * d + off, device="cuda")[off:].view(n, d)
                for n in (3000, 2800, 3000, 2800)]
        got = edge_dots_cuda(*mats[:2], row, col, *mats[2:])
        again = edge_dots_cuda(*mats[:2], row, col, *mats[2:])
        want = edge_dots_plain(*mats[:2], row, col, *mats[2:])
        for j in range(2):
            mag = plain1(mats[2 * j].abs(), mats[2 * j + 1].abs(), row, col)
            if not torch.equal(got[j], again[j]) or not bool(
                    ((got[j] - want[j]).abs() <= 2 * (d + 1) * 2.0 ** -24
                     * mag + 1e-30).all()):
                raise AssertionError(f"edge_dots d{d}: differs from its plain "
                                     "version or between two launches")
    log("edge_dots: within 2 (D + 1) eps sum|x y| of its plain version and "
        "bitwise repeatable (D = 256, 112, 7 misaligned; an 18,045-edge "
        "hub row; single and dual)")


def time_edgedots(res: dict) -> dict:
    """The gat backward's per-edge dot products on phase 9's graph at D =
    K = 256 as each checkout runs them on the card: the dual kernel
    launch (s and dw) where the checkout has ``kernels/edge_dots``, else
    the two plain ``ref.edge_dots`` calls; the single launch (the
    forward's scores), and ``torch.sparse.sampled_addmm`` on the same
    CSR beside it."""
    import warnings
    import torch
    from repro_torch.kernels.ref import edge_dots as plain1
    g, x, y, h = gat_graph()
    n = g.coo.nse
    row, col = g.coo.row[:n], g.coo.col[:n]
    try:
        from repro_torch.kernels.edge_dots import edge_dots_cuda
    except ImportError:
        edge_dots_cuda = None
    if edge_dots_cuda is not None:
        res["edge_dots_dual_ms"] = cuda_ms(
            lambda: edge_dots_cuda(x, y, row, col, x, h))
        res["edge_dots_single_ms"] = cuda_ms(
            lambda: edge_dots_cuda(x, y, row, col))
        res["edge_dots_dual_device_ms"] = device_ms(
            lambda: edge_dots_cuda(x, y, row, col, x, h), "edge_dots_kernel")
        res["edge_dots_single_device_ms"] = device_ms(
            lambda: edge_dots_cuda(x, y, row, col), "edge_dots_kernel")
    res["edge_dots_plain_pair_ms"] = cuda_ms(
        lambda: (plain1(x, y, row, col), plain1(x, h, row, col)), reps=3)
    res["edge_dots_plain_ms"] = cuda_ms(lambda: plain1(x, y, row, col),
                                        reps=3)
    crow = g.row_order.offsets
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        csr = torch.sparse_csr_tensor(crow, col.long(),
                                      torch.ones(n, device="cuda"),
                                      size=(x.shape[0], y.shape[0]))
    yt = y.t().contiguous()
    res["edge_dots_sampled_addmm_ms"] = cuda_ms(
        lambda: torch.sparse.sampled_addmm(csr, x, yt, beta=0.0))
    res["edge_dots_edges"] = n
    del g, x, y, h, csr, yt
    torch.cuda.empty_cache()
    return res


def check_sell_all():
    check_sell()
    check_sell_reddit()


CHECKS = {"bsr": check_bsr, "flash": check_flash, "ragged": check_ragged,
          "sddmm": check_sddmm, "sell": check_sell_all,
          "fusedmm": check_fusedmm, "sample": check_sample,
          "segsum": check_segsum, "edgedots": check_edgedots,
          "flashbwd": check_flashbwd, "dx": check_dx}
TIMERS = {"bsr": time_bsr, "flash": time_flash, "ragged": time_ragged,
          "sddmm": time_sddmm, "sell": time_sell, "fusedmm": time_fusedmm,
          "sample": time_sample, "segsum": time_segsum,
          "edgedots": time_edgedots, "flashbwd": time_flashbwd,
          "dx": time_dx}
LIBS = {"bsr": "bsr_spmm", "flash": "flash_attention",
        "ragged": "ragged_gemm", "sddmm": "sddmm", "sell": "sell_spmm",
        "fusedmm": "fusedmm", "sample": "sample", "segsum": "segment_sum",
        "edgedots": "edge_dots", "flashbwd": "flash_attention_bwd",
        "dx": "ragged_gemm"}


def chosen_variants(kernels, which: str) -> list:
    """The variants of these kernels' libraries, all or those named."""
    libs = {LIBS[k] for k in kernels}
    names = [n for n, (lib, _) in VARIANTS.items() if lib in libs]
    if which != "all":
        want = which.split(",")
        unknown = set(want) - set(names)
        if unknown:
            raise SystemExit(f"--variants: unknown for {kernels}: {unknown}")
        names = [n for n in names if n in want]
    return names


def build_variants(kernels, which: str = "all"):
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in chosen_variants(kernels, which):
        kernel, edits = VARIANTS[name]
        text = (CSRC / f"{kernel}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: source text not found")
            text = text.replace(old, new)
        path = VARIANT_DIR / f"{kernel}_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(VARIANT_DIR / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate()[0]
        (VARIANT_DIR / f"{name}.log").write_text(out)   # ptxas's report
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")


def compare_outputs() -> None:
    """The largest difference between the two checkouts' kept outputs
    (the same seeded inputs), and whether they are the same bits."""
    import torch
    for path in sorted(CACHE_DIR.glob("out_*_this.pt")):
        other = path.with_name(path.name.replace("_this.pt", "_other.pt"))
        if not other.exists():
            continue
        a, b = torch.load(path), torch.load(other)
        for name in a:
            x, y = a[name].float(), b[name].float()
            log(json.dumps({"outputs": path.name[4:-8], "tensor": name,
                            "max_abs_diff": float((x - y).abs().max()),
                            "max_abs": float(y.abs().max()),
                            "bitwise_equal": bool(torch.equal(a[name],
                                                              b[name]))}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--variants", nargs="?", const="all", default=None,
                    help="time the source variants (all, or a "
                    "comma-separated list of names)")
    ap.add_argument("--kernels", default=",".join(CHECKS),
                    help="comma-separated subset of " + ", ".join(CHECKS))
    ap.add_argument("--time", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    if not set(kernels) <= set(CHECKS):
        ap.error(f"--kernels: choose from {', '.join(CHECKS)}")
    if args.time:                      # one timing run, in its own process
        print(json.dumps(time_run(args.time, args.variant, kernels)),
              flush=True)
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
    build_kernels([LIBS[k] for k in kernels])
    if args.variants:
        build_variants(kernels, args.variants)
    log(f"build {time.perf_counter() - t0:.1f} s")
    for name in kernels:
        CHECKS[name]()

    def run(tag, root=ROOT, variant=None):
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        if root != ROOT:
            env["REPRO_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
        cmd = [sys.executable, str(Path(__file__).resolve()), "--time", tag,
               "--kernels", ",".join(kernels)]
        if variant:
            cmd += ["--variant", variant]
        r = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"timing run {tag} failed:\n{r.stderr}")
        log(r.stdout.strip())

    for path in CACHE_DIR.glob("out_*.pt"):
        path.unlink()
    order = ["other", "this", "this", "other"] if args.other else ["this"]
    for tag in order:
        run(tag, args.other if tag == "other" else ROOT)
    if args.other:
        compare_outputs()
    if args.variants:
        names = chosen_variants(kernels, args.variants)
        for name in names + names[::-1]:
            run(f"variant {name}", variant=name)
    return 0


if __name__ == "__main__":
    if "--time" not in sys.argv:       # a timing run imports $PYTHONPATH's
        sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
