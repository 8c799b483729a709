"""The port's full-graph SpMM layer against the JAX reference: BSR packing
and the plain BSR SpMM (against the Pallas body in interpret mode), the
graph-static precomputations, ``core.spmm.spmm`` forward and gradient for
every plan kind and reduction (against ``jax.grad`` through
``repro.core.spmm.spmm``), the cached-transpose backward, the baselines,
and the repaired BSR tile check of the H100 tuner.

Plans are pinned on both sides: the port tunes for the H100 and the
reference for a TPU v5e, so their own picks differ. The reference gates
BSR to K % 128 == 0 and takes its trusted path below that; the port runs
BSR at any K. Both compute the same function.

Tolerance: fp32, atol 1e-5 / rtol 1e-5 for a graph of ~10 entries per
row and features ~N(0, 1): the two sides sum in other orders (tile
products, segment sums, ``index_add_``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.autotune import KernelPlan as JPlan
from repro.kernels import ops as jops

from repro_torch import obs
from repro_torch.core import baselines as tbase
from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import (H100, TPU_V5E, KernelPlan, autotune,
                                       estimate_plan_time, graph_stats)
from repro_torch.core.cache import build_cached_graph
from repro_torch.core.spmm import matmul, spmm
from repro_torch.kernels import bsr_spmm as kbsr
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import spmm_bsr_ref

from conftest import random_coo

TOL = dict(atol=1e-5, rtol=1e-5)
PLANS = {"bsr": dict(kind="bsr", br=32, bc=128, fk=128),
         "sell": dict(kind="sell", sell_c=8, sell_sigma=0),
         "ell": dict(kind="ell"),
         "trusted": dict(kind="trusted")}


def _port_coo(coo):
    return tsp.coo_from_edges(np.asarray(coo.col)[: coo.nse],
                              np.asarray(coo.row)[: coo.nse],
                              np.asarray(coo.val)[: coo.nse],
                              coo.nrows, coo.ncols)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# --------------------------------------------------------------------------
# BSR packing and the plain BSR SpMM
# --------------------------------------------------------------------------

@pytest.mark.parametrize("br,bc", [(32, 128), (64, 128), (128, 128)])
@pytest.mark.parametrize("k", [16, 112, 256])
def test_bsr_plain_matches_pallas_interpret(rng, br, bc, k):
    """Index tables and tiles bitwise, products within fp32 tolerance;
    two padding blocks replicate the last block row; rows 40..99 are empty
    so some block rows own only their explicit zero block."""
    n, m = 170, 150
    ref, _ = random_coo(rng, n, m, 700)
    keep = (np.asarray(ref.row) < 40) | (np.asarray(ref.row) >= 100)
    keep &= np.arange(ref.nnz_padded) < ref.nse
    ref = C.coo_from_edges(np.asarray(ref.col)[keep],
                           np.asarray(ref.row)[keep],
                           np.asarray(ref.val)[keep], n, m)
    nb = C.bsr_from_coo(ref, br=br, bc=bc).nblocks + 2
    want_bsr = C.bsr_from_coo(ref, br=br, bc=bc, pad_blocks_to=nb)
    got_bsr = tsp.bsr_from_coo(_port_coo(ref), br=br, bc=bc, pad_blocks_to=nb)
    for f in ("blk_row", "blk_col", "blocks"):
        assert np.array_equal(_np(getattr(got_bsr, f)),
                              np.asarray(getattr(want_bsr, f))), f
    assert (got_bsr.nrows, got_bsr.ncols, got_bsr.n_real_blocks) == \
        (want_bsr.nrows, want_bsr.ncols, want_bsr.n_real_blocks)
    h = rng.standard_normal((m, k)).astype(np.float32)
    want = jops.bsr_spmm(want_bsr, jnp.asarray(h), fk=128, interpret=True)
    got = tops.bsr_spmm(got_bsr, torch.from_numpy(h))
    assert got.shape == (got_bsr.nrows, k)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_bsr_plain_reduces_in_chunks(rng, monkeypatch):
    """The chunked block loop gives the one-shot result."""
    ref, dense = random_coo(rng, 100, 90, 600)
    bsr = tsp.bsr_from_coo(_port_coo(ref), br=32, bc=128)
    h = torch.from_numpy(rng.standard_normal((90, 24)).astype(np.float32))
    whole = spmm_bsr_ref(bsr, h)
    monkeypatch.setattr("repro_torch.kernels.ref._CHUNK_ELEMS", 128 * 24)
    np.testing.assert_allclose(_np(spmm_bsr_ref(bsr, h)), _np(whole), **TOL)
    np.testing.assert_allclose(_np(whole)[:100], dense @ _np(h), **TOL)


def test_graph_precomputations_match_reference(rng):
    ref, _ = random_coo(rng, 70, 70, 400)
    got = _port_coo(ref)
    for f_ref, f_got in ((C.sparse.coo_transpose(ref),
                          tsp.coo_transpose(got)),
                         (C.sparse.gcn_normalize(ref),
                          tsp.gcn_normalize(got))):
        assert (f_got.nrows, f_got.ncols, f_got.nse, f_got.nnz_padded) == \
            (f_ref.nrows, f_ref.ncols, f_ref.nse, f_ref.nnz_padded)
        assert np.array_equal(_np(f_got.row), np.asarray(f_ref.row))
        assert np.array_equal(_np(f_got.col), np.asarray(f_ref.col))
        np.testing.assert_allclose(_np(f_got.val), np.asarray(f_ref.val),
                                   rtol=1e-7)
    np.testing.assert_array_equal(_np(tsp.row_degrees(got)),
                                  np.asarray(C.sparse.row_degrees(ref)))


# --------------------------------------------------------------------------
# spmm: forward and gradient, every plan kind and reduction
# --------------------------------------------------------------------------

def _graphs(rng, plan, k, n=60, m=48, nnz=500):
    ref, _ = random_coo(rng, n, m, nnz)
    g_ref = C.build_cached_graph(ref, k_hint=k, plan=JPlan(**PLANS[plan]))
    g = build_cached_graph(_port_coo(ref), k_hint=k,
                           plan=KernelPlan(**PLANS[plan]))
    return g_ref, g


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("k", [16, 128])
def test_spmm_forward_and_grad_match_reference(rng, plan, reduce, k):
    g_ref, g = _graphs(rng, plan, k)
    h = rng.standard_normal((48, k)).astype(np.float32)
    w = rng.standard_normal((60, k)).astype(np.float32)

    def loss(hh):
        return jnp.sum(C.spmm(g_ref, hh, reduce=reduce) * w)
    want_out = C.spmm(g_ref, jnp.asarray(h), reduce=reduce)
    want_dh = jax.grad(loss)(jnp.asarray(h))

    ht = torch.from_numpy(h).requires_grad_(True)
    out = spmm(g, ht, reduce)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(_np(ht.grad), np.asarray(want_dh), **TOL)


@pytest.mark.parametrize("combine", ["add", "second"])
def test_spmm_combine_variants_match_reference(rng, combine):
    g_ref, g = _graphs(rng, "sell", 16)
    h = rng.standard_normal((48, 16)).astype(np.float32)
    want = jax.grad(lambda hh: jnp.sum(
        C.spmm(g_ref, hh, "sum", combine) ** 2))(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    (spmm(g, ht, "sum", combine) ** 2).sum().backward()
    np.testing.assert_allclose(_np(ht.grad), np.asarray(want), atol=1e-4,
                               rtol=1e-5)   # squared sums reach ~100


@pytest.mark.parametrize("plan,name", [("bsr", "bsr_spmm"),
                                       ("sell", "sell_spmm"),
                                       ("ell", "ell_spmm")])
def test_backward_runs_forward_kernel_on_cached_transpose(rng, monkeypatch,
                                                          plan, name):
    """The backward is the plan's forward kernel on the cached A^T; an
    input that needs no gradient gets no backward launch."""
    _, g = _graphs(rng, plan, 16)
    calls = []
    real = getattr(tops, name)

    def spy(a, h):
        calls.append(a)
        return real(a, h)
    monkeypatch.setattr(tops, name, spy)
    fwd, bwd = (g.bsr, g.bsr_t) if plan == "bsr" else \
        (g.sell, g.sell_t) if plan == "sell" else (g.ell, g.ell_t)
    x = torch.randn(48, 16)
    spmm(g, x, "mean").sum()                     # x needs no gradient
    h = torch.randn(48, 16, requires_grad=True)
    spmm(g, h, "mean").sum().backward()
    assert [c is fwd for c in calls] == [True, True, False]
    assert calls[2] is bwd


def test_matmul_paper_interface(rng):
    ref, dense = random_coo(rng, 30, 20, 120)
    h = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    got = _port_coo(ref)
    np.testing.assert_allclose(_np(matmul(got, h)), dense @ _np(h), **TOL)
    csr = tsp.csr_from_coo(got)
    np.testing.assert_allclose(_np(matmul(csr, h, "sum")), dense @ _np(h),
                               **TOL)


# --------------------------------------------------------------------------
# baselines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn,reduce", [("spmm_uncached", "sum"),
                                       ("spmm_uncached", "mean"),
                                       ("spmm_uncached", "max"),
                                       ("spmm_uncached_transpose", "sum"),
                                       ("spmm_uncached_transpose", "mean")])
def test_baselines_match_reference(rng, fn, reduce):
    ref, _ = random_coo(rng, 60, 48, 500)
    got = _port_coo(ref)
    h = rng.standard_normal((48, 16)).astype(np.float32)
    w = rng.standard_normal((60, 16)).astype(np.float32)
    jfn = getattr(C.baselines, fn)
    want_dh = jax.grad(lambda hh: jnp.sum(jfn(ref, hh, reduce) * w))(
        jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    out = getattr(tbase, fn)(got, ht, reduce)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(jfn(ref, jnp.asarray(h),
                                                        reduce)), **TOL)
    np.testing.assert_allclose(_np(ht.grad), np.asarray(want_dh), **TOL)


def test_gcn_norm_in_step_matches_reference_and_cache(rng):
    from repro.data import make_dataset as jax_make_dataset
    from repro_torch.data import make_dataset
    ref = jax_make_dataset("reddit", scale=1 / 512, seed=1).coo_sl
    got = make_dataset("reddit", scale=1 / 512, seed=1).coo_sl
    want = C.baselines.gcn_norm_in_step(ref)
    norm = tbase.gcn_norm_in_step(got)
    np.testing.assert_allclose(_np(norm.val), np.asarray(want.val),
                               rtol=1e-6, atol=1e-7)
    assert np.array_equal(_np(norm.row), np.asarray(want.row))


# --------------------------------------------------------------------------
# the tuner's BSR tile check on the H100
# --------------------------------------------------------------------------

def test_h100_tuner_evaluates_and_picks_bsr_on_dense_tiles():
    """A graph whose 32 x 128 tiles are all dense: the H100 model charges
    the hand kernel's ring of shared memory at its widest K tile,
    evaluates every BSR candidate, and picks one (before an earlier repair,
    a double-buffered 256-wide K slice was charged and every candidate
    skipped)."""
    n, m = 64, 256
    dst, src = np.divmod(np.arange(n * m), m)
    coo = tsp.coo_from_edges(src, dst, np.ones(n * m, np.float32), n, m)
    with obs.profiled(ops=False) as tracer:
        plan = autotune(coo, 128, hw=H100)
    sweep = [s for s in tracer.snapshot() if s.name == "tuning.sweep"][-1]
    names = [c[0] for c in sweep.attrs["candidates"]]
    assert {"bsr32x128", "bsr64x128", "bsr128x128", "bsr128x256"} <= \
        set(names)
    assert plan.kind == "bsr" and plan.fk == kbsr.K_TILE == 128
    # the ring: 4 stages of a (min(br, 128) x 32) tile box and a (128 x 32)
    # box of h^T, two lo boxes, 1 KB of alignment slack and a pair of
    # barriers a stage (csrc/bsr_spmm.cu's Cfg)
    for br in (32, 64, 128, 256):
        stage = 4 * 32 * (min(br, 128) + 128)
        assert kbsr.smem_bytes(br) == \
            4 * stage + 2 * 4 * 32 * 128 + 1024 + 16 * 4
        assert kbsr.smem_bytes(br) <= H100.vmem_bytes
    # the TPU model keeps the reference's rule: fk = K rounded to lanes
    tpu = autotune(coo, 128, hw=TPU_V5E)
    assert tpu.kind != "bsr" or tpu.fk == 128


def test_h100_tuner_costs_bsr_at_the_kernels_fp32_rate():
    """The hand BSR kernel delivers fp32-accurate tile products in split
    TF32, three TF32 tensor-core passes a product, and the H100 model
    charges them at that rate (495 / 3 TFLOP/s), not at the bf16 peak
    nor at the CUDA cores' 67 TFLOP/s of the earlier kernel. On 128 x 128
    tiles 1.6 % full (every tile stored) the split-TF32 tile products are
    cheaper than a gather kernel's reads (ELL here: every row has the
    same degree); at the CUDA-core rate they were not."""
    n, deg, k = 4096, 64, 256
    rng = np.random.default_rng(0)
    dst = np.repeat(np.arange(n), deg)
    src = (dst + rng.integers(1, n, dst.size)) % n
    coo = tsp.coo_from_edges(src, dst, np.ones(dst.size, np.float32), n, n)
    stats = graph_stats(coo)
    bsr = KernelPlan(kind="bsr", br=128, bc=128, fk=128, k_hint=k)
    nt = stats.n_tiles(128, 128)
    flops = 2.0 * nt * 128 * 128 * k
    nbytes = nt * (128 * 128 * 4 + 128 * k * 4) + n * k * 4
    assert H100.bsr_flops == 495e12 / 3
    assert estimate_plan_time(stats, k, bsr, H100) == \
        max(flops / (495e12 / 3), nbytes / 3.35e12)
    assert autotune(coo, k, hw=H100, stats=stats).kind == "bsr"
    cuda_cores = dataclasses.replace(H100, bsr_flops=67e12)
    assert autotune(coo, k, hw=cuda_cores, stats=stats).kind == "ell"