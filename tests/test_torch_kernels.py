"""The port's SpMM kernels: plain PyTorch versions against the JAX
reference (Pallas bodies in interpret mode, and the jnp oracles), the
semirings of ``block_spmm`` and the device dispatch. The hand-written
kernels are held against their plain versions on the card by
``tests/test_torch_cuda.py``, which imports no JAX.

Tolerance: fp32, atol 1e-5 / rtol 1e-5. The plain versions sum a row's
slots with ``sum(dim=1)`` / ``index_add_`` and the references with XLA's
reductions or the Pallas grid order, so results differ only by the
summation order of at most a few dozen fp32 terms of magnitude ~1."""
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.autotune import KernelPlan as JPlan
from repro.kernels import ops as jops
from repro.kernels.ref import spmm_ell_ref as jax_spmm_ell_ref
from repro.sampling import NeighborSampler as JSampler
from repro.sampling import block_spmm as jax_block_spmm
from repro.sampling import pack_block as jax_pack_block
from repro.sampling import plan_buckets as jax_plan_buckets

from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.semiring import get_semiring
from repro_torch.kernels import ops as tops
from repro_torch.kernels.build import KERNELS, _lib_path, build_dir
from repro_torch.kernels.ell_spmm import ell_spmm_plain, vec_width
from repro_torch.kernels.ref import spmm_coo_ref
from repro_torch.kernels.sell_spmm import sell_spmm_plain, slice_pointers
from repro_torch.data import make_dataset
from repro_torch.sampling import NeighborSampler, block_spmm, pack_block
from repro_torch.sampling import plan_buckets

from conftest import random_coo

TOL = dict(atol=1e-5, rtol=1e-5)


def _port_coo(coo):
    return tsp.coo_from_edges(np.asarray(coo.col)[: coo.nse],
                              np.asarray(coo.row)[: coo.nse],
                              np.asarray(coo.val)[: coo.nse],
                              coo.nrows, coo.ncols)


def _graph(rng, n, m, nnz):
    """Rectangular graph with zero-degree (sentinel-only) rows."""
    ref, dense = random_coo(rng, n, m, nnz)
    return ref, _port_coo(ref), dense


@pytest.mark.parametrize("k", [16, 602])
@pytest.mark.parametrize("max_deg", [None, 3])
def test_ell_plain_matches_pallas_interpret(rng, k, max_deg):
    ref, got, _ = _graph(rng, 24, 37, 90)
    jell = C.ell_from_coo(ref, max_deg=max_deg)
    tell = tsp.ell_from_coo(got, max_deg=max_deg)
    h = rng.standard_normal((37, k)).astype(np.float32)
    out = ell_spmm_plain(tell, torch.from_numpy(h)).numpy()
    pallas = np.asarray(jops.ell_spmm(jell, h, interpret=True))
    oracle = np.asarray(jax_spmm_ell_ref(jell, h, C.get_semiring("sum")))
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    assert out.dtype == np.float32 and out.shape == (24, k)


@pytest.mark.parametrize("c,sigma", [(8, 0), (16, 0), (32, 0), (8, 8)])
@pytest.mark.parametrize("k", [16, 602])
def test_sell_plain_matches_pallas_interpret(rng, c, sigma, k):
    ref, got, dense = _graph(rng, 30, 21, 110)
    jsell = C.sell_from_coo(ref, c=c, sigma=sigma)
    tsell = tsp.sell_from_coo(got, c=c, sigma=sigma)
    h = rng.standard_normal((21, k)).astype(np.float32)
    out = sell_spmm_plain(tsell, torch.from_numpy(h)).numpy()
    pallas = np.asarray(jops.sell_spmm(jsell, h, interpret=True))
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, dense @ h, atol=1e-4, rtol=1e-5)
    zero_rows = (dense != 0).sum(1) == 0
    assert zero_rows.any() and (out[zero_rows] == 0).all()


@pytest.fixture(scope="module")
def blocks():
    """One sampled flush packed by both packages, per plan."""
    from repro.data import make_dataset as jax_make_dataset
    jds = jax_make_dataset("reddit", scale=1 / 512, seed=1)
    tds = make_dataset("reddit", scale=1 / 512, seed=1)
    seeds = np.array([2, 9, 33, 150])
    jb = JSampler(C.csr_from_coo(jds.coo), (4, 6), seed=0).sample(seeds)
    tb = NeighborSampler(tsp.csr_from_coo(tds.coo), (4, 6),
                         seed=0).sample(seeds)
    bk = plan_buckets(tb, batch_size=16, fanouts=(4, 6))[0]
    assert bk.signature == jax_plan_buckets(jb, batch_size=16,
                                            fanouts=(4, 6))[0].signature
    args = dict(n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz,
                ell_width=bk.ell_width, sell_steps=bk.sell_steps)
    out = {}
    for kind, kw in (("ell", {}), ("sell", {"sell_c": 8}),
                     ("trusted", {})):
        out[kind] = (jax_pack_block(jb[0], plan=JPlan(kind=kind, **kw),
                                    **args),
                     pack_block(tb[0], plan=KernelPlan(kind=kind, **kw),
                                **args))
    return out, bk.n_src


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("kind", ["ell", "sell", "trusted"])
def test_block_spmm_semirings(blocks, reduce, kind):
    packed, n_src = blocks
    pj, pt = packed[kind]
    h = np.random.default_rng(5).standard_normal((n_src, 24)) \
        .astype(np.float32)
    want = np.asarray(jax_block_spmm(pj, h, reduce))
    got = block_spmm(pt, torch.from_numpy(h), reduce).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_coo_ref_semirings_match_dense(rng, reduce):
    ref, got, dense = _graph(rng, 20, 15, 70)
    h = rng.standard_normal((15, 8)).astype(np.float32)
    deg = torch.from_numpy((dense != 0).sum(1).astype(np.float32))
    out = spmm_coo_ref(got, torch.from_numpy(h), get_semiring(reduce),
                       degrees=deg).numpy()
    msg = np.where((dense != 0)[:, :, None], dense[:, :, None] * h[None],
                   np.nan)
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore")   # all-nan rows: the empty ones
        want = {"sum": np.nansum(msg, 1),
                "mean": np.nansum(msg, 1) / np.maximum(deg.numpy(), 1)[:, None],
                "max": np.nanmax(msg, 1), "min": np.nanmin(msg, 1)}[reduce]
    want = np.nan_to_num(want, nan=0.0)       # empty rows -> 0
    np.testing.assert_allclose(out, want, atol=1e-5, rtol=1e-5)


def test_cpu_dispatch_uses_plain_and_counts_nothing(rng):
    _, got, dense = _graph(rng, 16, 12, 40)
    h = torch.from_numpy(rng.standard_normal((12, 5)).astype(np.float32))
    tops.reset_kernel_launches()
    a = tops.ell_spmm(tsp.ell_from_coo(got), h)
    b = tops.sell_spmm(tsp.sell_from_coo(got, c=8), h)
    np.testing.assert_allclose(a.numpy(), dense @ h.numpy(), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), dense @ h.numpy(), atol=1e-5)
    launches = tops.kernel_launches()
    assert {"ell_spmm", "sell_spmm", "bsr_spmm"} <= set(launches)
    assert not any(launches.values())


def test_dispatch_refuses_other_devices(rng):
    _, got, _ = _graph(rng, 8, 8, 20)
    h = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError, match="no SpMM implementation"):
        tops.ell_spmm(tsp.ell_from_coo(got), h)
    with pytest.raises(ValueError, match="CUDA tensor"):
        from repro_torch.kernels.ell_spmm import ell_spmm_cuda
        ell_spmm_cuda(tsp.ell_from_coo(got), torch.zeros((8, 4)))


def test_slice_pointers_and_vec_width(rng):
    _, got, _ = _graph(rng, 40, 30, 120)
    sell = tsp.sell_from_coo(got, c=8)
    ptr = slice_pointers(sell).numpy()
    first = np.nonzero(sell.first_step.numpy())[0]
    assert np.array_equal(ptr[:-1], first) and ptr[-1] == sell.n_steps
    assert ptr.dtype == np.int32
    t = torch.zeros(64)
    assert vec_width(602, t) == 2 and vec_width(256, t) == 4
    assert vec_width(601, t) == 1 and vec_width(256, t[1:]) == 1


def test_slot_gather_and_table_insert():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    rows = -torch.ones((3, 3))
    out = tops.slot_gather(table, torch.tensor([2, -1, 0]), rows)
    assert torch.equal(out, torch.stack([table[2], rows[1], table[0]]))
    tops.table_insert(table, np.array([1, -1, 3]),
                      torch.full((3, 3), 7.0))
    assert (table[1] == 7).all() and (table[3] == 7).all()
    assert (table[0] == torch.tensor([0.0, 1.0, 2.0])).all()


def test_kernel_library_names_follow_sources():
    for name in KERNELS:
        p = _lib_path(name)
        assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"
        assert p == _lib_path(name)            # content hash is stable


def test_build_dir_is_the_checkouts_or_named(monkeypatch, tmp_path):
    root = Path(__file__).resolve().parents[1]
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert build_dir() == root / "build" / "kernels"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert build_dir() == tmp_path.resolve()
    assert _lib_path(KERNELS[0]).parent == tmp_path.resolve()
