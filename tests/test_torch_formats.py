"""The PyTorch port's host-side formats, graphs, sampler and packing
against the JAX reference: the same numpy inputs go to both packages and
every index table must come back bitwise equal (both sides run the same
numpy algorithms; only the container type differs)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.autotune import KernelPlan as JPlan
from repro.data import make_dataset as jax_make_dataset
from repro.sampling import NeighborSampler as JSampler
from repro.sampling import pack_block as jax_pack_block
from repro.sampling import plan_buckets as jax_plan_buckets

from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import KernelPlan
from repro_torch.data import make_dataset
from repro_torch.sampling import NeighborSampler, pack_block, plan_buckets

from conftest import random_coo


def _edges(coo):
    """(src, dst, val) numpy of a reference COO's real entries."""
    return (np.asarray(coo.col)[: coo.nse], np.asarray(coo.row)[: coo.nse],
            np.asarray(coo.val)[: coo.nse])


def _port_coo(coo, pad_to=None):
    src, dst, val = _edges(coo)
    return tsp.coo_from_edges(src, dst, val, coo.nrows, coo.ncols,
                              pad_to=pad_to)


def _same(jax_arr, t):
    want = np.asarray(jax_arr)
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,m,nnz,pad", [(64, 48, 500, None),
                                         (40, 90, 300, 512),
                                         (33, 33, 0, 8)])
def test_coo_and_csr_bitwise(rng, n, m, nnz, pad):
    ref, _ = random_coo(rng, n, m, nnz, pad_to=pad)
    got = _port_coo(ref, pad_to=pad)
    for f in ("row", "col", "val"):
        _same(getattr(ref, f), getattr(got, f))
    assert (got.nrows, got.ncols, got.nse) == (ref.nrows, ref.ncols, ref.nse)
    jcsr, tcsr = C.csr_from_coo(ref), tsp.csr_from_coo(got)
    for f in ("indptr", "indices", "val", "row_ids"):
        _same(getattr(jcsr, f), getattr(tcsr, f))


@pytest.mark.parametrize("max_deg", [None, 4, 0])
def test_ell_bitwise(rng, max_deg):
    ref, _ = random_coo(rng, 60, 50, 300)
    jell = C.ell_from_coo(ref, max_deg=max_deg)
    tell = tsp.ell_from_coo(_port_coo(ref), max_deg=max_deg)
    _same(jell.idx, tell.idx)
    _same(jell.val, tell.val)
    assert tell.idx.dtype == torch.int32
    assert (tell.nrows, tell.ncols, tell.nse) == (jell.nrows, jell.ncols,
                                                  jell.nse)


@pytest.mark.parametrize("c,sigma", [(8, 0), (16, 0), (32, 0), (8, 16),
                                     (4, 24)])
def test_sell_bitwise(rng, c, sigma):
    ref, _ = random_coo(rng, 70, 50, 400)
    jsell = C.sell_from_coo(ref, c=c, sigma=sigma)
    tsell = tsp.sell_from_coo(_port_coo(ref), c=c, sigma=sigma)
    for f in ("idx", "val", "slice_of", "first_step", "perm", "inv_perm"):
        _same(getattr(jsell, f), getattr(tsell, f))
    for f in ("nrows", "ncols", "nse", "c", "sigma", "nslices"):
        assert getattr(tsell, f) == getattr(jsell, f), f


def test_sell_empty_graph_matches():
    ref = C.coo_from_edges(np.zeros(0), np.zeros(0), None, 5, 7)
    got = tsp.coo_from_edges(np.zeros(0), np.zeros(0), None, 5, 7)
    jsell, tsell = C.sell_from_coo(ref, c=4), tsp.sell_from_coo(got, c=4)
    for f in ("idx", "slice_of", "first_step", "perm", "inv_perm"):
        _same(getattr(jsell, f), getattr(tsell, f))


def test_to_device_moves_nested_tensors(rng):
    ref, _ = random_coo(rng, 20, 20, 60)
    sell = tsp.sell_from_coo(_port_coo(ref), c=8)
    moved = tsp.to_device(sell, "cpu")
    assert moved.c == 8 and torch.equal(moved.idx, sell.idx)


def test_make_dataset_bitwise(tiny_dataset):
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    for f in ("row", "col", "val"):
        _same(getattr(tiny_dataset.coo, f), getattr(ds.coo, f))
        _same(getattr(tiny_dataset.coo_sl, f), getattr(ds.coo_sl, f))
    for f in ("x", "y", "train_mask", "val_mask", "test_mask"):
        _same(getattr(tiny_dataset, f), getattr(ds, f))
    assert ds.num_classes == tiny_dataset.num_classes
    assert ds.x.dtype == torch.float32 and ds.x.device.type == "cpu"


@pytest.fixture(scope="module")
def samplers(tiny_dataset):
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    return (C.csr_from_coo(tiny_dataset.coo), tsp.csr_from_coo(ds.coo))


@pytest.mark.parametrize("fanouts,replace", [((5, 5), False),
                                             ((10, 25), False),
                                             ((3, 4), True),
                                             ((None, None), False)])
@pytest.mark.parametrize("rnd", [0, 7])
def test_sampler_blocks_bitwise(samplers, fanouts, replace, rnd):
    jcsr, tcsr = samplers
    seeds = np.array([3, 17, 64, 200, 301])
    jb = JSampler(jcsr, fanouts, replace=replace, seed=2).sample(seeds,
                                                                 round=rnd)
    tb = NeighborSampler(tcsr, fanouts, replace=replace,
                         seed=2).sample(seeds, round=rnd)
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert a.n_dst == b.n_dst and a.num_nodes == b.num_nodes
        for f in ("src_ids", "row", "col", "val"):
            _same(getattr(a, f), getattr(b, f))


_PLANS = [("ell", {}), ("sell", {"sell_c": 8}), ("sell", {"sell_c": 16}),
          ("sell", {"sell_c": 32}), ("trusted", {})]


@pytest.mark.parametrize("kind,kw", _PLANS)
@pytest.mark.parametrize("fanouts", [(5, 5), (None, None)])
def test_pack_block_bitwise(samplers, kind, kw, fanouts):
    jcsr, tcsr = samplers
    seeds = np.array([1, 2, 40, 77])
    jb = JSampler(jcsr, fanouts, seed=0).sample(seeds, round=3)
    tb = NeighborSampler(tcsr, fanouts, seed=0).sample(seeds, round=3)
    jbk = jax_plan_buckets(jb, batch_size=16, fanouts=fanouts)
    tbk = plan_buckets(tb, batch_size=16, fanouts=fanouts)
    assert [b.signature for b in jbk] == [b.signature for b in tbk]
    for blk_j, blk_t, bk in zip(jb, tb, tbk):
        args = dict(n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz,
                    ell_width=bk.ell_width, sell_steps=bk.sell_steps)
        pj = jax_pack_block(blk_j, plan=JPlan(kind=kind, **kw), **args)
        pt = pack_block(blk_t, plan=KernelPlan(kind=kind, **kw), **args)
        for f in ("src_ids", "dst_pos", "row", "col", "val", "degrees"):
            _same(getattr(pj, f), getattr(pt, f))
        assert int(pj.n_dst_real) == pt.n_dst_real
        assert int(pj.nnz_real) == pt.nnz_real
        assert pj.bucket_signature == pt.bucket_signature
        assert (pj.ell is None) == (pt.ell is None)
        assert (pj.sell is None) == (pt.sell is None)
        if pt.ell is not None:
            _same(pj.ell.idx, pt.ell.idx)
            _same(pj.ell.val, pt.ell.val)
        if pt.sell is not None:
            for f in ("idx", "val", "slice_of", "first_step", "perm",
                      "inv_perm"):
                _same(getattr(pj.sell, f), getattr(pt.sell, f))
            assert dataclasses.astuple(pt.sell)[6:] == \
                dataclasses.astuple(pj.sell)[6:]
