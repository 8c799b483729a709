"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where no CUDA card
is present (the kernels have no CPU mode); the file imports no JAX, so it
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: fp32, atol 1e-5 / rtol 1e-5 — the kernel sums a row's slots
in slot order with fma, the plain version with ``sum(dim=1)`` /
``index_add_`` (for BSR: ``bmm`` with TF32 off, then ``index_add_``); at
most ~30 terms of magnitude ~1 per output here. Wider sums state their
own tolerance. The sampling kernels are integer work (or a word copy)
and must equal their plain versions bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import sparse as tsp
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda, bsr_spmm_plain
from repro_torch.kernels.ell_spmm import ell_spmm_cuda, ell_spmm_plain
from repro_torch.kernels.sell_spmm import sell_spmm_cuda, sell_spmm_plain

TOL = dict(atol=1e-5, rtol=1e-5)
EPS32 = 2.0 ** -24

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 references
    return torch.device("cuda")


def _coo(rng, n, m, nnz):
    """Random rectangular unique-edge COO; some rows stay empty."""
    lin = rng.choice(n * m, size=nnz, replace=False)
    dst, src = lin // m, lin % m
    val = rng.standard_normal(nnz).astype(np.float32)
    return tsp.coo_from_edges(src, dst, val, n, m)


def _h(rng, n, k):
    return torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))


@pytest.mark.parametrize("k", [16, 602, 256, 7])
@pytest.mark.parametrize("max_deg", [None, 3])
def test_ell_kernel_matches_plain(card, k, max_deg):
    rng = np.random.default_rng(k)
    ell = tsp.ell_from_coo(_coo(rng, 70, 45, 400), max_deg=max_deg)
    h = _h(rng, 45, k)
    out = ell_spmm_cuda(tsp.to_device(ell, card), h.to(card))
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(),
                               ell_spmm_plain(ell, h).numpy(), **TOL)


@pytest.mark.parametrize("c,sigma", [(4, 0), (8, 0), (16, 16), (32, 0),
                                     (48, 0)])
@pytest.mark.parametrize("k", [16, 602, 256])
def test_sell_kernel_matches_plain(card, c, sigma, k):
    rng = np.random.default_rng(c + k)
    sell = tsp.sell_from_coo(_coo(rng, 90, 60, 500), c=c, sigma=sigma)
    h = _h(rng, 60, k)
    out = sell_spmm_cuda(tsp.to_device(sell, card), h.to(card))
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(),
                               sell_spmm_plain(sell, h).numpy(), **TOL)


def test_skewed_rows_and_padded_steps(card):
    """A hub row far above the rest, and sentinel steps appended to the
    last slice (as the bucket ladder pads them)."""
    from repro_torch.sampling.blocks import _pad_sell_steps
    rng = np.random.default_rng(0)
    src = np.concatenate([np.arange(300), rng.integers(0, 300, 60)])
    dst = np.concatenate([np.zeros(300, np.int64), rng.integers(1, 50, 60)])
    key = np.unique(dst * 300 + src)
    coo = tsp.coo_from_edges(key % 300, key // 300, None, 50, 300)
    sell = _pad_sell_steps(tsp.sell_from_coo(coo, c=8), 1024)
    h = _h(rng, 300, 602)
    out = sell_spmm_cuda(tsp.to_device(sell, card), h.to(card))
    np.testing.assert_allclose(out.cpu().numpy(),
                               sell_spmm_plain(sell, h).numpy(),
                               atol=1e-4, rtol=1e-5)   # 300-term hub row


def test_dispatch_counts_launches_and_rejects_bad_operands(card):
    rng = np.random.default_rng(1)
    coo = _coo(rng, 30, 20, 80)
    ell = tsp.to_device(tsp.ell_from_coo(coo), card)
    sell = tsp.to_device(tsp.sell_from_coo(coo, c=8), card)
    h = _h(rng, 20, 32).to(card)
    tops.reset_kernel_launches()
    tops.ell_spmm(ell, h)
    tops.sell_spmm(sell, h)
    tops.sell_spmm(sell, h)
    assert {k: v for k, v in tops.kernel_launches().items() if v} == {
        "ell_spmm": 1, "sell_spmm": 2}
    with pytest.raises(ValueError, match="contiguous fp32"):
        tops.ell_spmm(ell, h.t().contiguous().t())
    with pytest.raises(ValueError, match="rows"):
        tops.ell_spmm(ell, h[:10])
    with pytest.raises(ValueError, match="contiguous fp32"):
        tops.sell_spmm(sell, h.double())
    assert {k: v for k, v in tops.kernel_launches().items() if v} == {
        "ell_spmm": 1, "sell_spmm": 2}


def test_runs_on_the_current_stream(card):
    rng = np.random.default_rng(2)
    coo = _coo(rng, 64, 64, 300)
    ell = tsp.to_device(tsp.ell_from_coo(coo), card)
    h = _h(rng, 64, 602).to(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = tops.ell_spmm(ell, h)
        out2 = out * 1.0                       # ordered after the kernel
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        out2.cpu().numpy(),
        ell_spmm_plain(tsp.ell_from_coo(coo), h.cpu()).numpy(), **TOL)


def _bsr_case(rng, br, bc, pad_blocks):
    """A 300 x 280 graph whose rows 128..255 are empty: at br <= 128 some
    block rows own only their explicit zero block; ``pad_blocks`` padding
    blocks replicate the last block row."""
    n, m = 300, 280
    rows = np.concatenate([np.arange(0, 128), np.arange(256, n)])
    lin = rng.choice(len(rows) * m, size=2000, replace=False)
    dst, src = rows[lin // m], lin % m
    coo = tsp.coo_from_edges(src, dst, rng.standard_normal(2000)
                             .astype(np.float32), n, m)
    bsr = tsp.bsr_from_coo(coo, br=br, bc=bc)
    return tsp.bsr_from_coo(coo, br=br, bc=bc,
                            pad_blocks_to=bsr.nblocks + pad_blocks)


@pytest.mark.parametrize("br,bc", [(32, 128), (64, 128), (128, 128),
                                   (256, 128), (128, 256)])
@pytest.mark.parametrize("k", [1, 16, 112, 256, 602])
def test_bsr_kernel_matches_plain(card, br, bc, k):
    rng = np.random.default_rng(br + bc + k)
    bsr = _bsr_case(rng, br, bc, pad_blocks=3)
    h = _h(rng, 280, k)                  # fewer rows than the padded ncols
    out = bsr_spmm_cuda(tsp.to_device(bsr, card), h.to(card))
    torch.cuda.synchronize()
    assert out.shape == (bsr.nrows, k)
    np.testing.assert_allclose(out.cpu().numpy(),
                               bsr_spmm_plain(bsr, h).numpy(), **TOL)


def test_bsr_kernel_zero_block_rows(card):
    """A block row that holds only its explicit zero block stores zeros."""
    rng = np.random.default_rng(5)
    bsr = _bsr_case(rng, 64, 128, pad_blocks=0)
    ptr = tsp.to_device(bsr, card)
    out = bsr_spmm_cuda(ptr, _h(rng, 280, 64).to(card))
    torch.cuda.synchronize()
    assert (out[128:256] == 0).all()
    assert (out[:128] != 0).any()


def test_bsr_kernel_64bit_offsets(card):
    """132,096 tiles of 128 x 128: the tile array passes 2^31 elements
    (8.7 GB), and only the last block row's tiles, all past the 2^31
    offset, hold data. Each output sums 16,512 products of N(0,1) terms
    (|sum| ~ 130): atol 2e-3 / rtol 1e-4 for the summation order."""
    n_brows, per_row, t = 1024, 129, 128
    blk_row = torch.arange(n_brows, dtype=torch.int32,
                           device=card).repeat_interleave(per_row)
    blk_col = torch.arange(per_row, dtype=torch.int32,
                           device=card).repeat(n_brows)
    blocks = torch.zeros((n_brows * per_row, t, t), device=card)
    assert blocks.numel() > 2 ** 31
    gen = torch.Generator(device=card).manual_seed(0)
    blocks[-per_row:] = torch.randn((per_row, t, t), generator=gen,
                                    device=card)
    bsr = tsp.BSR(blk_row=blk_row, blk_col=blk_col, blocks=blocks,
                  nrows=n_brows * t, ncols=per_row * t, br=t, bc=t,
                  n_real_blocks=n_brows * per_row)
    h = torch.randn((per_row * t, 16), generator=gen, device=card)
    out = bsr_spmm_cuda(bsr, h)
    want = bsr_spmm_plain(bsr, h)
    torch.cuda.synchronize()
    assert (out[:-t] == 0).all()
    np.testing.assert_allclose(out[-t:].cpu().numpy(),
                               want[-t:].cpu().numpy(), atol=2e-3,
                               rtol=1e-4)


def _split_tf32_ratio(bsr, h, out):
    """Largest |kernel - plain| over ``split_tf32_bound`` (the bound
    chip_smoke.py holds every BSR launch to: split TF32 products and
    fp32 accumulation of the row's d real terms)."""
    import dataclasses
    from repro_torch.kernels.bsr_spmm import split_tf32_bound
    want = bsr_spmm_plain(bsr, h)
    mag = bsr_spmm_plain(dataclasses.replace(bsr, blocks=bsr.blocks.abs()),
                         h.abs())
    nz = (bsr.blocks != 0).sum(dim=2, dtype=torch.int32)
    per = torch.zeros((bsr.n_block_rows, bsr.br), dtype=torch.int32,
                      device=nz.device)
    per.index_add_(0, bsr.blk_row.long(), nz)
    bound = split_tf32_bound(per.reshape(-1).float()[:, None], mag) + 1e-30
    return float(((out - want).abs() / bound).max())


@pytest.mark.parametrize("br,bc", [(32, 128), (64, 128), (128, 128),
                                   (256, 128), (128, 256)])
@pytest.mark.parametrize("k", [1, 112, 256, 300])
def test_bsr_kernel_within_split_tf32_bound(card, br, bc, k):
    """Zero block rows (rows 128..255 hold no edge), padding blocks, every
    K tile width and a ragged last one (K = 300): every element within the
    split-TF32 bound of the plain version, zero rows exactly zero."""
    rng = np.random.default_rng(7 * br + bc + k)
    bsr = tsp.to_device(_bsr_case(rng, br, bc, pad_blocks=3), card)
    h = _h(rng, 280, k).to(card)
    out = bsr_spmm_cuda(bsr, h)
    torch.cuda.synchronize()
    assert _split_tf32_ratio(bsr, h, out) <= 1.0
    assert (out[128:256] == 0).all() and torch.isfinite(out).all()


def test_bsr_kernel_is_deterministic(card):
    """No atomics: rows whose tiles are cut into chunks are summed in
    chunk order, so two launches on the same operands agree bit for bit
    (here 4,096 tiles over 32 block rows, several chunks a row)."""
    gen = torch.Generator(device=card).manual_seed(3)
    n_brows, per_row, t = 32, 128, 128
    blk_row = torch.arange(n_brows, dtype=torch.int32,
                           device=card).repeat_interleave(per_row)
    blk_col = torch.randint(0, 64, (n_brows * per_row,), generator=gen,
                            device=card, dtype=torch.int32)
    blocks = torch.randn((n_brows * per_row, t, t), generator=gen,
                         device=card)
    bsr = tsp.BSR(blk_row=blk_row, blk_col=blk_col, blocks=blocks,
                  nrows=n_brows * t, ncols=64 * t, br=t, bc=t,
                  n_real_blocks=n_brows * per_row)
    h = torch.randn((64 * t, 256), generator=gen, device=card)
    first = bsr_spmm_cuda(bsr, h)
    second = bsr_spmm_cuda(bsr, h)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _split_tf32_ratio(bsr, h, first) <= 1.0


def test_bsr_dispatch_counts_and_rejects(card):
    rng = np.random.default_rng(3)
    bsr = tsp.to_device(_bsr_case(rng, 128, 128, pad_blocks=0), card)
    h = _h(rng, 280, 32).to(card)
    tops.reset_kernel_launches()
    tops.bsr_spmm(bsr, h)
    assert tops.kernel_launches()["bsr_spmm"] == 1
    import dataclasses
    with pytest.raises(ValueError, match="not built"):
        tops.bsr_spmm(dataclasses.replace(bsr, br=48), h)
    with pytest.raises(ValueError, match="rows"):
        tops.bsr_spmm(bsr, _h(rng, 400, 32).to(card))
    with pytest.raises(ValueError, match="contiguous fp32"):
        tops.bsr_spmm(bsr, h.double())
    assert tops.kernel_launches()["bsr_spmm"] == 1


@pytest.mark.parametrize("arch,plan", [("gcn", "bsr"), ("sage-mean", "sell"),
                                       ("gin", "ell")])
def test_patched_training_step_matches_unpatched(card, arch, plan):
    """One training step on the card, patched (the plan's kernel forward
    and on the cached transpose) against unpatched (the trusted path with
    plain autograd), from the same weights. Loss within rtol 1e-5, each
    gradient within 1e-4 of its largest element (fp32, another
    summation order over a few hundred terms)."""
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.core.patch import patched
    from repro_torch.data import make_dataset
    from repro_torch.models.gnn import build_bundle, make_gnn
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train.gnn import loss_and_grads

    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    bundle = build_bundle(ds, k_hint=64, plan=KernelPlan(
        kind=plan, br=64, bc=128, fk=64, sell_c=8)).to(card)
    init, apply = make_gnn(arch, ds.num_features, 64, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device=card)
    x, y, m = (t.to(card) for t in (ds.x, ds.y, ds.train_mask))
    tops.reset_kernel_launches()
    with patched(True):
        loss_t, g_t = loss_and_grads(apply, params, bundle, x, y, m)
    launches = tops.kernel_launches()
    with patched(False):
        loss_b, g_b = loss_and_grads(apply, params, bundle, x, y, m)
    torch.cuda.synchronize()
    # forward on A (or Â) per layer, backward on the cached transpose
    assert launches[f"{plan}_spmm"] >= 3
    np.testing.assert_allclose(float(loss_t), float(loss_b), rtol=1e-5)

    def close(a, b):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-4 * float(b.abs().max()) + 1e-12,
                                   rtol=0)
    tree_map(close, g_t, g_b)


# --------------------------------------------------------------------------
# the sampling kernels (csrc/sample.cu), bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("width", [1, 10, 25, 32, 33, 64, 200])
@pytest.mark.parametrize("rnd", [0, -1])
def test_segment_sample_kernel_matches_plain(card, replace, width, rnd):
    """width > 32 without replacement takes the shared-memory table."""
    from repro_torch.kernels import sample as ks
    rng = np.random.default_rng(width)
    f = 3000
    deg = rng.integers(0, 6 * width + 2, f).astype(np.int32)
    deg[:4] = [0, width, width + 1, 100_000]
    gid = rng.integers(0, 1 << 30, f).astype(np.int32)
    gid[-3:] = 1 << 30          # sentinel rows
    deg[-3:] = 0
    d, g = torch.from_numpy(deg), torch.from_numpy(gid)
    kw = dict(width=width, seed=5, hop=1, replace=replace)
    tops.reset_kernel_launches()
    got = ks.segment_sample(d.to(card), g.to(card), rnd, fanout=width, **kw)
    torch.cuda.synchronize()
    assert tops.kernel_launches()["segment_sample"] == 1
    assert torch.equal(got.cpu(), ks.segment_sample_plain(d, g, rnd, **kw))
    # the plain version gives the same bits on the card
    assert torch.equal(got, ks.segment_sample_plain(d.to(card), g.to(card),
                                                    rnd, **kw))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_expand_indptr_and_flat_gather_kernels_match_plain(card, dtype):
    from repro_torch.kernels import sample as ks
    rng = np.random.default_rng(2)
    f, width, nse = 5000, 25, 200_000
    start = torch.from_numpy(rng.integers(0, nse - width, f).astype(np.int32))
    ranks = torch.from_numpy(rng.integers(0, width, (f, width))
                             .astype(np.int32))
    valid = torch.from_numpy(rng.random((f, width)) < 0.6)
    tops.reset_kernel_launches()
    pos = ks.expand_indptr(start.to(card), ranks.to(card), valid.to(card),
                           sentinel=nse)
    want = ks.expand_indptr_plain(start, ranks, valid, sentinel=nse)
    assert torch.equal(pos.cpu(), want)
    arr = torch.from_numpy((rng.standard_normal(nse + 1) * 1000)
                           .astype(np.float32)).to(dtype)
    out = ks.flat_gather(arr.to(card), pos)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(
        out.cpu(), ks.flat_gather_plain(arr, want))
    # out-of-range positions clip
    odd = torch.tensor([[-5, 0, nse, nse + 7]], dtype=torch.int32)
    assert torch.equal(ks.flat_gather(arr.to(card), odd.to(card)).cpu(),
                       ks.flat_gather_plain(arr, odd))
    assert tops.kernel_launches()["expand_indptr"] == 1
    assert tops.kernel_launches()["flat_gather"] == 2
    with pytest.raises(ValueError, match="contiguous"):
        ks.flat_gather(arr.double().to(card), pos)
    with pytest.raises(ValueError, match="contiguous"):
        ks.expand_indptr_cuda(start.to(card), ranks.to(card),
                              valid.int().to(card), sentinel=nse)


def test_device_sampled_step_matches_cpu(card):
    """One device-sampled training step on the card against the same step
    on the CPU, from the same weights: the sampled blocks are equal bit
    for bit, the loss within rtol 1e-5 and each gradient within 1e-5 of
    its largest element (fp32, another summation order)."""
    from repro_torch.core import sparse as sp
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.core.patch import patched
    from repro_torch.data import make_dataset
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.sampling import DeviceSampler, device_graph_from_csr
    from repro_torch.train import gnn_minibatch as mb

    ds = make_dataset("reddit", scale=1 / 64, seed=1)
    csr = sp.csr_from_coo(ds.coo)
    init, _, apply_blocks, _ = mb.make_block_model(
        "sage-mean", ds.num_features, 64, ds.num_classes, 2)
    params = init(torch.Generator().manual_seed(0), device="cpu")
    seeds = torch.from_numpy(np.random.default_rng(0).permutation(
        ds.num_nodes)[:256].astype(np.int32))
    out = {}
    for dev in ("cpu", card):
        samp = DeviceSampler(device_graph_from_csr(csr, device=dev), (10, 25),
                             batch_size=256, seed=0, base=128)
        samp.set_plans([KernelPlan(kind="ell")] * 2)
        opt = adamw(1e-2, weight_decay=5e-4)
        p = tree_map(lambda t: t.to(dev), params)
        step = mb.make_device_minibatch_step(apply_blocks, opt, samp,
                                             batch_size=256)
        tops.reset_kernel_launches()
        with patched(True):
            res = step(p, opt.init(p), seeds.to(dev), 250, 3, ds.x.to(dev),
                       ds.y.to(dev), mb.init_step_stats(dev))
            blocks = samp.sample_blocks(torch.where(
                torch.arange(256) < 250, seeds, ds.num_nodes).to(dev), 3)
        out[str(dev)] = (res, blocks, tops.kernel_launches())
    (rc, bc, lc), (rg, bg, lg) = out["cpu"], out[str(card)]
    assert not any(lc.values())
    # one fused launch a hop; the standalone sampling kernels stay idle
    assert lg["sample_hop"] == 2 * 2 and lg["ell_spmm"] > 0, lg
    for name in ("segment_sample", "expand_indptr", "flat_gather"):
        assert lg[name] == 0, lg
    for a, b in zip(bc, bg):
        for f in ("src_ids", "dst_pos", "col", "val", "degrees"):
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
    np.testing.assert_allclose(float(rg[2]), float(rc[2]), rtol=1e-5)
    tree_map(lambda g, want: np.testing.assert_allclose(
        g.cpu().numpy(), want.numpy(), rtol=0,
        atol=1e-5 * float(want.abs().max()) + 1e-12), rg[3], rc[3])
    assert rg[4].drain() == rc[4].drain()


# --------------------------------------------------------------------------
# the edge-score kernels (csrc/sddmm.cu, csrc/fusedmm.cu)
# --------------------------------------------------------------------------

def _score_inputs(rng, d, k=None, n=300, m=280):
    """x (n, d) / sqrt(d) and y (m, d), so that scores are ~N(0, 1), and
    h (m, k); fewer rows than the padded BSR (the rest read zero)."""
    x = _h(rng, n, d) / float(d) ** 0.5
    y = _h(rng, m, d)
    return (x, y) if k is None else (x, y, _h(rng, m, k))


def _close(got, want):
    """fp32 tolerance of the edge-score kernels: rtol 1e-4 and atol
    1e-4 x max|want| (D-term dot products summed in another order, then
    up to 128 weighted h rows per tile; softmax weights sum to 1)."""
    want = want.cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()) + 1e-6)


@pytest.mark.parametrize("br,bc", [(32, 128), (128, 128), (128, 256)])
@pytest.mark.parametrize("d", [16, 130, 256])
@pytest.mark.parametrize("scale_by_a", [True, False])
def test_sddmm_kernel_matches_plain(card, br, bc, d, scale_by_a):
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda, sddmm_bsr_plain
    rng = np.random.default_rng(br + d)
    bsr = _bsr_case(rng, br, bc, pad_blocks=3)
    x, y = _score_inputs(rng, d)
    dbsr = tsp.to_device(bsr, card)
    out = sddmm_bsr_cuda(dbsr, x.to(card), y.to(card), scale_by_a=scale_by_a)
    torch.cuda.synchronize()
    assert out.shape == (bsr.nblocks, br, bc)
    _close(out, sddmm_bsr_plain(bsr, x, y, scale_by_a=scale_by_a))


@pytest.mark.parametrize("br,bc", [(32, 128), (128, 128), (128, 256)])
@pytest.mark.parametrize("d", [16, 130, 256])
@pytest.mark.parametrize("k", [64, 256, 384])
@pytest.mark.parametrize("edge_op", ["softmax", "sigmoid", "none"])
def test_fusedmm_kernel_matches_plain(card, br, bc, d, k, edge_op):
    """Rows 128..255 have no entry (at br = 32 whole block rows own only
    their zero tile) and three padding blocks replicate the last block
    row: those rows, and the padded rows past 300, store 0."""
    from repro_torch.kernels.fusedmm import (fusedmm_bsr_cuda,
                                             fusedmm_bsr_plain)
    rng = np.random.default_rng(br + d + k)
    bsr = _bsr_case(rng, br, bc, pad_blocks=3)
    x, y, h = _score_inputs(rng, d, k)
    out = fusedmm_bsr_cuda(tsp.to_device(bsr, card), x.to(card), y.to(card),
                           h.to(card), edge_op=edge_op)
    torch.cuda.synchronize()
    assert out.shape == (bsr.nrows, k)
    _close(out, fusedmm_bsr_plain(bsr, x, y, h, edge_op=edge_op))
    assert (out[128:256] == 0).all() and (out[300:] == 0).all()


def test_fusedmm_kernel_wide_h_launches_per_512_columns(card):
    from repro_torch.kernels.fusedmm import fusedmm_bsr_plain
    rng = np.random.default_rng(7)
    bsr = _bsr_case(rng, 64, 128, pad_blocks=1)
    x, y, h = _score_inputs(rng, 32, 602)
    tops.reset_kernel_launches()
    out = tops.fusedmm_bsr(tsp.to_device(bsr, card), x.to(card), y.to(card),
                           h.to(card))
    torch.cuda.synchronize()
    assert tops.kernel_launches()["fusedmm_bsr"] == 2
    _close(out, fusedmm_bsr_plain(bsr, x, y, h))


def _big_bsr(card, d):
    """132,096 tiles of 128 x 128 (the tile array passes 2^31 elements,
    8.7 GB): only the last block row's tiles, all past the 2^31 offset,
    hold entries (a random 1 % of positions)."""
    n_brows, per_row, t = 1024, 129, 128
    blk_row = torch.arange(n_brows, dtype=torch.int32,
                           device=card).repeat_interleave(per_row)
    blk_col = torch.arange(per_row, dtype=torch.int32,
                           device=card).repeat(n_brows)
    blocks = torch.zeros((n_brows * per_row, t, t), device=card)
    assert blocks.numel() > 2 ** 31
    gen = torch.Generator(device=card).manual_seed(0)
    blocks[-per_row:] = (torch.rand((per_row, t, t), generator=gen,
                                    device=card) < 0.01).float()
    bsr = tsp.BSR(blk_row=blk_row, blk_col=blk_col, blocks=blocks,
                  nrows=n_brows * t, ncols=per_row * t, br=t, bc=t,
                  n_real_blocks=n_brows * per_row)
    x = torch.randn((n_brows * t, d), generator=gen, device=card) / d ** 0.5
    y = torch.randn((per_row * t, d), generator=gen, device=card)
    return bsr, x, y, gen


def test_fusedmm_kernel_64bit_offsets(card):
    from repro_torch.kernels.fusedmm import (fusedmm_bsr_cuda,
                                             fusedmm_bsr_plain)
    bsr, x, y, gen = _big_bsr(card, 16)
    h = torch.randn((y.shape[0], 128), generator=gen, device=card)
    for edge_op in ("softmax", "none"):
        out = fusedmm_bsr_cuda(bsr, x, y, h, edge_op=edge_op)
        torch.cuda.synchronize()
        assert (out[:-128] == 0).all()
        _close(out[-128:], fusedmm_bsr_plain(bsr, x, y, h,
                                             edge_op=edge_op)[-128:])
        del out


def test_sddmm_kernel_64bit_offsets(card):
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda, sddmm_bsr_plain
    bsr, x, y, _ = _big_bsr(card, 16)
    out = sddmm_bsr_cuda(bsr, x, y, scale_by_a=False)
    torch.cuda.synchronize()
    last = tsp.BSR(blk_row=bsr.blk_row[-129:] - 1023,
                   blk_col=bsr.blk_col[-129:], blocks=bsr.blocks[-129:],
                   nrows=128, ncols=bsr.ncols, br=128, bc=128,
                   n_real_blocks=129)
    _close(out[-129:], sddmm_bsr_plain(last, x[-128:], y, scale_by_a=False))
    _close(out[:129], sddmm_bsr_plain(
        tsp.BSR(blk_row=bsr.blk_row[:129], blk_col=bsr.blk_col[:129],
                blocks=bsr.blocks[:129], nrows=128, ncols=bsr.ncols, br=128,
                bc=128, n_real_blocks=129), x[:128], y, scale_by_a=False))


def test_edge_score_dispatch_counts_and_rejects(card):
    import dataclasses
    rng = np.random.default_rng(4)
    bsr = tsp.to_device(_bsr_case(rng, 128, 128, pad_blocks=0), card)
    x, y, h = (t.to(card) for t in _score_inputs(rng, 32, 64))
    tops.reset_kernel_launches()
    tops.sddmm_bsr(bsr, x, y)
    tops.fusedmm_bsr(bsr, x, y, h, edge_op="sigmoid")
    assert {k: v for k, v in tops.kernel_launches().items() if v} == {
        "sddmm_bsr": 1, "fusedmm_bsr": 1}
    with pytest.raises(ValueError, match="not built"):
        tops.fusedmm_bsr(dataclasses.replace(bsr, br=48), x, y, h)
    with pytest.raises(ValueError, match="not built"):
        tops.sddmm_bsr(dataclasses.replace(bsr, bc=96), x, y)
    with pytest.raises(ValueError, match="not built"):
        tops.fusedmm_bsr(dataclasses.replace(bsr, bc=64), x, y, h)
    with pytest.raises(ValueError, match="widths differ"):
        tops.sddmm_bsr(bsr, x, y[:, :16].contiguous())
    with pytest.raises(ValueError, match="rows"):
        tops.fusedmm_bsr(bsr, x, y, _h(rng, 400, 64).to(card))
    with pytest.raises(ValueError, match="contiguous fp32"):
        tops.fusedmm_bsr(bsr, x, y, h.double())
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((300, 4096), device=card)
        tops.sddmm_bsr(bsr, big, big[:280])
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        tops.fusedmm_bsr(bsr, x, y.cpu(), h)
    assert {k: v for k, v in tops.kernel_launches().items() if v} == {
        "sddmm_bsr": 1, "fusedmm_bsr": 1}


def test_patched_gat_step_matches_unpatched(card):
    """One gat training step on the card, patched (the fused kernel on
    layer 1 at K = 128, the trusted composition on layer 2, the recompute
    backward) against unpatched (unfused, plain autograd), from the same
    weights. Loss within rtol 1e-5, each gradient within 1e-4 of its
    largest element (fp32, another summation order)."""
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.core.patch import patched
    from repro_torch.data import make_dataset
    from repro_torch.models.gnn import build_bundle, make_gnn
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train.gnn import loss_and_grads

    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    bundle = build_bundle(ds, k_hint=128, arch="gat", plan=KernelPlan(
        kind="bsr", br=128, bc=128, fk=64)).to(card)
    init, apply = make_gnn("gat", ds.num_features, 128, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device=card)
    x, y, m = (t.to(card) for t in (ds.x, ds.y, ds.train_mask))
    tops.reset_kernel_launches()
    with patched(True):
        loss_t, g_t = loss_and_grads(apply, params, bundle, x, y, m)
    launches = tops.kernel_launches()
    with patched(False):
        loss_b, g_b = loss_and_grads(apply, params, bundle, x, y, m)
    torch.cuda.synchronize()
    assert launches["fusedmm_bsr"] == 1
    np.testing.assert_allclose(float(loss_t), float(loss_b), rtol=1e-5)

    def close(a, b):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-4 * float(b.abs().max()) + 1e-12,
                                   rtol=0)
    tree_map(close, g_t, g_b)


# --------------------------------------------------------------------------
# LM kernels: ragged GEMM and flash attention
#
# fp32: the kernels against their plain versions within 1e-5 x the largest
# plain value (fp32 sums of up to 6,400 terms in another order: the
# difference grows like sqrt(D) eps max|term|, ~1e-7 of the largest value
# here). bf16: within 2^-7 x the largest plain value, two bf16 ulps at the
# largest magnitude: both round an fp32 result to bf16 once, the flash
# kernel scales the fp32 product where the plain version scales q in bf16.
# --------------------------------------------------------------------------

def _lm_tol(dtype, want):
    scale = float(want.float().abs().max())
    return (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale


def _close_lm(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert err <= _lm_tol(dtype, want), (err, _lm_tol(dtype, want))


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,t,d,f,order", [
    (16, 2048, 4096, 6400, "arange"),      # phi3.5-moe gate / up, decode
    (16, 2048, 6400, 4096, "arange"),      # down
    (4, 512, 100, 72, "mixed"),            # D, F not multiples of 8
    (3, 640, 256, 200, "mixed")])          # ragged last column tile
def test_ragged_gemm_kernel_matches_plain(card, dtype, e, t, d, f, order):
    from repro_torch.kernels.ragged_gemm import (ragged_gemm_cuda,
                                                 ragged_gemm_plain)
    rng = np.random.default_rng(t + d + f)
    x = _randn(rng, (t, d), dtype, card)
    w = _randn(rng, (e, d, f), dtype, card)
    n = t // 128
    te = (np.arange(n) * e // n if order == "arange"
          else rng.permutation(np.arange(n) % e))      # non-monotone
    te = torch.from_numpy(te.astype(np.int32)).to(card)
    got = ragged_gemm_cuda(x, w, te)
    want = ragged_gemm_plain(x, w, te)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (t, f)
    _close_lm(got, want, dtype)


def test_ragged_gemm_dispatch_counts_and_rejects(card):
    rng = np.random.default_rng(5)
    x = _randn(rng, (256, 64), torch.bfloat16, card)
    w = _randn(rng, (2, 64, 32), torch.bfloat16, card)
    te = torch.tensor([1, 0], dtype=torch.int32, device=card)
    tops.reset_kernel_launches()
    tops.ragged_gemm(x, w, te)
    assert {k: v for k, v in tops.kernel_launches().items() if v} == {
        "ragged_gemm": 1}
    with pytest.raises(ValueError, match="not a multiple of tm"):
        tops.ragged_gemm(x[:200], w, te[:1])
    with pytest.raises(ValueError, match="one expert per 128-row tile"):
        tops.ragged_gemm(x, w, te[:1])
    with pytest.raises(ValueError, match="both be bf16 or fp32"):
        tops.ragged_gemm(x, w.float(), te)
    with pytest.raises(ValueError, match="int32"):
        tops.ragged_gemm(x, w, te.long())
    with pytest.raises(ValueError, match="multiple of the kernel's"):
        tops.ragged_gemm(x, w, te.repeat_interleave(2), tm=64)
    assert tops.kernel_launches()["ragged_gemm"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,window", [
    (1, 32, 8, 1024, 1024, 128, True, None),    # phi3.5-moe heads
    (2, 4, 1, 200, 333, 64, True, 100),         # ragged S < T, window
    (1, 4, 2, 77, 256, 32, True, None),         # S < T, ragged q tile
    (1, 4, 4, 130, 130, 32, False, None),       # not causal
    (1, 8, 2, 300, 300, 128, False, 64),        # window, not causal
    (1, 8, 8, 300, 300, 128, True, 64),         # sliding window
    (2, 4, 1, 200, 200, 32, True, None),        # S % 128 != 0, rep 4
    (1, 4, 4, 333, 400, 64, True, None),        # S % 128 != 0, rep 1
    (1, 8, 2, 129, 129, 64, False, None),       # one row past a q tile
    (2, 2, 2, 70, 150, 32, True, 50),           # rep 1, window
    (1, 16, 16, 512, 512, 256, True, None),     # gemma-7b's heads of 256
    (1, 4, 2, 200, 333, 256, True, 100)])       # D 256, S < T, window
def test_flash_attention_kernel_matches_plain(card, dtype, b, hq, hkv, s, t,
                                              d, causal, window):
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    rng = np.random.default_rng(s + t + d)
    q = _randn(rng, (b, hq, s, d), dtype, card)
    k = _randn(rng, (b, hkv, t, d), dtype, card)
    v = _randn(rng, (b, hkv, t, d), dtype, card)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close_lm(got, want, dtype)


def test_flash_attention_dispatch_counts_and_rejects(card):
    rng = np.random.default_rng(6)
    q = _randn(rng, (1, 4, 64, 32), torch.bfloat16, card)
    k = _randn(rng, (1, 2, 96, 32), torch.bfloat16, card)
    tops.reset_kernel_launches()
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)  # the model's
    out = tops.flash_attention(strided, k, k, window=16)
    assert out.shape == q.shape
    assert {n: c for n, c in tops.kernel_launches().items() if c} == {
        "flash_attention": 1}
    with pytest.raises(ValueError, match="exceed"):
        tops.flash_attention(k.repeat(1, 2, 1, 1), q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="not built"):
        tops.flash_attention(q[..., :16], k[..., :16], k[..., :16])
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tops.flash_attention(q[:, :3], k, k)
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_attention(q.float(), k, k)
    assert tops.kernel_launches()["flash_attention"] == 1


def test_lm_serving_on_card_matches_cpu(card):
    """phi3.5-moe's smoke config in fp32: prefill + 4 decode steps on the
    card (both kernels) against the port's CPU run (plain versions), from
    the same weights and tokens; logits and caches within atol 1e-4 (the
    residual stream reaches ~10^2, where fp32 sums in another order move
    the last digits)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    on_card = _tree_to(params, card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    nxt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 4)).astype(np.int32))
    tops.reset_kernel_launches()
    cache_c, logits_c = lm.prefill(cfg, on_card, {"tokens": toks.to(card)},
                                   48)
    assert {n: c for n, c in tops.kernel_launches().items() if c} == {
        "flash_attention": 2, "ragged_gemm": 6}
    cache, logits = lm.prefill(cfg, params, {"tokens": toks}, 48)
    for i in range(5):
        np.testing.assert_allclose(logits_c.cpu().numpy(), logits.numpy(),
                                   atol=1e-4, rtol=0)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache_c[key].cpu().numpy(),
                                       cache[key].numpy(), atol=1e-4, rtol=0)
        if i == 4:
            break
        step = nxt[:, i:i + 1]
        logits_c, cache_c = lm.decode_step(cfg, on_card, cache_c,
                                           step.to(card))
        logits, cache = lm.decode_step(cfg, params, cache, step)
    assert tops.kernel_launches()["ragged_gemm"] == 6 + 4 * 6


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# the redesigned kernels: the ragged GEMM's instances (wgmma for bf16
# operands TMA can stride, wmma for other bf16 shapes) and the scaled
# SDDMM's per-nonzero kernel
# --------------------------------------------------------------------------

def _ragged_inputs(rng, e, t, d, f, order, dtype=torch.bfloat16, card="cuda",
                   offset=0):
    """x (t, d) starting ``offset`` elements into its storage (offset 1:
    2-byte aligned), w (e, d, f), tile_expert in expert order or a
    permutation (non-monotone)."""
    x = _randn(rng, (t * d + offset,), dtype, card)[offset:].view(t, d)
    w = _randn(rng, (e, d, f), dtype, card)
    n = t // 128
    te = (np.arange(n) * e // n if order == "arange"
          else rng.permutation(np.arange(n) % e))
    return x, w, torch.from_numpy(te.astype(np.int32)).to(card)


def _ragged_oracle_rows(got, x, w, te):
    """Row by row against the same product in fp32, one expert's tiles at
    a time: each output row's max |diff| within 2^-7 x that row's max
    |oracle| (a fault in rows of small magnitude shows here)."""
    t, d = x.shape
    xt = x.view(-1, 128, d)
    oracle = torch.empty((t // 128, 128, w.shape[2]), device=x.device)
    tec = te.cpu()
    for e in tec.unique().tolist():
        idx = (tec == e).nonzero()[:, 0].to(x.device)
        oracle[idx] = xt[idx].float() @ w[e].float()
    oracle = oracle.view(t, -1)
    row_err = (got.float() - oracle).abs().amax(-1)
    row_max = oracle.abs().amax(-1).clamp(min=1e-30)
    assert float((row_err / row_max).max()) <= 2.0 ** -7


@pytest.mark.parametrize("e,t,d,f,order,offset,instance", [
    (16, 20480, 4096, 6400, "arange", 0, "wgmma"),   # prefill gate / up
    (16, 20480, 6400, 4096, "arange", 0, "wgmma"),   # prefill down
    (8, 2048, 512, 1024, "mixed", 0, "wgmma"),       # non-monotone experts
    (5, 1280, 512, 6408, "mixed", 0, "wgmma"),       # F = 6,400 + 8
    (3, 640, 256, 200, "mixed", 0, "wgmma"),         # one ragged F tile
    (4, 512, 100, 72, "mixed", 0, "wmma"),           # D % 8 != 0
    (3, 640, 256, 200, "mixed", 1, "wmma")])         # x 2-byte aligned
def test_ragged_gemm_instances_match_plain_and_oracle(
        card, e, t, d, f, order, offset, instance):
    from repro_torch.kernels.ragged_gemm import (ragged_gemm_cuda,
                                                 ragged_gemm_plain)
    rng = np.random.default_rng(t + d + f + offset)
    x, w, te = _ragged_inputs(rng, e, t, d, f, order, card=card,
                              offset=offset)
    tops.reset_kernel_launches()
    got = ragged_gemm_cuda(x, w, te)
    assert ragged_gemm_cuda.launches_by_instance == {
        "wgmma": 0, "wmma": 0, "f32": 0, instance: 1}
    want = ragged_gemm_plain(x, w, te)
    torch.cuda.synchronize()
    assert got.shape == (t, f) and bool(torch.isfinite(got).all())
    _close_lm(got, want, torch.bfloat16)
    _ragged_oracle_rows(got, x, w, te)


def test_ragged_gemm_wgmma_is_bitwise_repeatable(card):
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    rng = np.random.default_rng(11)
    x, w, te = _ragged_inputs(rng, 16, 2048, 4096, 6400, "arange", card=card)
    first = ragged_gemm_cuda(x, w, te)
    assert torch.equal(first, ragged_gemm_cuda(x, w, te))


def _sddmm_bound_ratio(out, bsr, x, y):
    """max |kernel - plain| / (2 (D + 1) eps sum_d |x_d y_d| |a|) over
    all positions: two fp32 sums of the same D products in other orders,
    and the product with A."""
    import dataclasses
    from repro_torch.kernels.sddmm import sddmm_bsr_plain
    d = x.shape[1]
    want = sddmm_bsr_plain(bsr, x, y)
    mag = sddmm_bsr_plain(dataclasses.replace(bsr, blocks=bsr.blocks.abs()),
                          x.abs(), y.abs())
    bound = 2 * (d + 1) * 2.0 ** -24 * mag + 1e-30
    return float(((out - want).abs() / bound).max())


@pytest.mark.parametrize("br,bc", [(32, 128), (128, 128), (128, 256)])
@pytest.mark.parametrize("d", [16, 130, 256])
def test_sddmm_scaled_kernel_within_bound(card, br, bc, d):
    """Empty block rows (rows 128..255 have no entry), three padding
    blocks, x and y shorter than nrows and ncols: within the bound, zero
    wherever A is zero, the per-nonzero instance counted."""
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda
    rng = np.random.default_rng(br + bc + d)
    bsr = tsp.to_device(_bsr_case(rng, br, bc, pad_blocks=3), card)
    x, y = (t.to(card) for t in _score_inputs(rng, d))
    tops.reset_kernel_launches()
    out = sddmm_bsr_cuda(bsr, x, y, scale_by_a=True)
    torch.cuda.synchronize()
    assert sddmm_bsr_cuda.launches_by_instance == {"nnz": 1, "tile": 0}
    assert _sddmm_bound_ratio(out, bsr, x, y) <= 1.0
    assert bool((out[bsr.blocks == 0] == 0).all())


def _fill_bsr(card, fills, bc, seed):
    """One block row of 128-row tiles, tile b at fill fills[b] (the
    per-nonzero route below 1 / DENSE_DIV of a slice, the dense tile
    products above)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    n = len(fills)
    blocks = torch.randn((n, 128, bc), generator=gen, device=card)
    keep = torch.rand((n, 128, bc), generator=gen, device=card)
    blocks *= keep < torch.tensor(fills, device=card)[:, None, None]
    return tsp.BSR(blk_row=torch.zeros(n, dtype=torch.int32, device=card),
                   blk_col=torch.arange(n, dtype=torch.int32, device=card),
                   blocks=blocks, nrows=128, ncols=n * bc, br=128, bc=bc,
                   n_real_blocks=n)


@pytest.mark.parametrize("bc", [128, 256])
def test_sddmm_scaled_kernel_dense_and_sparse_tiles(card, bc):
    """Tiles at 0.7 %, 5 %, 50 % and 100 % fill in one block row: both
    routes within the bound, zero where A is zero, and bitwise equal
    across two launches."""
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda
    bsr = _fill_bsr(card, (0.007, 0.05, 0.5, 1.0), bc, seed=bc)
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((100, 256), generator=gen, device=card) / 16
    y = torch.randn((bsr.ncols - 3, 256), generator=gen, device=card)
    out = sddmm_bsr_cuda(bsr, x, y)
    torch.cuda.synchronize()
    assert _sddmm_bound_ratio(out, bsr, x, y) <= 1.0
    assert bool((out[bsr.blocks == 0] == 0).all())
    assert torch.equal(out, sddmm_bsr_cuda(bsr, x, y))


def test_sddmm_scaled_kernel_is_bitwise_repeatable(card):
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda
    rng = np.random.default_rng(12)
    bsr = tsp.to_device(_bsr_case(rng, 128, 128, pad_blocks=3), card)
    x, y = (t.to(card) for t in _score_inputs(rng, 256))
    first = sddmm_bsr_cuda(bsr, x, y)
    assert torch.equal(first, sddmm_bsr_cuda(bsr, x, y))


def test_sddmm_scaled_kernel_64bit_offsets(card):
    """The 8.7 GB tile array past 2^31 elements, scaled: the last block
    row's tiles (all past the 2^31 offset, 1 % filled) within the bound,
    every other tile zero."""
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda
    bsr, x, y, _ = _big_bsr(card, 16)
    out = sddmm_bsr_cuda(bsr, x, y, scale_by_a=True)
    torch.cuda.synchronize()
    assert bool((out[:-129] == 0).all())
    last = tsp.BSR(blk_row=bsr.blk_row[-129:] - 1023,
                   blk_col=bsr.blk_col[-129:], blocks=bsr.blocks[-129:],
                   nrows=128, ncols=bsr.ncols, br=128, bc=128,
                   n_real_blocks=129)
    assert _sddmm_bound_ratio(out[-129:], last, x[-128:], y) <= 1.0


def test_sddmm_scaled_kernel_writes_zero_where_a_is_zero(card):
    """The stated difference from the plain version: where A is 0 and
    x_i . y_j is not finite the kernel writes 0, the plain version
    s * 0 = NaN; where A is not 0 both are non-finite, and everywhere
    else they agree within the bound."""
    from repro_torch.kernels.sddmm import sddmm_bsr_cuda, sddmm_bsr_plain
    for fill in (0.01, 0.5):                 # both routes
        bsr = _fill_bsr(card, (fill,), 128, seed=3)
        bsr.blocks[0, 7, 5] = 2.0
        bsr.blocks[0, 9, 5] = 0.0
        x = torch.ones((128, 8), device=card)
        y = torch.ones((128, 8), device=card)
        y[5] = torch.inf
        out = sddmm_bsr_cuda(bsr, x, y)
        plain = sddmm_bsr_plain(bsr, x, y)
        torch.cuda.synchronize()
        zero = bsr.blocks[0, :, 5] == 0
        assert bool(torch.isnan(plain[0, :, 5][zero]).all())
        assert bool((out[0, :, 5][zero] == 0).all())
        assert bool(torch.isinf(out[0, :, 5][~zero]).all())
        finite = torch.isfinite(plain)
        assert torch.equal(out[finite], plain[finite])


# --------------------------------------------------------------------------
# SELL on skewed rows (csrc/sell_spmm.cu: long slices split across warps)
#
# Held against the plain version within the per-row bound chip_smoke.py
# holds every SELL launch to: 2 d eps sum|terms|, d the row's real slots
# (two fp32 sums of the same d terms in other orders).
# --------------------------------------------------------------------------

def _sell_bound_ratio(sell, h, out):
    import dataclasses
    want = sell_spmm_plain(sell, h)
    mag = sell_spmm_plain(dataclasses.replace(sell, val=sell.val.abs()),
                          h.abs())
    real = (sell.idx < sell.ncols).to(torch.int32)
    per = torch.zeros((sell.nslices, sell.c), dtype=torch.int32,
                      device=h.device)
    per.index_add_(0, sell.slice_of.long(), real)
    d = per.reshape(-1)[sell.inv_perm.long()].float()[:, None]
    return float(((out - want).abs() / (2 * 2.0 ** -24 * d * mag + 1e-30))
                 .max())


def _hub_sell(c, chunk, seed, pad=0):
    """Groups of 32 rows (so every C <= 32 packs them into slices of their
    own): a hub of 4 S + 500 entries beside 31 rows of 3 S, then 32 rows
    of exactly 2 S, 32 of S + 1, 32 of S, 200 short rows and 30 empty
    ones; ``pad`` sentinel steps appended to the last slice. Returns the
    operand, its column count and its empty rows."""
    from repro_torch.sampling.blocks import _pad_sell_steps
    rng = np.random.default_rng(seed)
    m = 4 * chunk + 600
    deg = np.concatenate([[4 * chunk + 500], np.full(31, 3 * chunk),
                          np.full(32, 2 * chunk), np.full(32, chunk + 1),
                          np.full(32, chunk), rng.integers(1, 40, 200),
                          np.zeros(30, np.int64)])
    perm = rng.permutation(deg.size)
    rows = np.repeat(perm, deg)
    cols = np.concatenate([rng.choice(m, d, replace=False) for d in deg])
    coo = tsp.coo_from_edges(cols, rows, rng.standard_normal(rows.size)
                             .astype(np.float32), deg.size, m)
    sell = tsp.sell_from_coo(coo, c=c)
    return (_pad_sell_steps(sell, sell.n_steps + pad), m,
            torch.from_numpy(perm[deg == 0]))


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("k", [602, 256])
def test_sell_split_route_on_hub_rows(card, c, k):
    """At the wrapper's own S: the hub row past 4 S, slices of exactly 2 S
    and S + 1 steps, padded steps and degree-0 rows; the split route
    counted, the workspace logged, two launches bitwise equal."""
    from repro_torch.kernels.sell_spmm import (CHUNK_STEPS,
                                               sell_workspace_bytes,
                                               split_chunks)
    sell, m, empty = _hub_sell(c, CHUNK_STEPS, seed=c + k, pad=333)
    a = tsp.to_device(sell, card)
    h = _h(np.random.default_rng(k), m, k).to(card)
    tops.reset_kernel_launches()
    out = tops.sell_spmm(a, h)
    torch.cuda.synchronize()
    assert sell_spmm_cuda.launches_by_instance == {"row": 0, "split": 1}
    assert sell_spmm_cuda.workspace_bytes == sell_workspace_bytes(
        a.n_steps, c, k)
    assert split_chunks(a) >= 5 + 2 + 2
    assert _sell_bound_ratio(a, h, out) <= 1.0
    assert bool((out[empty.to(card)] == 0).all())
    assert torch.equal(out, sell_spmm_cuda(a, h))


@pytest.mark.parametrize("c", [8, 16, 32, 48])
@pytest.mark.parametrize("chunk", [1, 64, 96, 128])
@pytest.mark.parametrize("k", [602, 256, 7])
def test_sell_split_route_small_chunks(card, c, chunk, k):
    """Small S, so that most slices split, including exact multiples of S
    and S + 1; C = 48 spans two CTAs a slice."""
    from repro_torch.kernels.sell_spmm import sell_route
    sell, m, empty = _hub_sell(c, 64, seed=chunk + c, pad=chunk + 5)
    a = tsp.to_device(sell, card)
    h = _h(np.random.default_rng(chunk), m, k).to(card)
    out = sell_spmm_cuda(a, h, chunk=chunk)
    torch.cuda.synchronize()
    assert sell_route(a.n_steps, chunk) == "split"
    assert _sell_bound_ratio(a, h, out) <= 1.0
    assert bool((out[empty.to(card)] == 0).all())
    assert torch.equal(out, sell_spmm_cuda(a, h, chunk=chunk))


def test_sell_row_route_when_no_slice_can_split(card):
    """An operand of at most S steps takes the row route (one kernel,
    no workspace) and agrees with the split route of a small S bitwise
    where no slice is split, within the bound where one is."""
    rng = np.random.default_rng(9)
    sell = tsp.sell_from_coo(_coo(rng, 90, 60, 500), c=8)
    a = tsp.to_device(sell, card)
    h = _h(rng, 60, 256).to(card)
    tops.reset_kernel_launches()
    out = sell_spmm_cuda(a, h)
    assert sell_spmm_cuda.launches_by_instance == {"row": 1, "split": 0}
    assert sell_spmm_cuda.workspace_bytes == 0
    same = sell_spmm_cuda(a, h, chunk=a.n_steps - 1)
    torch.cuda.synchronize()
    assert sell_spmm_cuda.launches_by_instance == {"row": 1, "split": 1}
    assert torch.equal(out, same)
    assert _sell_bound_ratio(a, h, sell_spmm_cuda(a, h, chunk=2)) <= 1.0


# --------------------------------------------------------------------------
# FusedMM per edge (csrc/fusedmm.cu: the edge route over streamed tiles,
# dense slices through the tile products), at check_fused's tolerance:
# atol 1e-4 x max|h| for softmax, 1e-4 x max|plain| for sigmoid and none
# --------------------------------------------------------------------------

def _fused_err_ratio(out, want, h, edge_op):
    scale = (h if edge_op == "softmax" else want).abs().max()
    return float((out - want).abs().max() / (1e-4 * scale + 1e-30))


def _fused_fill_case(card, bc, fills, seed, rows_empty=True):
    """Two block rows of 128-row tiles: block row 0 holds one tile a fill
    in ``fills``, block row 1 is empty (its one zero tile) when
    ``rows_empty``; two padding blocks after it."""
    gen = torch.Generator(device=card).manual_seed(seed)
    n = len(fills)
    blocks = torch.randn((n + 3, 128, bc), generator=gen, device=card)
    keep = torch.rand((n + 3, 128, bc), generator=gen, device=card)
    cut = torch.tensor(list(fills) + [0.0, 0.0, 0.0], device=card)
    blocks *= keep < cut[:, None, None]
    blk_row = torch.tensor([0] * n + [1, 1, 1], dtype=torch.int32,
                           device=card)
    blk_col = torch.tensor(list(range(n)) + [0, 0, 0], dtype=torch.int32,
                           device=card)
    return tsp.BSR(blk_row=blk_row, blk_col=blk_col, blocks=blocks,
                   nrows=256, ncols=n * bc, br=128, bc=bc, n_real_blocks=n + 1)


@pytest.mark.parametrize("bc", [128, 256])
@pytest.mark.parametrize("k", [256, 512])
@pytest.mark.parametrize("edge_op", ["softmax", "sigmoid", "none"])
def test_fusedmm_edge_and_tile_routes(card, bc, k, edge_op):
    """Tiles at 0.7 %, 5 %, 50 % and 100 % fill in one block row (the
    first two on the edge route, the others on the tile route), an empty
    block row (it stores 0) and padding blocks, x and y short of the
    operand; tiles counted by route; two launches bitwise equal."""
    from repro_torch.kernels.fusedmm import (fusedmm_bsr_cuda,
                                             fusedmm_bsr_plain,
                                             tiles_by_route)
    a = _fused_fill_case(card, bc, (0.007, 0.05, 0.5, 1.0), seed=bc + k)
    gen = torch.Generator(device=card).manual_seed(k)
    d = 256
    x = torch.randn((200, d), generator=gen, device=card) / 16
    y = torch.randn((a.ncols - 5, d), generator=gen, device=card)
    h = torch.randn((a.ncols - 5, k), generator=gen, device=card)
    tops.reset_kernel_launches()
    out = fusedmm_bsr_cuda(a, x, y, h, edge_op=edge_op)
    torch.cuda.synchronize()
    assert fusedmm_bsr_cuda.launches_by_instance == {"edge": 1}
    # 4 slices of each of the 4 tiles, 4 of the empty row's zero tile and
    # of the padding blocks
    assert tiles_by_route() == {"edge": 8 + 12, "tile": 8}
    want = fusedmm_bsr_plain(a, x, y, h, edge_op=edge_op)
    assert _fused_err_ratio(out, want, h, edge_op) <= 1.0
    assert bool((out[128:] == 0).all())
    assert torch.equal(out, fusedmm_bsr_cuda(a, x, y, h, edge_op=edge_op))


def test_fusedmm_softmax_row_without_entries_stores_zero(card):
    """A row whose every tile entry is 0 (and a row with one entry, where
    the softmax weight is 1) on the edge route."""
    from repro_torch.kernels.fusedmm import (fusedmm_bsr_cuda,
                                             fusedmm_bsr_plain,
                                             tiles_by_route)
    a = _fused_fill_case(card, 128, (0.01, 0.01), seed=4)
    a.blocks[:, 5] = 0.0
    a.blocks[:, 6] = 0.0
    a.blocks[1, 6, 17] = 3.0
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((256, 64), generator=gen, device=card)
    y = torch.randn((256, 64), generator=gen, device=card)
    h = torch.randn((256, 130), generator=gen, device=card)
    tops.reset_kernel_launches()
    out = fusedmm_bsr_cuda(a, x, y, h)
    torch.cuda.synchronize()
    assert tiles_by_route()["tile"] == 0
    assert bool((out[5] == 0).all())
    torch.testing.assert_close(out[6], h[128 + 17], rtol=1e-6, atol=1e-6)
    want = fusedmm_bsr_plain(a, x, y, h)
    assert _fused_err_ratio(out, want, h, "softmax") <= 1.0


@pytest.mark.parametrize("edge_op", ["softmax", "none"])
def test_fusedmm_edge_route_is_bitwise_repeatable(card, edge_op):
    from repro_torch.kernels.fusedmm import fusedmm_bsr_cuda, tiles_by_route
    rng = np.random.default_rng(12)
    bsr = tsp.to_device(_bsr_case(rng, 128, 128, pad_blocks=3), card)
    x, y, h = (t.to(card) for t in _score_inputs(rng, 256, 256))
    tops.reset_kernel_launches()
    first = fusedmm_bsr_cuda(bsr, x, y, h, edge_op=edge_op)
    assert torch.equal(first, fusedmm_bsr_cuda(bsr, x, y, h,
                                               edge_op=edge_op))
    assert tiles_by_route()["edge"] > 0


# --------------------------------------------------------------------------
# the fused sampling hop and the warp-per-row draw (csrc/sample.cu),
# bitwise; the ordered segment sum (csrc/segment_sum.cu); bitwise
# repeatable training steps
# --------------------------------------------------------------------------

def _hop_graph(rng, width, n=400, hub=None):
    """A sentinel-extended CSR with rows of degree 0, 1, width, width + 1,
    larger ones and optionally a hub row (row 7)."""
    deg = rng.integers(0, 3 * width + 4, n).astype(np.int64)
    deg[:8] = [0, 1, width, width + 1, 3 * width + 2, 700, 0,
               hub if hub is not None else 5]
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nse = int(indptr[-1])
    indices = np.concatenate([rng.integers(0, n, nse), [n]]).astype(np.int32)
    val = np.concatenate([rng.standard_normal(nse), [0.0]]).astype(np.float32)
    frontier = np.concatenate([np.arange(8), rng.integers(0, n, 2990),
                               [n, n]]).astype(np.int32)
    return [torch.from_numpy(a) for a in (indptr, indices, val, frontier)]


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("width", [1, 10, 25, 32, 33, 64])
@pytest.mark.parametrize("rnd", [0, -1])
def test_sample_hop_kernel_matches_plain(card, replace, width, rnd):
    from repro_torch.kernels import sample as ks
    rng = np.random.default_rng(width + 7 * int(replace))
    args = _hop_graph(rng, width, hub=18_045)
    kw = dict(width=width, fanout=width, seed=5, hop=1, replace=replace)
    tops.reset_kernel_launches()
    got = ks.sample_hop(*(a.to(card) for a in args), rnd, **kw)
    torch.cuda.synchronize()
    assert tops.kernel_launches()["sample_hop"] == 1
    assert sum(tops.kernel_launches().values()) == 1
    want = ks.sample_hop_plain(*args, rnd, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_sample_hop_kernel_full_neighbourhood_and_empty_frontier(card):
    from repro_torch.kernels import sample as ks
    rng = np.random.default_rng(3)
    args = _hop_graph(rng, 4, n=300, hub=18_045)
    width = int(torch.diff(args[0]).max())
    kw = dict(width=width, fanout=None, seed=0, hop=0, replace=False)
    got = ks.sample_hop(*(a.to(card) for a in args), 9, **kw)
    want = ks.sample_hop_plain(*args, 9, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    tops.reset_kernel_launches()
    empty = ks.sample_hop(*(a.to(card) for a in args[:3]),
                          torch.zeros(0, dtype=torch.int32, device=card), 9,
                          width=10, fanout=10, seed=0, hop=0)
    assert [tuple(t.shape) for t in empty] == [(0, 10)] * 3
    assert tops.kernel_launches()["sample_hop"] == 0
    with pytest.raises(ValueError, match="contiguous"):
        ks.sample_hop_cuda(args[0].to(card), args[1].to(card),
                           args[2].double().to(card), args[3].to(card), 0,
                           width=10, fanout=10, seed=0, hop=0, replace=False)


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("width", [10, 25, 32, 33, 300])
def test_segment_sample_warp_kernel_matches_plain(card, replace, width):
    """The standalone kernel draws through the same warp routine as the
    fused hop: a row's keys drawn at once, vals chained by ballots."""
    from repro_torch.kernels import sample as ks
    rng = np.random.default_rng(11 * width + int(replace))
    f = 2000
    deg = rng.integers(0, 4 * width + 2, f).astype(np.int32)
    deg[:4] = [0, width, width + 1, 18_045]
    gid = rng.integers(0, 1 << 30, f).astype(np.int32)
    d, g = torch.from_numpy(deg), torch.from_numpy(gid)
    kw = dict(width=width, seed=1, hop=0, replace=replace)
    got = ks.segment_sample_cuda(d.to(card), g.to(card), 77, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ks.segment_sample_plain(d, g, 77, **kw))


def _sum_case(rng, n_t=500, n_src=300, k=16, hub=20_000):
    """Sorted targets with a hub (many pieces) and empty targets."""
    t = np.sort(np.concatenate([rng.integers(0, n_t, 6000),
                                np.full(hub, 17)]))
    t = t[(t < 40) | (t > 60)]                        # targets without slots
    offsets = torch.from_numpy(np.searchsorted(t, np.arange(n_t + 1))
                               .astype(np.int64))
    n = t.shape[0]
    index = torch.from_numpy(rng.integers(-1, n_src + 1, n).astype(np.int32))
    weight = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    src = torch.from_numpy(rng.standard_normal((n_src, k)).astype(np.float32))
    return src, offsets, index, weight, torch.from_numpy(t)


@pytest.mark.parametrize("k", [1, 7, 16, 256, 602])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("accumulate", [False, True])
def test_segment_sum_kernel_matches_plain_and_repeats_bitwise(
        card, k, weighted, accumulate):
    from repro_torch.kernels.segment_sum import (segment_sum_sorted,
                                                 segment_sum_sorted_plain)
    rng = np.random.default_rng(k + 3 * weighted + 7 * accumulate)
    src, offsets, index, weight, tgt = _sum_case(rng, k=k)
    weight = weight if weighted else None
    out0 = torch.from_numpy(rng.standard_normal((500, k)).astype(np.float32))
    dev = [t.to(card) if t is not None else None
           for t in (src, offsets, index, weight)]
    runs = []
    tops.reset_kernel_launches()
    for _ in range(2):
        out = out0.to(card) if accumulate else None
        runs.append(segment_sum_sorted(dev[0], dev[1], index=dev[2],
                                       weight=dev[3], out=out))
    torch.cuda.synchronize()
    assert tops.kernel_launches()["segment_sum"] == 2
    assert torch.equal(runs[0], runs[1])
    want = segment_sum_sorted_plain(src, offsets, index=index, weight=weight,
                                    out=out0.clone() if accumulate else None)
    ok = (index >= 0) & (index < src.shape[0])
    w = weight if weighted else torch.ones(index.shape[0])
    mag = out0.abs() if accumulate else torch.zeros((500, k))
    mag.index_add_(0, tgt[ok].long(),
                   (w[ok][:, None] * src[index[ok].long()]).abs())
    d = torch.bincount(tgt[ok].long(), minlength=500).float()[:, None] + 1
    err = (runs[0].cpu() - want).abs()
    assert (err <= 2 * EPS32 * d * mag + 1e-30).all(), float(err.max())
    # targets without slots: 0, or their row untouched when accumulating
    empty = (torch.diff(offsets) == 0)
    assert torch.equal(runs[0].cpu()[empty],
                       out0[empty] if accumulate else
                       torch.zeros_like(out0[empty]))


def test_segment_sum_dispatch_counts_and_rejects(card):
    from repro_torch.kernels.segment_sum import (segment_sum_sorted,
                                                 segment_sum_sorted_cuda)
    src = torch.ones((4, 8), device=card)
    offsets = torch.tensor([0, 2, 4], device=card)
    index = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=card)
    tops.reset_kernel_launches()
    out = segment_sum_sorted(src, offsets, index=index)
    assert torch.equal(out.cpu(), torch.full((2, 8), 2.0))
    assert tops.kernel_launches()["segment_sum"] == 1
    with pytest.raises(ValueError, match="fp32"):
        segment_sum_sorted_cuda(src.double(), offsets, index=index)
    with pytest.raises(ValueError, match="int32"):
        segment_sum_sorted_cuda(src, offsets, index=index.long())
    with pytest.raises(ValueError, match="int64"):
        segment_sum_sorted_cuda(src, offsets.int(), index=index)
    with pytest.raises(ValueError, match="on cuda"):
        segment_sum_sorted_cuda(src, offsets, index=index.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_sorted_cuda(src.cpu(), offsets.cpu())
    with pytest.raises(ValueError, match="match"):
        segment_sum_sorted_cuda(src, offsets, index=index,
                                weight=torch.ones(3, device=card))
    with pytest.raises(ValueError, match=r"\(2, 8\)"):
        segment_sum_sorted_cuda(src, offsets, index=index,
                                out=torch.zeros((3, 8), device=card))
    assert tops.kernel_launches()["segment_sum"] == 1


def test_minibatch_training_is_bitwise_repeatable(card):
    """``train_gnn_minibatch`` with the device sampler, 3 steps, twice
    from the same weights: the same losses and parameters bit for bit
    (the block backward is the ordered segment sum, no atomics)."""
    from repro_torch.data import make_dataset
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import gnn_minibatch as mb

    ds = make_dataset("reddit", scale=1 / 64, seed=1)
    n_train = int(ds.train_mask.sum())
    batch = -(-n_train // 3)
    init, _, _, _ = mb.make_block_model("sage-mean", ds.num_features, 64,
                                        ds.num_classes, 2)
    params = init(torch.Generator().manual_seed(0), device=card)
    runs = []
    for _ in range(2):
        tops.reset_kernel_launches()
        res = mb.train_gnn_minibatch(
            "sage-mean", ds, fanouts=(10, 25), batch_size=batch, hidden=64,
            epochs=1, sampler="device", params=params, device=card)
        runs.append((res, tops.kernel_launches()))
    (a, la), (b, lb) = runs
    assert a.steps_per_epoch == 3 and la == lb
    assert la["segment_sum"] >= 3 and la["sample_hop"] >= 6, la
    assert a.losses == b.losses
    same = []
    tree_map(lambda x, y: same.append(torch.equal(x, y)), a.final_params,
             b.final_params)
    assert same and all(same)


@pytest.mark.parametrize("arch", ["gat", "sage-max"])
def test_full_graph_step_gradients_are_bitwise_repeatable(card, arch):
    """One patched full-graph step twice from the same weights: every
    gradient bit for bit (gat: the FusedMM recompute backward and the
    trusted layer 2; sage-max: the max subgradient)."""
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.core.patch import patched
    from repro_torch.data import make_dataset
    from repro_torch.models.gnn import build_bundle, make_gnn
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train.gnn import loss_and_grads

    ds = make_dataset("reddit", scale=1 / 128, seed=1)
    plan = KernelPlan(kind="bsr", br=128, bc=128, fk=64) \
        if arch == "gat" else None
    bundle = build_bundle(ds, k_hint=128, arch=arch, plan=plan).to(card)
    init, apply = make_gnn(arch, ds.num_features, 128, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device=card)
    x, y, m = (t.to(card) for t in (ds.x, ds.y, ds.train_mask))
    runs = []
    for _ in range(2):
        tops.reset_kernel_launches()
        with patched(True):
            runs.append(loss_and_grads(apply, params, bundle, x, y, m))
        assert tops.kernel_launches()["segment_sum"] > 0
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb)
    same = []
    tree_map(lambda p, q: same.append(torch.equal(p, q)), ga, gb)
    assert same and all(same)


# --------------------------------------------------------------------------
# measured tuning on the card
# --------------------------------------------------------------------------

def test_measured_timer_leaves_the_first_call_out_of_its_window(card):
    """The untimed first call of ``_time_callable`` (the one that builds
    a kernel) never lands in the CUDA-event window: a callable whose
    first call takes 0.5 s reads as the fast calls after it."""
    import importlib
    import time
    tat = importlib.import_module("repro_torch.core.autotune")
    calls = []
    h = torch.zeros(1024, device=card)

    def fn(x):
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.5)
        return x + 1
    t = tat._time_callable(fn, h)
    assert len(calls) == 4 and 0 < t < 0.05


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_measured_pass_times_the_hand_kernels_on_the_card(card, reduce):
    """``autotune(measure=True)`` with no ``device`` times on the card:
    each timed generated candidate launches its kernel once untimed and
    three times timed, the trusted candidate runs the ordered segment
    sum, and the winner's ``est_*`` are the measured seconds."""
    from repro_torch import obs
    from repro_torch.core.autotune import autotune
    rng = np.random.default_rng(0)
    coo = _coo(rng, 4096, 4096, 60_000)
    tops.reset_kernel_launches()
    with obs.profiled() as tracer:
        plan = autotune(coo, 128, measure=True, semiring_reduce=reduce)
    launches = tops.kernel_launches()
    rec = [s.attrs for s in tracer.snapshot() if s.name == "tuning.measure"]
    assert len(rec) == 1 and rec[0]["device"] == "cuda"
    timed = dict(rec[0]["candidates"])
    assert set(timed) > {"trusted"}
    for label in timed:
        kind = next((k for k in ("bsr", "sell", "ell")
                     if label.startswith(k)), None)
        if kind is not None:
            assert launches[f"{kind}_spmm"] == 4, launches
    assert launches["segment_sum"] >= 4, launches
    assert plan.est_trusted_s == timed["trusted"]
    assert all(0 < t < 1 for t in timed.values())


def test_measured_pass_raises_where_no_card_is_visible(card):
    """With the card hidden, a measured pass that names no device raises
    (it never times the host in the card's place)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import numpy as np\n"
            "from repro_torch.core import sparse as sp\n"
            "from repro_torch.core.autotune import autotune\n"
            "a = sp.coo_from_edges(np.arange(8), np.arange(8), "
            "np.ones(8, np.float32), 8, 8)\n"
            "autotune(a, 16, measure=True)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_cpu_row_is_never_served_on_the_card(card, tmp_path):
    """A plan measured on the host is not served to a build that measures
    on the card: the card measures afresh (kernels launch) and keeps its
    own row, which serves the next card build with no launch."""
    import json
    from repro_torch.core.autotune import TuningDB
    from repro_torch.core.cache import build_cached_graph
    rng = np.random.default_rng(1)
    coo = _coo(rng, 2048, 2048, 30_000)
    path = str(tmp_path / "db.json")
    build_cached_graph(coo, k_hint=64, measure=True, device="cpu",
                       db=TuningDB(path))
    tops.reset_kernel_launches()
    on_card = build_cached_graph(coo, k_hint=64, measure=True,
                                 db=TuningDB(path))
    assert sum(tops.kernel_launches().values()) > 0
    key = TuningDB.key(coo, 64)
    rows = json.loads(open(path).read())["plans"]
    assert sorted(rows) == sorted(
        [f"{key}@cpu", f"{key}@{torch.cuda.get_device_name(0)}"])
    tops.reset_kernel_launches()
    again = build_cached_graph(coo, k_hint=64, measure=True,
                               db=TuningDB(path))
    assert sum(tops.kernel_launches().values()) == 0
    assert again.plan == on_card.plan


# --------------------------------------------------------------------------
# the per-edge SDDMM, the redesigned segment sum and the trusted block
# path on the card
# --------------------------------------------------------------------------

def _edge_list(rng, n=3000, m=2800, nnz=60_000, hub=18_045):
    """Row-sorted edges with an R-MAT-sized hub row and a few ids out of
    range (they read zero rows)."""
    row = np.concatenate([rng.integers(0, n, nnz), np.full(hub, 11)])
    col = rng.integers(0, m, row.shape[0])
    row[rng.integers(0, row.shape[0], 7)] = n
    col[rng.integers(0, row.shape[0], 7)] = -1
    order = np.lexsort((col, row))
    return (torch.from_numpy(row[order].astype(np.int32)),
            torch.from_numpy(col[order].astype(np.int32)))


def _misaligned(t):
    """``t``'s values in a contiguous tensor whose data starts 4 bytes
    past a 16-byte boundary (the kernel then reads scalars)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("d,k", [(256, 256), (112, 112), (7, None),
                                 (130, 24), (256, None)])
@pytest.mark.parametrize("aligned", [True, False])
def test_edge_dots_kernel_matches_plain_and_repeats_bitwise(card, d, k,
                                                            aligned):
    """Kernel E against its plain version within 2 (D + 1) eps sum|x y|
    per edge (two fp32 sums of the same products in other orders), with
    an 18,045-entry hub row, widths not a multiple of 4 and operands off
    16-byte alignment; two launches give the same bits."""
    from repro_torch.kernels.edge_dots import edge_dots, edge_dots_plain
    from repro_torch.kernels.ref import edge_dots as plain1
    rng = np.random.default_rng(d + (k or 0) + aligned)
    row, col = _edge_list(rng)
    mats = [_h(rng, 3000, d), _h(rng, 2800, d)]
    if k is not None:
        mats += [_h(rng, 3000, k), _h(rng, 2800, k)]
    dev = [t.to(card) if aligned else _misaligned(t.to(card)) for t in mats]
    r, c = row.to(card), col.to(card)
    tops.reset_kernel_launches()
    runs = [edge_dots(*dev[:2], r, c, *dev[2:]) for _ in range(2)]
    torch.cuda.synchronize()
    assert tops.kernel_launches()["edge_dots"] == 2
    if k is None:
        runs = [(s,) for s in runs]
    want = edge_dots_plain(*mats[:2], row, col, *mats[2:])
    want = want if k is not None else (want,)
    for j, (got, again, w) in enumerate(zip(runs[0], runs[1], want)):
        assert torch.equal(got, again)
        a, b = mats[2 * j], mats[2 * j + 1]
        width = a.shape[1]
        mag = plain1(a.abs(), b.abs(), row, col)
        err = (got.cpu() - w).abs()
        assert (err <= 2 * (width + 1) * EPS32 * mag + 1e-30).all(), \
            float(err.max())
        assert (got.cpu()[(row >= 3000) | (col < 0)] == 0).all()


def test_edge_dots_dispatch_counts_and_rejects(card):
    from repro_torch.kernels.edge_dots import edge_dots, edge_dots_cuda
    x = torch.ones((4, 8), device=card)
    row = torch.tensor([0, 1, 3], dtype=torch.int32, device=card)
    col = torch.tensor([1, 2, 0], dtype=torch.int32, device=card)
    tops.reset_kernel_launches()
    assert torch.equal(edge_dots(x, x, row, col).cpu(), torch.full((3,), 8.0))
    s, s2 = edge_dots(x, x, row.long(), col, 2 * x[:, :5].contiguous(),
                      x[:, :5].contiguous())
    assert torch.equal(s2.cpu(), torch.full((3,), 10.0))
    assert tops.kernel_launches()["edge_dots"] == 2
    with pytest.raises(ValueError, match="float32"):
        edge_dots_cuda(x.double(), x, row, col)
    with pytest.raises(ValueError, match="int32"):
        edge_dots_cuda(x, x, row.long(), col)
    with pytest.raises(ValueError, match="do not match"):
        edge_dots_cuda(x, x[:, :4].contiguous(), row, col)
    with pytest.raises(ValueError, match="together"):
        edge_dots_cuda(x, x, row, col, x2=x)
    with pytest.raises(ValueError, match="on cuda"):
        edge_dots_cuda(x, x, row.cpu(), col)
    assert tops.kernel_launches()["edge_dots"] == 2
    assert edge_dots(x, x, row[:0], col[:0]).shape == (0,)


@pytest.mark.parametrize("k", [1, 7, 112, 256, 602])
def test_segment_sum_bitwise_where_targets_fit_a_piece(card, k):
    """The redesigned kernel equals its plain version bit for bit where
    every target has at most 256 slots, with per-entry weights read
    through the weight index and with weights permuted beforehand; a hub
    target (many pieces) repeats bitwise across launches."""
    from repro_torch.kernels.segment_sum import (segment_order,
                                                 segment_sum_sorted,
                                                 segment_sum_sorted_plain)
    rng = np.random.default_rng(k)
    tgt = torch.from_numpy(rng.integers(0, 400, 30_000).astype(np.int32))
    src_ids = torch.from_numpy(rng.integers(-2, 302, 30_000)
                               .astype(np.int32))
    order = segment_order(tgt, 400, sources=src_ids)
    assert int(torch.diff(order.offsets).max()) <= 256
    a = _h(rng, 300, k)
    w = torch.from_numpy(rng.standard_normal(30_000).astype(np.float32))
    want = segment_sum_sorted_plain(a, order.offsets, index=order.src,
                                    weight=w, weight_index=order.perm)
    o = [t.to(card) for t in (order.offsets, order.src, order.perm, a, w)]
    tops.reset_kernel_launches()
    through = segment_sum_sorted(o[3], o[0], index=o[1], weight=o[4],
                                 weight_index=o[2])
    permuted = segment_sum_sorted(o[3], o[0], index=o[1],
                                  weight=o[4].index_select(0, o[2].long()))
    torch.cuda.synchronize()
    assert tops.kernel_launches()["segment_sum"] == 2
    assert torch.equal(through.cpu(), want)
    assert torch.equal(permuted.cpu(), want)
    # a hub target of 20,000 slots: repeated bit for bit
    hub = torch.cat([tgt.to(card), torch.full((20_000,), 17, device=card,
                                              dtype=torch.int32)])
    ids = torch.cat([src_ids.to(card), o[1][:20_000]])
    horder = segment_order(hub, 400, sources=ids)
    wh = torch.cat([o[4], o[4][:20_000]])
    runs = [segment_sum_sorted(o[3], horder.offsets, index=horder.src,
                               weight=wh, weight_index=horder.perm)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("k", [7, 256, 602])
def test_segment_sum_routes_give_the_same_bits(card, monkeypatch, k):
    """Slots that gather rows few times (fewer than ``ROW_REUSE`` a source
    row) take the whole-row route, the rest the K-sliced one: the two sum
    in the same order, so they give the same bits, equal to the plain
    version where every target fits one piece, with a hub target too."""
    from repro_torch.kernels import segment_sum as kseg
    rng = np.random.default_rng(100 + k)
    n_src = 20_000
    tgt = np.concatenate([rng.integers(0, 3_000, 20_000),
                          np.full(1_000, 9)]).astype(np.int32)
    src_ids = rng.integers(-1, n_src + 1, tgt.shape[0]).astype(np.int32)
    order = kseg.segment_order(torch.from_numpy(tgt), 3_000,
                               sources=torch.from_numpy(src_ids))
    a = _h(rng, n_src, k)
    w = torch.from_numpy(rng.standard_normal(tgt.shape[0])
                         .astype(np.float32))
    o = [t.to(card) for t in (order.offsets, order.src, order.perm, a, w)]

    def run():
        return kseg.segment_sum_sorted(o[3], o[0], index=o[1], weight=o[4],
                                       weight_index=o[2])
    assert tgt.shape[0] < kseg.ROW_REUSE * n_src
    rows = [run() for _ in range(2)]
    monkeypatch.setattr(kseg, "ROW_REUSE", 0)
    sliced = run()
    torch.cuda.synchronize()
    assert torch.equal(rows[0], rows[1])
    assert torch.equal(rows[0], sliced)
    want = kseg.segment_sum_sorted_plain(a, order.offsets, index=order.src,
                                         weight=w, weight_index=order.perm)
    fits = (torch.diff(order.offsets) <= kseg.CHUNK).numpy()
    assert not fits.all()
    assert torch.equal(sliced.cpu()[fits], want[fits])


def _trusted_first_step(card, arch, ds, params):
    """Seed batch 0's blocks, host-sampled and packed with the plan
    ``BlockPlanCache(tune=False)`` gives (trusted), and one patched
    minibatch step over them: (params, opt state, loss, grads) and the
    launch counts."""
    from repro_torch.core.patch import patched
    from repro_torch.optim.optimizer import adamw
    from repro_torch.sampling import (BlockPlanCache, NeighborSampler,
                                      pack_block, plan_buckets, seed_batches)
    from repro_torch.train import gnn_minibatch as mb
    fanouts, batch = (10, 25), 256
    seed_ids, n_real = next(iter(seed_batches(
        np.nonzero(ds.train_mask.numpy())[0], batch, seed=0, epoch=0)))
    blocks = NeighborSampler(tsp.csr_from_coo(ds.coo), fanouts,
                             seed=0).sample(seed_ids[:n_real], round=0)
    _, _, apply_blocks, dims = mb.make_block_model(
        arch, ds.num_features, 64, ds.num_classes, 2)
    cache = BlockPlanCache(semiring=arch.split("-")[1], tune=False)
    pbs = []
    for blk, bk, k in zip(blocks, plan_buckets(blocks, batch_size=batch,
                                               fanouts=fanouts), dims):
        plan = cache.plan_for(blk, n_dst=bk.n_dst, n_src=bk.n_src,
                              nnz=bk.nnz, k_hint=k)
        assert plan.kind == "trusted"
        pbs.append(tsp.to_device(pack_block(
            blk, n_dst=bk.n_dst, n_src=bk.n_src, nnz=bk.nnz, plan=plan,
            ell_width=bk.ell_width, sell_steps=bk.sell_steps), card))
    opt = adamw(1e-2, weight_decay=5e-4)
    step = mb.make_minibatch_step(apply_blocks, opt, batch_size=batch)
    tops.reset_kernel_launches()
    with patched(True):
        out = step(params, opt.init(params), pbs,
                   torch.from_numpy(seed_ids).to(card), n_real,
                   ds.x.to(card), ds.y.to(card), mb.init_step_stats(card))
    torch.cuda.synchronize()
    p, s, loss, grads, _ = out
    return (p, s._asdict(), loss, grads), tops.kernel_launches()


@pytest.mark.parametrize("arch", ["sage-mean", "sage-max"])
def test_trusted_block_first_step_is_bitwise_repeatable(card, arch):
    """A minibatch bucket with a trusted plan: its first step twice from
    the same state gives the same loss, gradients, parameters and
    optimizer state bit for bit (the trusted block path's forward and
    backward are ordered segment sums on the card)."""
    from repro_torch.data import make_dataset
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import gnn_minibatch as mb
    ds = make_dataset("reddit", scale=1 / 64, seed=1)
    init, _, _, _ = mb.make_block_model(arch, ds.num_features, 64,
                                        ds.num_classes, 2)
    params = init(torch.Generator().manual_seed(0), device=card)
    (a, la), (b, lb) = (_trusted_first_step(card, arch, ds, params)
                        for _ in range(2))
    assert la == lb and la["segment_sum"] > 0, la
    assert not la["ell_spmm"] and not la["sell_spmm"]
    same = []
    for x, y in zip(a, b):          # params, opt state, loss, grads
        tree_map(lambda p, q: same.append(torch.equal(p, q)), x, y)
    assert same and all(same)


def test_sddmm_gradients_are_ordered_and_bitwise_repeatable(card):
    """The public ``sddmm`` on the card: the forward is the per-edge
    kernel, the backward's two scatters the ordered segment sum, and two
    runs give the same bits."""
    from repro_torch.core.cache import build_cached_graph
    from repro_torch.core.sddmm import sddmm
    from repro_torch.data import make_dataset
    ds = make_dataset("reddit", scale=1 / 128, seed=1)
    g = build_cached_graph(ds.coo, tune=False).to(card)
    rng = np.random.default_rng(3)
    x, y = _h(rng, ds.num_nodes, 64).to(card), _h(rng, ds.num_nodes,
                                                   64).to(card)
    c = torch.from_numpy(rng.standard_normal(g.coo.nnz_padded)
                         .astype(np.float32)).to(card)
    runs = []
    for _ in range(2):
        tops.reset_kernel_launches()
        tx, ty = x.clone().requires_grad_(True), y.clone().requires_grad_(
            True)
        s = sddmm(g, tx, ty)
        runs.append((s,) + torch.autograd.grad((s * c).sum(), (tx, ty)))
        launched = tops.kernel_launches()
        assert launched["edge_dots"] == 1 and launched["segment_sum"] == 2
    assert all(torch.equal(p, q) for p, q in zip(*runs))


# --------------------------------------------------------------------------
# LM training: the flash backward kernel, the forward's log-sum-exp, the
# ragged GEMM's dX launch, one smoke train step.
#
# The backward's fp32 instance within 1e-4 x the largest plain value:
# dS = P (dP - D) subtracts two fp32 dot products of magnitude ~sqrt(D),
# so the difference keeps ~1e-6 of their size, and dK sums G x S such
# terms. bf16 within 2^-7 x the largest plain value (two bf16 ulps at the
# largest magnitude): both round P and dS to bf16 as operands and the
# output once, from fp32 values summed in another order.
# --------------------------------------------------------------------------

_BWD_CASES = [
    (1, 8, 2, 256, 256, 128, True, None),       # causal, G = 4
    (2, 4, 1, 200, 333, 64, True, 100),         # S < T, window, ragged
    (1, 4, 4, 130, 130, 32, False, None),       # not causal, ragged tile
    (1, 8, 2, 300, 300, 128, False, 64),        # window, not causal
    (2, 2, 2, 70, 150, 32, True, 50),           # rep 1, window
    (1, 8, 2, 333, 500, 128, True, 150),        # S < T, window, ragged S
    (1, 4, 4, 190, 190, 64, False, None),       # not causal, ragged S
    (1, 16, 16, 256, 256, 256, True, None),     # gemma-7b's heads of 256
    (1, 4, 1, 200, 333, 256, True, 100)]        # D 256, S < T, window


def _bwd_inputs(rng, dtype, b, hq, hkv, s, t, d, causal, window, card):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = _randn(rng, (b, hq, s, d), dtype, card)
    k = _randn(rng, (b, hkv, t, d), dtype, card)
    v = _randn(rng, (b, hkv, t, d), dtype, card)
    do = _randn(rng, (b, hq, s, d), dtype, card)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,window", _BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(card, dtype, b, hq, hkv,
                                                  s, t, d, causal, window):
    """Each instance (bf16: ``wgmma`` at D 64, 128 and 256, ``wmma`` at
    32; fp32 up to 128, and a named refusal at 256) against the plain
    version, the launch counted under its instance."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_plain_lse, flash_bwd_instance)
    rng = np.random.default_rng(s + t + d)
    q, k, v, o, do, lse = _bwd_inputs(rng, dtype, b, hq, hkv, s, t, d,
                                      causal, window, card)
    _, want_lse = flash_attention_plain_lse(q.float(), k.float(), v.float(),
                                            causal=causal, window=window)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=1e-5 if dtype == torch.float32 else 1e-2,
                               atol=1e-4)
    tops.reset_kernel_launches()
    if dtype == torch.float32 and d == 256:
        with pytest.raises(ValueError, match="227 KB"):
            flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                     window=window)
        assert flash_attention_bwd_cuda.launches == 0
        return
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                   window=window)
    inst = flash_bwd_instance(dtype, d)
    assert inst == ("f32" if dtype == torch.float32 else
                    "wmma" if d == 32 else "wgmma")
    assert flash_attention_bwd_cuda.launches_by_instance == {
        n: int(n == inst) for n in ("wgmma", "wmma", "f32")}
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * float(
            w.float().abs().max())
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype,d,s,t,window,inst", [
    (torch.float32, 128, 512, 512, None, "f32"),
    (torch.bfloat16, 128, 512, 512, None, "wgmma"),
    (torch.bfloat16, 64, 333, 500, 150, "wgmma"),    # S < T, window, ragged
    (torch.bfloat16, 256, 300, 300, None, "wgmma")])
def test_flash_attention_bwd_kernel_is_bitwise_repeatable(card, dtype, d, s,
                                                          t, window, inst):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    rng = np.random.default_rng(9)
    args = _bwd_inputs(rng, dtype, 2, 8, 2, s, t, d, True, window, card)
    kw = dict(causal=True, window=window)
    first = flash_attention_bwd_cuda(*args, **kw)
    tops.reset_kernel_launches()
    again = flash_attention_bwd_cuda(*args, **kw)
    assert flash_attention_bwd_cuda.launches == 1
    assert flash_attention_bwd_cuda.launches_by_instance[inst] == 1
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# the CPU tile-walk cases at D 256 (tests/test_torch_flash_bwd.py) and
# gemma-7b's heads
_D256_CASES = [
    (1, 4, 1, 200, 333, True, None),      # S < T, G = 4, ragged tiles
    (1, 2, 2, 130, 130, False, None),     # not causal, G = 1
    (1, 4, 1, 150, 150, True, 70),        # sliding window, G = 4
    (2, 2, 2, 77, 300, True, 90),         # S < T, window, G = 1
    (1, 4, 1, 100, 190, False, 40),       # window, not causal
    (1, 16, 16, 1024, 1024, True, None)]  # gemma-7b's heads


@pytest.mark.parametrize("b,hq,hkv,s,t,causal,window", _D256_CASES)
def test_flash_attention_bwd_d256_wgmma_matches_plain_and_oracle(
        card, b, hq, hkv, s, t, causal, window):
    """bf16 at D 256 runs the ``wgmma`` instance (the head dim split
    across two warpgroups): dq, dk and dv held by ``chip_smoke.py``'s
    ``check_lm_launch`` (within 2^-7 x max|plain| of the plain version
    and, row by row past ``flash_bwd_row_floors``, within 2^-7 of the
    fp32 oracle's row); two launches give the same bits."""
    import importlib.util
    from pathlib import Path
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_bwd_row_floors)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(s + t + 256)
    args = _bwd_inputs(rng, torch.bfloat16, b, hq, hkv, s, t, 256, causal,
                       window, card)
    kw = dict(causal=causal, window=window)
    tops.reset_kernel_launches()
    got = flash_attention_bwd_cuda(*args, **kw)
    again = flash_attention_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_cuda.launches_by_instance == {
        "wgmma": 2, "wmma": 0, "f32": 0}
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    q, k, v, o, do, lse = args
    want = flash_attention_bwd_plain(*args, **kw)
    oracle = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       o.float(), do.float(), lse, **kw)
    floors = flash_bwd_row_floors(*args, **kw)
    for name, g, w, orc, fl in zip(("dq", "dk", "dv"), got, want, oracle,
                                   floors):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        smoke.check_lm_launch(dict(name=name, shape=str(tuple(g.shape))), g,
                              w, orc, row_floor=fl)


@pytest.mark.parametrize("dtype,e,c,d,f,inst", [
    (torch.bfloat16, 4, 256, 512, 384, "wgmma"),
    (torch.bfloat16, 4, 256, 100, 264, "wmma"),      # D not a multiple of 8
    (torch.float32, 4, 256, 512, 384, "f32")])
def test_ragged_gemm_dx_launch_matches_plain(card, dtype, e, c, d, f, inst):
    """The autograd Function's dX is the kernel reading W transposed in
    place (a backward launch of the same instance), dW one batched
    product: against the plain pieces on the same card tensors. A dX
    alone allocates its output and no copy of W."""
    from repro_torch.kernels.ragged_gemm import (ragged_gemm_cuda,
                                                 ragged_gemm_plain)
    rng = np.random.default_rng(11)
    x = _randn(rng, (e * c, d), dtype, card).requires_grad_(True)
    w = _randn(rng, (e, d, f), dtype, card).requires_grad_(True)
    dy = _randn(rng, (e * c, f), dtype, card)
    te = (torch.arange(e * c // 128, dtype=torch.int32) // (c // 128)).to(card)
    tops.reset_kernel_launches()
    tops.ragged_gemm(x, w, te, n_groups=e).backward(dy)
    torch.cuda.synchronize()
    assert ragged_gemm_cuda.launches_by_direction == {"forward": 1,
                                                      "backward": 1}
    assert ragged_gemm_cuda.launches_by_instance[inst] == 2
    want_dx = ragged_gemm_plain(dy, w.detach().transpose(1, 2).contiguous(),
                                te)
    _close_lm(x.grad, want_dx, dtype)
    want_dw = torch.bmm(x.detach().float().view(e, c, d).transpose(1, 2),
                        dy.float().view(e, c, f))
    _close_lm(w.grad, want_dw, dtype)
    # dX alone, with W F / 128 (2x to 3x) dX's size: the backward's peak
    # over what was allocated before it stays below W's bytes (a Wᵀ copy
    # would not)
    e2, c2 = 16, 128
    x2 = _randn(rng, (e2 * c2, d), dtype, card).requires_grad_(True)
    w2 = _randn(rng, (e2, d, f), dtype, card)
    dy2 = _randn(rng, (e2 * c2, f), dtype, card)
    te2 = torch.arange(e2, dtype=torch.int32, device=card)
    out = tops.ragged_gemm(x2, w2, te2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out.backward(dy2)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    w_bytes = w2.numel() * w2.element_size()
    assert grown < w_bytes, (grown, w_bytes)
    _close_lm(x2.grad, ragged_gemm_plain(dy2, w2, te2, transpose_w=True),
              dtype)


def _lm_smoke_step(cfg, device, batch, params):
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    step, opt = TL.make_train_step(cfg, lr=3e-3)
    p = tree_map(lambda x: x.to(device, copy=True), params)  # the step
    state = TL.TrainState(p, opt.init(p), None)              # writes p
    b = {key: val.to(device) for key, val in batch.items()}
    state, metrics = step(state, b)
    return state, {k: float(v) for k, v in metrics.items()}


def test_lm_train_step_on_card_matches_cpu_and_repeats(card):
    """phi3.5-moe's smoke config in fp32 with remat "full": one train step
    on the card (both kernels forward, recomputed and backward) against
    the port's CPU step from the same weights and batch, metrics rtol
    1e-4 and params as tests/test_torch_lm_train.py holds the CPU step to
    the reference (all but 0.1 % of the elements within 1e-4 relative,
    all within 3 lr: AdamW's direction does not shrink with the
    gradient);
    and the card step run twice gives the same bits."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import lm
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.kernels.ragged_gemm import ragged_gemm_cuda
    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                              remat="full")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks, tgts = synthetic_lm_batch(2, 64, cfg.vocab, step=1)
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)}
    tops.reset_kernel_launches()
    s_card, m_card = _lm_smoke_step(cfg, card, batch, params)
    torch.cuda.synchronize()
    launched = {n: c for n, c in tops.kernel_launches().items() if c}
    assert launched == {"flash_attention": 4, "flash_attention_bwd": 2,
                        "ragged_gemm": 18}, launched
    assert ragged_gemm_cuda.launches_by_direction == {"forward": 12,
                                                      "backward": 6}
    s_cpu, m_cpu = _lm_smoke_step(cfg, "cpu", batch, params)
    for key in m_cpu:
        assert abs(m_card[key] - m_cpu[key]) <= 1e-4 * abs(m_cpu[key]), key
    off = total = 0
    for a, b in zip(tree_leaves(s_card.params), tree_leaves(s_cpu.params)):
        d = (a.cpu() - b).abs()
        off += int((d > 1e-4 * (b.abs().max() + b.abs())).sum())
        total += d.numel()
        assert float(d.max()) <= 3 * 3e-3
    assert off <= 1e-3 * total, (off, total)
    s_again, m_again = _lm_smoke_step(cfg, card, batch, params)
    assert m_again == m_card
    for tree in ("params", "opt_state"):
        for a, b in zip(tree_leaves(getattr(s_again, tree)._asdict()
                                    if tree == "opt_state" else
                                    s_again.params),
                        tree_leaves(getattr(s_card, tree)._asdict()
                                    if tree == "opt_state" else
                                    s_card.params)):
            assert torch.equal(a, b)


def test_device_sampled_kill_and_resume_is_bitwise(card, tmp_path):
    """``train_gnn_minibatch`` with the device sampler, 2 epochs of 3
    steps, killed before step 4 (a checkpoint every 2 steps) and resumed
    from step 4's predecessor on the cadence: the resumed run's losses and
    final params equal the clean run's bit for bit, and it launched the
    fused hop and the ordered segment sum."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.data import make_dataset
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.testing import FaultPlan, expect_kill
    from repro_torch.train import gnn_minibatch as mb

    ds = make_dataset("reddit", scale=1 / 64, seed=1)
    batch = -(-int(ds.train_mask.sum()) // 3)
    kw = dict(fanouts=(10, 25), batch_size=batch, hidden=64, epochs=2,
              sampler="device", device=card)
    clean = mb.train_gnn_minibatch("sage-mean", ds, ckpt_dir=str(
        tmp_path / "clean"), ckpt_every=2, **kw)
    d = str(tmp_path / "killed")
    expect_kill(mb.train_gnn_minibatch, "sage-mean", ds, ckpt_dir=d,
                ckpt_every=2, faults=FaultPlan(step_exception_at=5), **kw)
    tops.reset_kernel_launches()
    res = mb.train_gnn_minibatch("sage-mean", ds, ckpt_dir=d, ckpt_every=2,
                                 **kw)
    launches = tops.kernel_launches()
    assert res.resumed_step == 4 and res.losses == clean.losses
    assert launches["sample_hop"] >= 4 and launches["segment_sum"] >= 2
    for a, b in zip(tree_leaves(clean.final_params),
                    tree_leaves(res.final_params)):
        assert a.device.type == card.type and torch.equal(a, b)
    # the final checkpoints: every param and Adam moment, and the step
    like = {"params": clean.final_params,
            "opt_state": adamw(0.01).init(clean.final_params)}

    def leaves(name):
        got = restore_checkpoint(str(tmp_path / name), like, step=6)[0]
        s = got["opt_state"]
        return tree_leaves(got["params"]) + [s.step] + tree_leaves(s.mu) + \
            tree_leaves(s.nu)
    got = [leaves(name) for name in ("clean", "killed")]
    n = len(tree_leaves(clean.final_params))
    assert len(got[0]) == 3 * n + 1 and int(got[0][n]) == 6
    assert all(torch.equal(a, b) for a, b in zip(*got))


def test_async_save_then_in_place_step_restores_bitwise(card, tmp_path):
    """An LM train state on the card (bf16 params, fp32 moments) saved
    asynchronously, then a train step at once that updates it in place
    while the write may be in flight: the restore equals a clone taken
    before the save bit for bit, and the next step from the restored state
    equals the next step from the clone."""
    import dataclasses
    from repro_torch.ckpt import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.train import lm as TL

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="bfloat16")
    step_fn, opt = TL.make_train_step(cfg)
    state = TL.make_train_state(cfg, torch.Generator(device=card)
                                .manual_seed(0), opt, device=card)
    toks, tgts = synthetic_lm_batch(2, 32, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(card),
             "targets": torch.from_numpy(tgts).to(card)}
    state, _ = step_fn(state, batch)
    assert tree_leaves(state.params)[0].dtype == torch.bfloat16

    def clone(st):
        return TL.TrainState(tree_map(torch.clone, st.params),
                             st.opt_state._replace(
                                 step=st.opt_state.step.clone(),
                                 mu=tree_map(torch.clone, st.opt_state.mu),
                                 nu=tree_map(torch.clone, st.opt_state.nu)),
                             None)

    def leaves(st):
        return tree_leaves(st.params) + [st.opt_state.step] + \
            tree_leaves(st.opt_state.mu) + tree_leaves(st.opt_state.nu)

    before = clone(state)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    state, _ = step_fn(state, batch)          # in place, during the write
    torch.cuda.synchronize()
    ck.wait()
    assert any(not torch.equal(a, b)
               for a, b in zip(leaves(state), leaves(before)))
    restored, step = ck.restore(before)
    assert step == 1
    for a, b in zip(leaves(restored), leaves(before)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)
    s1, m1 = step_fn(restored, batch)
    s2, m2 = step_fn(before, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(s1), leaves(s2)))


def test_lm_launcher_restarts_and_resumes_on_card(card, tmp_path, capsys):
    """The LM launcher on the card: ``--inject-fault`` fails a step once
    and the resilient loop finishes with one restart; ``--resume`` goes
    on from the newest checkpoint."""
    from repro_torch.launch import train as launch_train
    d = str(tmp_path / "ckpt")
    common = ["--mode", "lm", "--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
              "--lr", "3e-3", "--ckpt-dir", d, "--ckpt-every", "5"]
    tops.reset_kernel_launches()
    rc = launch_train.main([*common, "--steps", "20", "--inject-fault", "7"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "on cuda" in out and "loss decreased: OK" in out
    assert "restarts=1 emergency_saves=1 last step 20" in out, out
    assert tops.kernel_launches()["flash_attention_bwd"] > 0
    rc = launch_train.main([*common, "--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert rc == 0 and "resumed from step 20" in out and "last step 23" in out


# the sink-aware flash kernels (hymba's meta tokens): every instance, the
# sink prefix 0 (the windowed walk of before), 8 (inside the first tile)
# and 128 (hymba's); hymba's group of 5 query heads a KV head
_SINK_CASES = [
    (1, 5, 1, 333, 333, 64, 96),         # hymba's heads of 64, G = 5
    (2, 10, 2, 300, 450, 64, 150),       # S < T, G = 5
    (1, 4, 2, 290, 290, 128, 70),        # D 128, ragged S
    (1, 4, 1, 260, 300, 256, 100),       # D 256 (the split backward)
    (1, 4, 2, 200, 200, 32, 40)]         # D 32 (wmma backward)


@pytest.mark.parametrize("meta_len", [0, 8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,window", _SINK_CASES)
def test_flash_attention_sinks_match_plain(card, dtype, b, hq, hkv, s, t, d,
                                           window, meta_len):
    """The forward with sinks, with its LSE: against the plain version
    and the fp32 oracle's LSE; the backward (fp32 up to D 128, bf16 at
    every head dim) against the plain version, the launch counted under
    its instance, two launches the same bits."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain,
        flash_attention_plain_lse, flash_bwd_instance)
    rng = np.random.default_rng(s + t + d + meta_len)
    q = _randn(rng, (b, hq, s, d), dtype, card)
    k = _randn(rng, (b, hkv, t, d), dtype, card)
    v = _randn(rng, (b, hkv, t, d), dtype, card)
    do = _randn(rng, (b, hq, s, d), dtype, card)
    kw = dict(causal=True, window=window, meta_len=meta_len)
    tops.reset_kernel_launches()
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert flash_attention_cuda.launches == 1
    _close_lm(o, flash_attention_plain(q, k, v, **kw), dtype)
    _, want_lse = flash_attention_plain_lse(q.float(), k.float(), v.float(),
                                            **kw)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=1e-5 if dtype == torch.float32 else 1e-2,
                               atol=1e-4)
    if dtype == torch.float32 and d == 256:
        return                        # no fp32 backward at D 256
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    inst = flash_bwd_instance(dtype, d)
    assert flash_attention_bwd_cuda.launches_by_instance == {
        n: 2 * int(n == inst) for n in ("wgmma", "wmma", "f32")}
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * float(
            w.float().abs().max())
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("meta_len", [0, 8, 128])
@pytest.mark.parametrize("b,hq,hkv,s,t,window", [
    (1, 4, 2, 333, 333, 96), (2, 4, 4, 300, 450, 150)])
def test_flash_attention_d80_window_and_sinks_match_plain(card, b, hq, hkv,
                                                         s, t, window,
                                                         meta_len):
    """D 80's own design on the windowed walk with sinks (bf16; the
    ``FlashMask`` walks every instance shares): the forward and its LSE,
    the backward, against the plain versions; two launches of each the
    same bits."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain,
        flash_attention_plain_lse)
    rng = np.random.default_rng(s + t + meta_len)
    q, do = (_randn(rng, (b, hq, s, 80), torch.bfloat16, card)
             for _ in range(2))
    k, v = (_randn(rng, (b, hkv, t, 80), torch.bfloat16, card)
            for _ in range(2))
    kw = dict(causal=True, window=window, meta_len=meta_len)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    o2, lse2 = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _close_lm(o, flash_attention_plain(q, k, v, **kw), torch.bfloat16)
    _, want_lse = flash_attention_plain_lse(q.float(), k.float(), v.float(),
                                            **kw)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=1e-2, atol=1e-4)
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2.0 ** -7 * float(w.float().abs().max()), err


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_and_hybrid_smoke_on_card_match_cpu(card, arch):
    """The fp32 smoke configs on the card (the sink-aware kernels for
    hymba) against the port's CPU run from the same weights: prefill + 4
    decode steps within atol 1e-4 of the logits, 2 train steps' losses
    within rtol 1e-4; the flash kernels run, no plain version on the
    card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import lm
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    cfg = get_smoke_config(arch)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p_card = tree_map(lambda x: x.to(card), p_cpu)
    toks, tgts = synthetic_lm_batch(2, 80, cfg.vocab, step=1)
    toks, tgts = torch.from_numpy(toks), torch.from_numpy(tgts)
    cap = 80 + cfg.n_meta_tokens + 2            # hymba's cache wraps
    tops.reset_kernel_launches()
    c_card, l_card = lm.prefill(cfg, p_card, {"tokens": toks.to(card)}, cap)
    c_cpu, l_cpu = lm.prefill(cfg, p_cpu, {"tokens": toks}, cap)
    errs = [float((l_card.cpu() - l_cpu).abs().max())]
    for i in range(4):
        tok = toks[:, i:i + 1]
        l_card, c_card = lm.decode_step(cfg, p_card, c_card, tok.to(card))
        l_cpu, c_cpu = lm.decode_step(cfg, p_cpu, c_cpu, tok)
        errs.append(float((l_card.cpu() - l_cpu).abs().max()))
    assert max(errs) <= 1e-4, errs
    assert tops.kernel_launches()["flash_attention"] == (
        cfg.n_layers if cfg.has_attention else 0)
    step, opt = TL.make_train_step(cfg)
    cpu = TL.TrainState(tree_map(torch.clone, p_cpu), opt.init(p_cpu), None)
    dev = TL.TrainState(p_card, opt.init(p_card), None)
    for i in range(2):
        b = {"tokens": toks, "targets": tgts}
        dev, m_card = step(dev, {n: x.to(card) for n, x in b.items()})
        cpu, m_cpu = step(cpu, b)
        lc, lp = float(m_card["loss"]), float(m_cpu["loss"])
        assert abs(lc - lp) <= 1e-4 * abs(lp), (i, lc, lp)
    if cfg.has_attention:
        assert tops.kernel_launches()["flash_attention_bwd"] == \
            2 * cfg.n_layers


# hubert-xlarge's head dim 80 (bf16 only: both kernels run it at its true
# width, in 16-column atoms) and the encoder's path without the causal
# mask, at hubert's full attention shape, at S = T not a multiple of any
# tile and at S < T
_D80_CASES = [
    (4, 16, 16, 4096, 4096, False),      # hubert's attention, whole
    (1, 16, 16, 4000, 4000, False),      # hubert's heads, S = T = 4,000
    (2, 4, 4, 333, 700, False),          # S < T, ragged S
    (1, 4, 2, 4000, 4000, True),         # causal, G = 2
    (2, 4, 2, 200, 333, True)]           # causal, S < T


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# hubert-xlarge's attention (non-causal, D 80) and internvl2-2b's (causal,
# GQA 16 / 8, D 128) at their full shapes
_FAULT_CASES = [(4, 16, 16, 4096, 4096, 80, False),
                (4, 16, 8, 3072, 3072, 128, True)]


# common: the scale of a part the keys share (their own part is 0.3 x a
# normal draw), so that dQ's rows cancel (dS sums to zero over a row); at
# 8 dQ cancels so far that the kernel and the plain version, which round
# dS at slightly different fp32 values, differ by more than 2^-7 of dQ's
# max, and the whole-tensor check (no floor) fails for that alone
@pytest.mark.parametrize("common", [0.0, 2.0])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", _FAULT_CASES)
def test_flash_bwd_row_check_catches_planted_faults(card, b, hq, hkv, s, t,
                                                    d, causal, common):
    """The backward's row check at the front ends' full attention shapes:
    the kernel's dq, dk and dv pass ``chip_smoke.check_flash_bwd`` (the
    plain version, and row by row past ``flash_bwd_row_floors`` the fp32
    oracle), also with a common part in the keys, where dQ's rows cancel
    and its floor takes dS's bf16 rounding; and each fault it plants in
    them (two keys or one 64 x 64 tile missing from dQ, one tile or two
    queries missing from dK or dV) fails the row check."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    smoke = _chip_smoke()
    rng = np.random.default_rng(s + d + int(common))
    q = _randn(rng, (b, hq, s, d), torch.bfloat16, card)
    k = (0.3 * _randn(rng, (b, hkv, t, d), torch.float32, card)
         + common * _randn(rng, (1, 1, 1, d), torch.float32, card)
         ).bfloat16()
    v = _randn(rng, (b, hkv, t, d), torch.bfloat16, card)
    do = _randn(rng, (b, hq, s, d), torch.bfloat16, card)
    kw = dict(causal=causal, window=None, meta_len=0)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    out = smoke.check_flash_bwd(q, k, v, o, do, lse, got, kw,
                                f"{tuple(q.shape)}/{tuple(k.shape)} "
                                f"causal={causal} common={common}")
    assert out["row_err_over_row_max"] <= smoke.LM_TOL
    assert len(out["planted_faults"]) == 6


def _fwd_bwd_against_plain_and_oracle(card, b, hq, hkv, s, t, d, causal,
                                      seed):
    """bf16 forward with its LSE and backward at (b, hq, hkv, s, t, d):
    each launched twice for the same bits and counted on the ``wgmma``
    instances; the output held by ``chip_smoke.check_lm_launch`` against
    the plain version and, row by row, the fp32 oracle (the backward's
    rows past ``flash_bwd_row_floors``), the LSE within 1e-3 of the
    oracle's (fp32 sums of D products in another order, scores ~10)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain,
        flash_attention_plain_lse, flash_bwd_row_floors)
    smoke = _chip_smoke()
    rng = np.random.default_rng(seed)
    q = _randn(rng, (b, hq, s, d), torch.bfloat16, card)
    k = _randn(rng, (b, hkv, t, d), torch.bfloat16, card)
    v = _randn(rng, (b, hkv, t, d), torch.bfloat16, card)
    do = _randn(rng, (b, hq, s, d), torch.bfloat16, card)
    kw = dict(causal=causal)
    shape = f"{tuple(q.shape)}/{tuple(k.shape)} causal={causal}"
    tops.reset_kernel_launches()
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    o2, lse2 = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_by_instance == {"wgmma": 2,
                                                         "f32": 0}
    assert flash_attention_bwd_cuda.launches_by_instance == {
        "wgmma": 2, "wmma": 0, "f32": 0}
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want_o, want_lse = flash_attention_plain_lse(q.float(), k.float(),
                                                 v.float(), **kw)
    smoke.check_lm_launch(dict(name="forward", shape=shape), o,
                          flash_attention_plain(q, k, v, **kw), want_o)
    assert float((lse - want_lse).abs().max()) <= 1e-3
    del want_o, want_lse, o2, lse2, again
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    oracle = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       o.float(), do.float(), lse, **kw)
    floors = flash_bwd_row_floors(q, k, v, o, do, lse, **kw)
    for name, g, w, orc, fl in zip(("dq", "dk", "dv"), got, want, oracle,
                                   floors):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        smoke.check_lm_launch(dict(name=name, shape=shape), g, w, orc,
                              row_floor=fl)


@pytest.mark.parametrize("b,hq,hkv,s,t,causal", _D80_CASES)
def test_flash_attention_d80_matches_plain_and_oracle(card, b, hq, hkv, s, t,
                                                      causal):
    """bf16 at D 80, forward with its LSE and backward, non-causal and
    causal, against the plain versions and the fp32 oracle; two launches
    of each give the same bits."""
    _fwd_bwd_against_plain_and_oracle(card, b, hq, hkv, s, t, 80, causal,
                                      seed=s + t + 80)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,s,t", [(1, 4, 2, 4000, 4000),
                                          (2, 4, 4, 300, 700)])
def test_flash_attention_noncausal_every_bf16_instance(card, d, b, hq, hkv,
                                                       s, t):
    """The encoder's path (``causal=False``) on the bf16 ``wgmma``
    instances at D 64, 128 and 256: the forward walks every KV tile, the
    dK / dV kernel every query tile, the dQ kernel every key tile."""
    _fwd_bwd_against_plain_and_oracle(card, b, hq, hkv, s, t, d, False,
                                      seed=s + t + d)


def test_flash_attention_fp32_d80_raises(card):
    """fp32 at D 80 is not built: both wrappers raise a ValueError that
    names it, and launch nothing."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    q = torch.zeros((1, 2, 64, 80), device=card)
    lse = torch.zeros((1, 2, 64), device=card)
    tops.reset_kernel_launches()
    with pytest.raises(ValueError, match="fp32 at head dim 80"):
        flash_attention_cuda(q, q, q, causal=False)
    with pytest.raises(ValueError, match="fp32 at head dim 80"):
        flash_attention_bwd_cuda(q, q, q, q, q, lse, causal=False)
    assert flash_attention_cuda.launches == 0
    assert flash_attention_bwd_cuda.launches == 0


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b"])
def test_frontends_smoke_on_card_match_cpu(card, arch):
    """The fp32 smoke configs on the card against the port's CPU run from
    the same weights: hubert's forward (frames, non-causal) and
    internvl2's prefill of an image prefix and tokens + 4 decode steps
    within atol 1e-4 of the logits, 2 train steps' losses within rtol
    1e-4; the flash kernels run, forward and backward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.lm import transformer as TT
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    cfg = get_smoke_config(arch)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p_card = tree_map(lambda x: x.to(card), p_cpu)
    rng = np.random.default_rng(4)
    batch = {}
    for key, spec in TL.shaped_batch(cfg, 2, 80).items():
        batch[key] = torch.from_numpy(
            rng.integers(0, cfg.vocab, tuple(spec.shape)).astype(np.int32)
            if spec.dtype == torch.int32 else
            rng.standard_normal(tuple(spec.shape)).astype(np.float32))
    on_card = {k: v.to(card) for k, v in batch.items()}
    tops.reset_kernel_launches()
    if cfg.family == "audio":
        h_card, _ = lm.forward_hidden(cfg, p_card, on_card)
        h_cpu, _ = lm.forward_hidden(cfg, p_cpu, batch)
        errs = [float((TT._unembed(cfg, p_card, h_card).cpu()
                       - TT._unembed(cfg, p_cpu, h_cpu)).abs().max())]
    else:
        prompt = {k: v for k, v in batch.items() if k != "targets"}
        c_card, l_card = lm.prefill(cfg, p_card, {
            k: v.to(card) for k, v in prompt.items()}, 90)
        c_cpu, l_cpu = lm.prefill(cfg, p_cpu, prompt, 90)
        errs = [float((l_card.cpu() - l_cpu).abs().max())]
        for i in range(4):
            tok = batch["tokens"][:, i:i + 1]
            l_card, c_card = lm.decode_step(cfg, p_card, c_card,
                                            tok.to(card))
            l_cpu, c_cpu = lm.decode_step(cfg, p_cpu, c_cpu, tok)
            errs.append(float((l_card.cpu() - l_cpu).abs().max()))
    assert max(errs) <= 1e-4, errs
    assert tops.kernel_launches()["flash_attention"] == cfg.n_layers
    step, opt = TL.make_train_step(cfg)
    cpu = TL.TrainState(tree_map(torch.clone, p_cpu), opt.init(p_cpu), None)
    dev = TL.TrainState(p_card, opt.init(p_card), None)
    for i in range(2):
        dev, m_card = step(dev, on_card)
        cpu, m_cpu = step(cpu, batch)
        lc, lp = float(m_card["loss"]), float(m_cpu["loss"])
        assert abs(lc - lp) <= 1e-4 * abs(lp), (i, lc, lp)
    assert tops.kernel_launches()["flash_attention_bwd"] == 2 * cfg.n_layers


# --------------------------------------------------------------------------
# data parallelism on the card: ranks that share the card reduce through
# gloo, a rank with a card of its own through NCCL
# --------------------------------------------------------------------------

def _dp_card_rank(mesh):
    """Two ranks on cuda:0: the collectives on card tensors (fp32 and
    bf16) bitwise the local mean, and the device-sampled lockstep step's
    synced gradients bitwise the mean of both shards' 1-rank gradients."""
    from repro_torch import dist as tdist
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.core.patch import patched
    from repro_torch.data import make_dataset
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.sampling import DeviceSampler, device_graph_from_csr
    from repro_torch.train import gnn_minibatch as mb
    r, dev = mesh.index("data"), mesh.device
    gen = torch.Generator(device=dev)
    xs = [{"f": torch.randn(1000, 37, generator=gen.manual_seed(s),
                            device=dev),
           "h": torch.randn(513, generator=gen.manual_seed(s + 9),
                            device=dev).to(torch.bfloat16)} for s in (0, 1)]
    mean = tree_map(lambda a, b: (a + b) / 2, xs[0], xs[1])
    synced = tdist.sync_grads(xs[r], mesh)
    coll_ok = all(torch.equal(a, b) for a, b in zip(tree_leaves(synced),
                                                    tree_leaves(mean)))
    q = tdist.sync_grads(xs[r], mesh, wire="int8")["f"]
    amax = torch.maximum(xs[0]["f"].abs().max(), xs[1]["f"].abs().max())
    int8_ok = bool((q - mean["f"]).abs().max() <= amax / 127)
    agree = bool(tdist.all_agree(torch.tensor(r == 0, device=dev), mesh))

    ds = make_dataset("reddit", scale=1 / 64, seed=1)
    csr = tsp.csr_from_coo(ds.coo)
    init, _, apply, _ = mb.make_block_model("sage-mean", ds.num_features, 64,
                                            ds.num_classes, 2)
    params = init(torch.Generator().manual_seed(0), device=dev)
    opt = adamw(1e-2)
    sampler = DeviceSampler(device_graph_from_csr(csr, device=dev), (10, 25),
                            batch_size=256, seed=0)
    sampler.set_plans([KernelPlan(kind="ell")] * 2)
    seeds = torch.arange(512, dtype=torch.int32, device=dev).reshape(2, 256)
    x, y = ds.x.to(dev), ds.y.to(dev)

    def run(step, shard, rnd):
        with patched(True):     # the ordered sums: bitwise on the card
            return step(params, opt.init(params), seeds[shard], 256, rnd,
                        x, y, mb.init_step_stats(dev), step_idx=0)
    one = mb.make_device_minibatch_step(apply, opt, sampler, batch_size=256)
    local = [run(one, s, 6 + s) for s in (0, 1)]   # the rank adds its shard
    dp = mb.make_device_minibatch_step(apply, opt, sampler, batch_size=256,
                                       mesh=mesh)
    got = run(dp, r, 6)
    same = run(dp, 0, 6 - r)                          # both on shard 0
    gmean = tree_map(lambda a, b: (a + b) / 2, local[0][3], local[1][3])
    eq = lambda a, b: all(torch.equal(u, v) for u, v in zip(  # noqa: E731
        tree_leaves(a), tree_leaves(b)))
    return dict(backend=mesh.backend, device=str(dev), coll_ok=coll_ok,
                int8_ok=int8_ok, agree=agree, step_ok=eq(got[3], gmean),
                same_ok=eq(same[3], local[0][3]) and eq(same[0], local[0][0]),
                replicas=tdist.replicas_equal(got[0], mesh),
                launches=dict(tops.kernel_launches()))


def test_data_parallel_ranks_share_the_card_through_gloo(card, tmp_path):
    from repro_torch import dist as tdist
    from repro_torch.kernels.build import build_kernels
    build_kernels()             # the ranks load what the parent built
    res = tdist.run_ranks(_dp_card_rank, 2, str(tmp_path), device="cuda",
                          timeout_s=300)
    for got in res:
        flags = {k: got[k] for k in ("coll_ok", "int8_ok", "step_ok",
                                     "same_ok", "replicas")}
        assert got["backend"] == "gloo" and got["device"] == "cuda:0"
        assert all(flags.values()) and not got["agree"], flags
        assert got["launches"]["sample_hop"] > 0, got["launches"]
        assert got["launches"]["segment_sum"] > 0, got["launches"]


def _nccl_rank(mesh):
    from repro_torch import dist as tdist
    g = {"w": torch.randn(4096, 33, device=mesh.device)}
    out = tdist.sync_grads(g, mesh)
    return dict(backend=mesh.backend, same=torch.equal(out["w"], g["w"]),
                fresh=out["w"].data_ptr() != g["w"].data_ptr())


def test_one_rank_nccl_mesh_reduces_on_the_card(card, tmp_path):
    from repro_torch import dist as tdist
    got, = tdist.run_ranks(_nccl_rank, 1, str(tmp_path), device="cuda",
                           timeout_s=120)
    assert got == dict(backend="nccl", same=True, fresh=True)


# --------------------------------------------------------------------------
# the distributed GNN path: the ranks' kernels on band and tile shapes
# --------------------------------------------------------------------------

def _hub_graph(rng, n=1200, m=3000, nnz=9000, hub=2600):
    """A random graph with a hub row of ``hub`` neighbours (its SELL slice
    longer than ``CHUNK_STEPS``: the split route) in band 0 / tile 0."""
    lin = rng.choice(n * m, size=nnz, replace=False)
    dst, src = lin // m, lin % m
    hub_cols = rng.choice(m, size=hub, replace=False)
    dst = np.concatenate([dst[dst != 3], np.full(hub, 3)])
    src = np.concatenate([src[lin // m != 3], hub_cols])
    val = rng.standard_normal(dst.shape[0]).astype(np.float32)
    return tsp.coo_from_edges(src, dst, val, n, m)


def _row_bound(op, h):
    """2 d eps sum|terms| a row: d the row's slots."""
    abs_op = dataclasses.replace(op, val=op.val.abs())
    plain = sell_spmm_plain if isinstance(op, tsp.SELL) else ell_spmm_plain
    mag = plain(abs_op, h.abs())
    d = torch.bincount((_slot_rows_cpu(op))[op.idx.reshape(-1) < op.ncols]
                       .long(), minlength=op.nrows).float()[:, None]
    return 2 * (d + 1) * EPS32 * mag + 1e-30


def _slot_rows_cpu(op):
    from repro_torch.dist.gnn import _slot_rows
    return _slot_rows(op)


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_dist_band_and_tile_kernels_match_plain(card, kind):
    """The 1-D bands (global column ids, sentinel ``ncols``) and the 2 x 2
    tiles (local ids, sentinel ``cols_per_tile``) through the ELL / SELL
    kernel, kernel E over their slots and kernel S over their column
    order, each against its plain version on the same piece; the hub
    band's SELL launch takes the split route."""
    from repro_torch import dist as tdist
    from repro_torch.core.autotune import KernelPlan
    from repro_torch.kernels import segment_sum as kseg
    from repro_torch.kernels.edge_dots import edge_dots, edge_dots_plain
    rng = np.random.default_rng(11)
    a = _hub_graph(rng)
    plan = KernelPlan(kind="sell", sell_c=8) if kind == "sell" else None
    g1 = tdist.build_dist_graph(a, 4, plan=plan)
    g2 = tdist.partition_2d(a, 2, 2, plan=plan)
    pieces = [(f"band{p}", g1.band(p, "cpu")) for p in range(4)] + \
        [(f"tile{p}", g2.tile(p, "cpu")) for p in range(4)]
    if kind == "ell":   # the tiles' sentinel is cols_per_tile
        assert bool((g2.tile(0, "cpu").op.idx == g2.cols_per_tile).any())
    tops.reset_kernel_launches()
    from repro_torch.dist.gnn import Band
    for name, cpu in pieces:
        dev = Band.make(cpu.op, cpu.inv_deg, cpu.index, card)
        h = _h(rng, cpu.op.ncols, 64)
        got = (tops.sell_spmm if kind == "sell" else tops.ell_spmm)(
            dev.op, h.to(card)).cpu()
        want = (sell_spmm_plain if kind == "sell" else ell_spmm_plain)(
            cpu.op, h)
        assert ((got - want).abs() <= _row_bound(cpu.op, h)).all(), name
        dout = _h(rng, cpu.op.nrows, 64)
        got = kseg.gather_scale_sum(dout.to(card), dev.col_order,
                                    dev.weight).cpu()
        want = kseg.gather_scale_sum(dout, cpu.col_order, cpu.weight)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
        got = edge_dots(dout.to(card), h.to(card), dev.rows, dev.cols).cpu()
        want = edge_dots_plain(dout, h, cpu.rows, cpu.cols)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    torch.cuda.synchronize()
    la = tops.kernel_launches()
    assert la["ell_spmm" if kind == "ell" else "sell_spmm"] == 8
    assert la["segment_sum"] >= 8 and la["edge_dots"] == 8
    if kind == "sell":
        from repro_torch.kernels.sell_spmm import sell_spmm_cuda
        assert sell_spmm_cuda.launches_by_instance["split"] >= 1


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_dist_ops_on_one_card_match_the_cpu(card, kind):
    """One band and the 1 x 1 grid on the card (the collectives are
    identities): SpMM forward and gradient, SDDMM, FusedMM with its
    gradients, against the same calls on the CPU (plain versions)."""
    from repro_torch import dist as tdist
    from repro_torch.core.autotune import KernelPlan
    rng = np.random.default_rng(5)
    a = _hub_graph(rng)
    plan = KernelPlan(kind="sell", sell_c=8) if kind == "sell" else None
    g1 = tdist.build_dist_graph(a, 1, plan=plan)
    g2 = tdist.partition_2d(a, 1, plan=plan)
    h, x = _h(rng, a.ncols, 64), _h(rng, a.nrows, 32)
    y = _h(rng, a.ncols, 32)

    def run(device):
        data = tdist.make_data_mesh(device=device)
        grid = tdist.make_grid_mesh(device=device)
        band, tile = g1.local(data), g2.local(grid)
        hh, xx, yy = (t.to(device).requires_grad_() for t in (h, x, y))
        out = {"spmm": tdist.distributed_spmm(band, hh, data, "mean")}
        out["spmm"].square().sum().backward()
        out["dh_spmm"] = hh.grad
        out["spmm2d"] = tdist.distributed_spmm_2d(tile, hh.detach(), grid)
        out["sddmm"] = tdist.distributed_sddmm_2d(tile, xx.detach(),
                                                  yy.detach(), grid)
        hh.grad = None
        for op in ("softmax", "sigmoid", "none"):
            f = tdist.distributed_fusedmm_2d(tile, xx, yy, hh, grid,
                                             edge_op=op)
            f.square().sum().backward()
            out[op] = f
            for n_, t in zip("xyh", (xx, yy, hh)):
                out[f"{op}_d{n_}"] = t.grad
                t.grad = None
        return {k: v.detach().cpu() for k, v in out.items()}

    tops.reset_kernel_launches()
    got = run("cuda")
    torch.cuda.synchronize()
    la = tops.kernel_launches()
    want = run("cpu")
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(w.abs().max())),
                                   err_msg=k)
    assert la["ell_spmm" if kind == "ell" else "sell_spmm"] >= 5
    assert la["edge_dots"] >= 7 and la["segment_sum"] >= 7, la


def _dist_gnn_card_rank(mesh, edges):
    """Four ranks on the one card: 1-D SELL bands, the 2 x 2 grid's SpMM
    (ELL, compressed), SDDMM, FusedMM softmax forward and backward, the
    ring (its send / receive staged through the host)."""
    from repro_torch import dist as tdist
    from repro_torch.core.autotune import KernelPlan
    src, dst, val, n, m, h, x, y = edges
    a = tsp.coo_from_edges(src, dst, val, n, m)
    r, dev = mesh.index("data"), mesh.device
    grid = tdist.make_grid_mesh(device="cuda")
    sell = KernelPlan(kind="sell", sell_c=8)
    h, x, y = (torch.from_numpy(t) for t in (h, x, y))
    tops.reset_kernel_launches()
    tdist.reset_wire_stats()
    g1 = tdist.build_dist_graph(a, 4, plan=sell)
    out = {"spmm1d": tdist.distributed_spmm(
        g1.local(mesh), tdist.shard_rows(h, 4, r).to(dev), mesh)}
    g2 = tdist.partition_2d(a, 2, 2)
    tile = g2.local(grid)
    p = tile.index
    hc = tdist.col_shard(g2, h, p).to(dev)
    out["spmm2d"] = tdist.distributed_spmm_2d(tile, hc, grid)
    out["spmm2d_c"] = tdist.distributed_spmm_2d(tile, hc, grid,
                                                compress=True)
    xr = tdist.row_shard(g2, x, p).to(dev).requires_grad_()
    yc = tdist.col_shard(g2, y, p).to(dev).requires_grad_()
    hc = hc.clone().requires_grad_()
    out["sddmm"] = tdist.distributed_sddmm_2d(tile, xr.detach(), yc.detach(),
                                              grid)
    f = tdist.distributed_fusedmm_2d(tile, xr, yc, hc, grid)
    f.square().sum().backward()
    out.update(fused=f, dx=xr.grad, dy=yc.grad, dh=hc.grad)
    dense_band = torch.zeros(n // 4, n, device=dev)
    ring_a = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n, n)).astype(np.float32))
    dense_band.copy_(ring_a[r * (n // 4):(r + 1) * (n // 4)])
    out["ring"] = tdist.ring_allgather_matmul(
        lambda s: dense_band[:, s * (n // 4):(s + 1) * (n // 4)],
        h[r * (n // 4):(r + 1) * (n // 4)].to(dev), mesh, "data")
    torch.cuda.synchronize()
    on_card = all(t.device.type == "cuda" for t in out.values())
    return dict(rank=r, tile=p, coords=(grid.index("row"), grid.index("col")),
                backend=mesh.backend, device=str(dev), on_card=on_card,
                launches=tops.kernel_launches(), wire=tdist.wire_stats(),
                out={k: v.detach().cpu().numpy() for k, v in out.items()})


def test_dist_gnn_four_ranks_share_the_card(card, tmp_path):
    """Four gloo ranks on cuda:0 against the same calls in one process on
    the CPU: every output and gradient within 1e-4 (compressed within
    ``pc * amax / 127``), the ranks' kernels launched, the ring's hops
    staged through the host and nothing else."""
    from repro_torch import dist as tdist
    from repro_torch.kernels.build import build_kernels
    from repro_torch.kernels.ref import fusedmm_coo_ref
    build_kernels()
    rng = np.random.default_rng(2)
    n = 3000
    a = _hub_graph(rng, n=n, m=n)
    src, dst, val = (t[: a.nse].numpy() for t in (a.col, a.row, a.val))
    h, x, y = _h(rng, n, 64), _h(rng, n, 32), _h(rng, n, 32)
    res = tdist.run_ranks(_dist_gnn_card_rank, 4, str(tmp_path),
                          args=((src, dst, val, n, n, h.numpy(), x.numpy(),
                                 y.numpy()),), device="cuda", timeout_s=300)
    dense = torch.zeros(n, n)
    dense[torch.from_numpy(dst).long(), torch.from_numpy(src).long()] = \
        torch.from_numpy(val)
    want = dense @ h
    cat = (lambda key: np.concatenate([r["out"][key] for r in res])[:n])
    for key in ("spmm1d", "spmm2d"):
        np.testing.assert_allclose(cat(key), want.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    cpt = -(-n // 2)
    parts = [dense[:, j * cpt:(j + 1) * cpt] @ h[j * cpt:(j + 1) * cpt]
             for j in range(2)]
    bound = 2 * max(float(q.abs().max()) for q in parts) / 127 + 1e-6
    assert float(np.abs(cat("spmm2d_c") - want.numpy()).max()) <= bound
    xg, yg, hg = (t.clone().requires_grad_() for t in (x, y, h))
    f = fusedmm_coo_ref(a, xg, yg, hg)
    f.square().sum().backward()
    np.testing.assert_allclose(cat("fused"), f.detach().numpy(), atol=1e-4)
    g2 = tdist.partition_2d(a, 2, 2)
    cm = [None] * 4
    for r in res:
        i, j = r["coords"]
        cm[j * 2 + i] = r
    for key, leaf, major in (("dx", xg, "row"), ("dy", yg, "col"),
                             ("dh", hg, "col")):
        order = res if major == "row" else cm
        got = np.concatenate([r["out"][key] for r in order])[:n]
        w = leaf.grad.numpy()
        assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max(), key
    s = np.stack([r["out"]["sddmm"] for r in res])
    np.testing.assert_allclose(tdist.scores_to_dense(g2, s),
                               (x @ y.T * dense).numpy(), atol=1e-4)
    ring_a = np.random.default_rng(9).standard_normal((n, n)).astype(
        np.float32)
    np.testing.assert_allclose(cat("ring"), ring_a @ h.numpy(), rtol=1e-4,
                               atol=1e-3)
    for r in res:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert r["on_card"]
        for k in ("sell_spmm", "ell_spmm", "edge_dots", "segment_sum"):
            assert r["launches"][k] > 0, (k, r["launches"])
        w = r["wire"]
        assert w["ppermute"]["calls"] == 3 and \
            w["ppermute"]["staged_bytes"] == 2 * w["ppermute"]["bytes"]
        assert all(v["staged_bytes"] == 0 for k, v in w.items()
                   if k != "ppermute")


def _tp_card_rank(mesh, arch):
    """Two ranks on the one card as one 'model' axis: an fp32 smoke
    config's loss and gradients (gathered), then prefill and 2 decode
    steps, through the kernels' fp32 instances."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.dist.partition import gather_params, shard_params
    from repro_torch.models.lm import transformer as TT
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    cfg = get_smoke_config(arch)
    dev = mesh.device
    local = shard_params(mesh, TT.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), device=dev)
    toks, tgts = synthetic_lm_batch(2, 64, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "targets": torch.from_numpy(tgts).to(dev)}
    tops.reset_kernel_launches()
    with mesh:
        loss, _, grads = TL.loss_and_grads(cfg, local, batch)
        with torch.no_grad():
            cache, lg = TT.prefill(cfg, local, {"tokens": batch["tokens"]},
                                   80)
            logits = [lg]
            for i in range(2):
                lg, cache = TT.decode_step(cfg, local, cache,
                                           batch["tokens"][:, i:i + 1])
                logits.append(lg)
    whole = gather_params(mesh, grads, TL.full_param_shapes(cfg))
    torch.cuda.synchronize()
    return dict(backend=mesh.backend, loss=float(loss),
                launches=dict(tops.kernel_launches()),
                grads=tree_map(lambda t: t.cpu().numpy(), whole),
                logits=[t.cpu().numpy() for t in logits])


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2-1.5b"])
def test_tp_two_model_ranks_share_the_card(card, tmp_path, arch):
    """Two gloo ranks on cuda:0 as one 'model' axis (the kernels' fp32
    instances) against the same calls in one process on the CPU (the
    plain versions): the loss, every gradient and the logits of a
    prefill and 2 decode steps within 1e-4 of the largest value (the
    fp32 smoke configs' card-against-CPU tolerance, ``chip_smoke.py``'s
    LM_SMOKE_ATOL); the flash and ragged kernels launched on each rank."""
    from repro_torch import dist as tdist
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.kernels.build import build_kernels
    from repro_torch.models.lm import transformer as TT
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    build_kernels()
    res = tdist.run_ranks(_tp_card_rank, 2, str(tmp_path), args=(arch,),
                          device="cuda", timeout_s=300, model=2)
    cfg = get_smoke_config(arch)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks, tgts = synthetic_lm_batch(2, 64, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)}
    loss, _, grads = TL.loss_and_grads(cfg, params, batch)
    with torch.no_grad():
        cache, lg = TT.prefill(cfg, params, {"tokens": batch["tokens"]}, 80)
        want = [lg]
        for i in range(2):
            lg, cache = TT.decode_step(cfg, params, cache,
                                       batch["tokens"][:, i:i + 1])
            want.append(lg)

    def close(got, w, what):
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        assert np.abs(got - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), \
            what
    for r in res:
        assert r["backend"] == "gloo"
        assert abs(r["loss"] - float(loss)) <= 1e-4 * abs(float(loss))
        tree_map(lambda g, w: close(g, w.numpy(), "grad"), r["grads"], grads)
        for got, w in zip(r["logits"], want):
            close(got, w, "logits")
        kernels = ("flash_attention", "ragged_gemm") if cfg.n_experts \
            else ("flash_attention",)
        assert all(r["launches"][k] > 0 for k in kernels), r["launches"]


def _ep_card_rank(mesh, arch):
    """Four ranks on the one card as one 'model' axis of phi3.5's four
    experts, the attention whole (``WHOLE_ATTENTION_RULES``): the MoE
    layers through the manual path; an fp32 smoke config's loss and
    gradients (gathered), then prefill and 2 decode steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.dist import WHOLE_ATTENTION_RULES, use_rules
    from repro_torch.dist.partition import gather_params
    from repro_torch.models.lm import transformer as TT
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    cfg = get_smoke_config(arch)
    dev = mesh.device
    with use_rules(WHOLE_ATTENTION_RULES):
        local = TT.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu", mesh=mesh)
        toks, tgts = synthetic_lm_batch(2, 64, cfg.vocab)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "targets": torch.from_numpy(tgts).to(dev)}
        tops.reset_kernel_launches()
        with mesh:
            loss, _, grads = TL.loss_and_grads(cfg, local, batch)
            train_launches = dict(tops.kernel_launches())
            with torch.no_grad():
                cache, lg = TT.prefill(cfg, local,
                                       {"tokens": batch["tokens"]}, 80)
                logits = [lg]
                for i in range(2):
                    lg, cache = TT.decode_step(cfg, local, cache,
                                               batch["tokens"][:, i:i + 1])
                    logits.append(lg)
        whole = gather_params(mesh, grads, TL.full_param_shapes(cfg))
    torch.cuda.synchronize()
    return dict(backend=mesh.backend, loss=float(loss),
                train_launches=train_launches,
                launches=dict(tops.kernel_launches()),
                grads=tree_map(lambda t: t.cpu().numpy(), whole),
                logits=[t.cpu().numpy() for t in logits])


def test_ep_four_model_ranks_take_the_manual_path_on_the_card(card,
                                                              tmp_path):
    """Four gloo ranks on cuda:0 as a 'model' axis of phi3.5's smoke
    config's four experts (the kernels' fp32 instances; the MoE through
    the manual path: an all-to-all of card tensors) against the
    one-process model on the CPU with its MoE layers
    ``moe_manual_reference`` for a 'model' axis of 4 (the transformer's
    ``moe_layer`` swapped for it where the ranks take the manual path,
    as ``tests/test_torch_expert_parallel.py`` does): the loss, every
    gradient and the logits of a prefill and 2 decode steps within 1e-4
    of the largest value, as the two-rank case above; the train step
    launched the flash kernels and no ragged GEMM (the manual path's
    expert products are dense), decode the ragged GEMM (the split
    einsum)."""
    from repro_torch import dist as tdist
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.kernels.build import build_kernels
    from repro_torch.models.lm import moe as TM
    from repro_torch.models.lm import transformer as TT
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train import lm as TL
    arch = "phi3.5-moe-42b-a6.6b"
    build_kernels()
    res = tdist.run_ranks(_ep_card_rank, 4, str(tmp_path), args=(arch,),
                          device="cuda", timeout_s=300, model=4)
    cfg = get_smoke_config(arch)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks, tgts = synthetic_lm_batch(2, 64, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)}
    plain = TT.moe_layer

    def manual(cfg_, p, x):
        if x.shape[1] % 4 == 0:
            return TM.moe_manual_reference(cfg_, p, x, 4)
        return plain(cfg_, p, x)

    TT.moe_layer = manual
    try:
        loss, _, grads = TL.loss_and_grads(cfg, params, batch)
        with torch.no_grad():
            cache, lg = TT.prefill(cfg, params, {"tokens": batch["tokens"]},
                                   80)
            want = [lg]
            for i in range(2):
                lg, cache = TT.decode_step(cfg, params, cache,
                                           batch["tokens"][:, i:i + 1])
                want.append(lg)
    finally:
        TT.moe_layer = plain

    def close(got, w, what):
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        assert np.abs(got - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), \
            what
    for r in res:
        assert r["backend"] == "gloo"
        assert abs(r["loss"] - float(loss)) <= 1e-4 * abs(float(loss))
        tree_map(lambda g, w: close(g, w.numpy(), "grad"), r["grads"], grads)
        for got, w in zip(r["logits"], want):
            close(got, w, "logits")
        t = r["train_launches"]
        assert t["flash_attention"] > 0 and t["flash_attention_bwd"] > 0, t
        assert t["ragged_gemm"] == 0, t
        assert r["launches"]["ragged_gemm"] > 0, r["launches"]
