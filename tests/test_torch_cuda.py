"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where no CUDA card
is present (the kernels have no CPU mode); the file imports no JAX, so it
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: fp32, atol 1e-5 / rtol 1e-5 — the kernel sums a row's slots
in slot order with fma, the plain version with ``sum(dim=1)`` /
``index_add_``; at most ~30 terms of magnitude ~1 per output here."""
import numpy as np
import pytest
import torch

from repro_torch.core import sparse as tsp
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ell_spmm import ell_spmm_cuda, ell_spmm_plain
from repro_torch.kernels.sell_spmm import sell_spmm_cuda, sell_spmm_plain

TOL = dict(atol=1e-5, rtol=1e-5)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
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
    assert tops.kernel_launches() == {"ell_spmm": 1, "sell_spmm": 2}
    with pytest.raises(ValueError, match="contiguous fp32"):
        tops.ell_spmm(ell, h.t().contiguous().t())
    with pytest.raises(ValueError, match="rows"):
        tops.ell_spmm(ell, h[:10])
    with pytest.raises(ValueError, match="contiguous fp32"):
        tops.sell_spmm(sell, h.double())
    assert tops.kernel_launches() == {"ell_spmm": 1, "sell_spmm": 2}


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
