"""The per-edge SDDMM (``kernels/edge_dots``), the redesigned ordered
segment sum's new entry points, and the card's routes of the gat
backward, the public ``sddmm`` and the trusted block path, on the CPU,
against the JAX reference.

* The dispatcher on CPU tensors against ``ref.edge_dots``: **bitwise**
  (it is that function), for one product and for two in one call.
* A lane-by-lane emulation of ``csrc/edge_dots.cu``'s sum order (an
  8-lane group an edge, lane t summing d = 32 c + 4 t + e with fma, then
  the xor 4, 2, 1 tree) against the plain version within 2 (D + 1) eps
  sum_d |x_d y_d| per edge: two fp32 sums of the same D products in
  other orders.
* The segment sum's weight index and an order's cached sorted index
  (the plain version, which the card's kernel equals bit for bit where a
  target fits one piece): **bitwise** against weights and indices
  permuted beforehand and against ``index_add_`` in entry order.
* The card's routes run here through the plain versions (the
  ``card_routes`` fixture: ``on_card`` says yes, the segment-sum kernel
  is its plain version): ``core.fusedmm`` forward and gradients (one
  dual per-edge call in the backward),
  ``core.sddmm`` forward and gradients, and the trusted block path's
  ``autograd.Function`` of step 0's block (sum, mean, max), against
  ``jax.grad`` through ``repro``. Tolerances as the reference's own
  tests: rtol 1e-4 / atol 1e-4 for values, rtol 1e-3 / atol 1e-3 for
  FusedMM / SDDMM gradients; the block path rtol 1e-5, atol 1e-6 x
  max(1, max|ref|) (sums of at most 6 terms).

Inputs are made with numpy from a seed; widths D, K in {8, 112, 256}."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.autotune import KernelPlan as JPlan
from repro.core.fusedmm import fusedmm as jax_fusedmm
from repro.core.patch import patched as jax_patched
from repro.core.sddmm import sddmm as jax_sddmm
from repro.data import make_dataset as jax_make_dataset
from repro.kernels import ops as jops
from repro.sampling import NeighborSampler as JSampler
from repro.sampling import block_spmm as jax_block_spmm
from repro.sampling import pack_block as jax_pack_block

from repro_torch.core import fusedmm as tfused
from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.cache import build_cached_graph
from repro_torch.core.patch import patched
from repro_torch.core.sddmm import sddmm
from repro_torch.data import make_dataset
from repro_torch.kernels import edge_dots as ked
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_sum as tss
from repro_torch.sampling import NeighborSampler, block_spmm, pack_block
from repro_torch.sampling import blocks as tblocks

from conftest import random_coo

EPS32 = 2.0 ** -24
WIDTHS = [8, 112, 256]
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)


def _edges(rng, n=300, m=280, nnz=3000, hub=400):
    """Row-sorted edges with a hub row (``hub`` entries) and a few ids out
    of range on either side (they read zero rows)."""
    row = np.concatenate([rng.integers(0, n, nnz), np.full(hub, 7)])
    col = rng.integers(0, m, row.shape[0])
    row[rng.integers(0, row.shape[0], 5)] = n          # out of range
    col[rng.integers(0, row.shape[0], 5)] = -1
    order = np.lexsort((col, row))
    return (torch.from_numpy(row[order].astype(np.int32)),
            torch.from_numpy(col[order].astype(np.int32)))


def _mat(rng, n, d):
    return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))


# --------------------------------------------------------------------------
# the per-edge SDDMM: dispatcher and the kernel's sum order
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", WIDTHS)
def test_dispatcher_on_cpu_is_the_plain_edge_dots(d):
    rng = np.random.default_rng(d)
    row, col = _edges(rng)
    x, y = _mat(rng, 300, d), _mat(rng, 280, d)
    x2, y2 = _mat(rng, 300, 24), _mat(rng, 280, 24)
    want = tref.edge_dots(x, y, row, col)
    assert torch.equal(ked.edge_dots(x, y, row, col), want)
    s, s2 = ked.edge_dots(x, y, row, col, x2, y2)
    assert torch.equal(s, want)
    assert torch.equal(s2, tref.edge_dots(x2, y2, row, col))
    assert ked.edge_dots_cuda.launches == 0


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def butterfly(p):
    """An 8-lane group's xor-shuffle sum over the last axis."""
    lanes = torch.arange(8)
    for o in (4, 2, 1):
        p = p + p[..., lanes ^ o]
    return p[..., 0]


def emulate_edge_dots(x, y, row, col):
    """``edge_dots_kernel``'s output: lane t of an edge's group sums
    d = 32 c + 4 t + e (e = 0..3) in order with fma (past D: nothing,
    here a zero product), then the group's xor tree."""
    d = x.shape[1]
    dp = -(-d // 32) * 32
    n = row.shape[0]
    xs = torch.zeros((n, dp))
    ys = torch.zeros((n, dp))
    xs[:, :d] = tref.take_rows(x, row)
    ys[:, :d] = tref.take_rows(y, col)
    xv, yv = xs.view(n, dp // 32, 8, 4), ys.view(n, dp // 32, 8, 4)
    p = torch.zeros((n, 8))
    for c in range(dp // 32):
        for e in range(4):
            p = fma(xv[:, c, :, e], yv[:, c, :, e], p)
    return butterfly(p)


@pytest.mark.parametrize("d", WIDTHS + [7, 130])
def test_kernel_sum_order_emulated_within_bound(d):
    rng = np.random.default_rng(10 + d)
    row, col = _edges(rng)
    x, y = _mat(rng, 300, d), _mat(rng, 280, d)
    got = emulate_edge_dots(x, y, row, col)
    want = tref.edge_dots(x, y, row, col)
    mag = tref.edge_dots(x.abs(), y.abs(), row, col)
    err = (got - want).abs()
    assert (err <= 2 * (d + 1) * EPS32 * mag + 1e-30).all(), \
        float((err / (mag + 1e-30)).max())
    # ids out of range read zero rows: their scores are exactly 0
    bad = (row >= 300) | (col < 0)
    assert bad.any() and (got[bad] == 0).all() and (want[bad] == 0).all()


def test_cuda_wrapper_takes_no_cpu_tensor():
    rng = np.random.default_rng(1)
    row, col = _edges(rng, nnz=10, hub=0)
    x = _mat(rng, 300, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ked.edge_dots_cuda(x, x, row, col)
    with pytest.raises(ValueError, match="CUDA"):
        ked.edge_dots_cuda(x, x, row, col, x, x)
    assert ked.edge_dots_cuda.launches == 0


# --------------------------------------------------------------------------
# the segment sum's weight index and cached sorted index (plain, which
# the kernel equals bit for bit where a target fits one piece)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", WIDTHS)
def test_weight_index_and_cached_index_equal_the_permuted_sums(k):
    rng = np.random.default_rng(20 + k)
    tgt = torch.from_numpy(rng.integers(0, 50, 900).astype(np.int32))
    src_ids = torch.from_numpy(rng.integers(-1, 121, 900).astype(np.int32))
    order = tss.segment_order(tgt, 50, sources=src_ids)
    perm = order.perm.long()
    assert torch.equal(order.src, src_ids[perm])
    a = _mat(rng, 120, k)
    w = torch.from_numpy(rng.standard_normal(900).astype(np.float32))
    want = tss.segment_sum_sorted_plain(
        a, order.offsets, index=src_ids[perm].int(), weight=w[perm])
    got = tss.segment_sum_sorted(a, order.offsets, index=order.src,
                                 weight=w, weight_index=order.perm)
    assert torch.equal(got, want)
    # gather_scale_sum reads the order's own sorted index and the weights
    # through perm: the index_add_ over the entries in entry order
    ok = (src_ids >= 0) & (src_ids < 120)
    ref = torch.zeros((50, k)).index_add_(
        0, tgt[ok].long(), w[ok][:, None] * a[src_ids[ok].long()])
    assert torch.equal(tss.gather_scale_sum(a, order, w), ref)


def test_gather_scale_sum_needs_the_orders_sorted_index():
    """An order built without the entries' sources cannot be summed
    through: the sorted index is the order's, never a second argument."""
    tgt = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    bare = tss.segment_order(tgt, 3)
    assert bare.src is None
    with pytest.raises(ValueError, match="sorted index"):
        tss.gather_scale_sum(torch.ones((4, 8)), bare)


def test_cached_graph_orders_carry_their_sorted_sources():
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    g = build_cached_graph(ds.coo, tune=False)
    n = ds.coo.nse
    row, col = ds.coo.row[:n], ds.coo.col[:n]
    assert torch.equal(g.row_order.src, col)
    assert torch.equal(g.col_order.src, row[g.col_order.perm.long()])
    assert g.row_order.src.dtype == g.col_order.src.dtype == torch.int32


# --------------------------------------------------------------------------
# the card's routes, through the plain versions, against the reference
# --------------------------------------------------------------------------

@pytest.fixture()
def card_routes(monkeypatch):
    """The card's routes on the CPU: ``on_card`` says yes and the
    segment-sum kernel is its plain version."""
    monkeypatch.setattr(tss, "on_card", lambda t: True)
    monkeypatch.setattr(tss, "segment_sum_sorted_cuda",
                        tss.segment_sum_sorted_plain)


@pytest.fixture()
def pallas_fusedmm(monkeypatch):
    """The reference's ``core.fusedmm`` on its fused route, through the
    Pallas kernel in interpret mode (its XLA route reads shifted rows on
    unpadded operands)."""
    monkeypatch.setattr(jops, "fusedmm_bsr",
                        functools.partial(jops.fusedmm_bsr, interpret=True))


def _port_coo(coo):
    return tsp.coo_from_edges(np.asarray(coo.col)[: coo.nse],
                              np.asarray(coo.row)[: coo.nse],
                              np.asarray(coo.val)[: coo.nse],
                              coo.nrows, coo.ncols)


def _graphs(rng, plan, k):
    ref, _ = random_coo(rng, 90, 70, 600)
    jg = C.build_cached_graph(ref, k_hint=k, plan=JPlan(**plan))
    tg = build_cached_graph(_port_coo(ref), k_hint=k,
                            plan=KernelPlan(**plan))
    return jg, tg


@pytest.mark.parametrize("edge_op", ["softmax", "sigmoid", "none"])
@pytest.mark.parametrize("d,k", [(8, 8), (112, 112), (16, 24)])
def test_fusedmm_card_route_matches_reference(card_routes, pallas_fusedmm,
                                              monkeypatch, edge_op, d, k):
    """Layer 2's trusted forward (K not a multiple of 128) and the
    recompute backward as the card runs them: one per-edge call for the
    forward's scores and one dual call (s and dw) in the backward; every
    scatter an ordered sum over the graph's cached orders."""
    rng = np.random.default_rng(d + k)
    jg, tg = _graphs(rng, dict(kind="bsr", br=32, bc=128), k)
    x, y = _mat(rng, 90, d), _mat(rng, 70, d)
    h, c = _mat(rng, 70, k), _mat(rng, 90, k)

    def jloss(xx, yy, hh):
        return jnp.sum(jax_fusedmm(jg, xx, yy, hh, edge_op=edge_op)
                       * c.numpy())
    jargs = tuple(jnp.asarray(t.numpy()) for t in (x, y, h))
    want = np.asarray(jax_fusedmm(jg, *jargs, edge_op=edge_op))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    dots, sums = [], []
    real_dots, real_sum = tfused.edge_dots, tss.gather_scale_sum

    def spy_dots(*a):
        dots.append(len(a))
        return real_dots(*a)

    def spy_sum(src, order, *a):
        sums.append(order.src is not None)
        return real_sum(src, order, *a)
    monkeypatch.setattr(tfused, "edge_dots", spy_dots)
    monkeypatch.setattr(tss, "gather_scale_sum", spy_sum)
    args = tuple(t.clone().requires_grad_(True) for t in (x, y, h))
    got = tfused.fusedmm(tg, *args, edge_op=edge_op)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert dots == [4]
    grads = torch.autograd.grad((got * c).sum(), args)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    assert dots == [4, 6]                  # the backward: one dual call
    # the forward's sum and the backward's dx, dy, dh, each over a cached
    # order with its sorted index
    assert sums == [True] * 4


@pytest.mark.parametrize("scale_by_a", [True, False])
def test_sddmm_card_route_matches_reference(card_routes, scale_by_a):
    rng = np.random.default_rng(3)
    jg, tg = _graphs(rng, dict(kind="trusted"), 16)
    x, y = _mat(rng, 90, 16), _mat(rng, 70, 16)
    c = rng.standard_normal(tg.coo.nnz_padded).astype(np.float32)

    def jloss(xx, yy):
        return jnp.sum(jax_sddmm(jg, xx, yy, scale_by_a=scale_by_a) * c)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    want = np.asarray(jax_sddmm(jg, jx, jy, scale_by_a=scale_by_a))
    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jx, jy)
    tx, ty = x.requires_grad_(True), y.requires_grad_(True)
    got = sddmm(tg, tx, ty, scale_by_a=scale_by_a)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    gx, gy = torch.autograd.grad((got * torch.from_numpy(c)).sum(),
                                 (tx, ty))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), **GRAD_TOL)


@pytest.fixture(scope="module")
def graphs():
    return (C.csr_from_coo(jax_make_dataset("reddit", scale=1 / 512,
                                            seed=1).coo),
            tsp.csr_from_coo(make_dataset("reddit", scale=1 / 512,
                                          seed=1).coo))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_trusted_block_function_matches_reference(card_routes, monkeypatch,
                                                  graphs, reduce):
    """Step 0's outermost block (seed batch 0, round 0) packed trusted:
    the card's ``autograd.Function`` (ordered sums over the block's rows
    forward and over its columns backward, sorted in place) against the
    reference's trusted ``block_spmm`` in value and gradient."""
    jcsr, tcsr = graphs
    seeds = np.arange(0, 64, 2)
    sizes = dict(n_dst=32, n_src=256, nnz=32 * 6, ell_width=6)
    jpb = jax_pack_block(JSampler(jcsr, (6,), seed=2).sample(seeds, round=0)
                         [0], plan=JPlan.trusted(8), **sizes)
    tpb = pack_block(NeighborSampler(tcsr, (6,), seed=2).sample(
        seeds, round=0)[0], plan=KernelPlan.trusted(8), **sizes)
    applied = []
    real = tblocks._TrustedSpMM.apply
    monkeypatch.setattr(tblocks._TrustedSpMM, "apply",
                        lambda *a: applied.append(1) or real(*a))
    rng = np.random.default_rng(7)
    h = rng.standard_normal((256, 8)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    with jax_patched(True):
        want_out, want_grad = jax.value_and_grad(
            lambda hh: jnp.sum(jax_block_spmm(jpb, hh, reduce) * w))(
                jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    with patched(True):
        out = block_spmm(tpb, ht, reduce)
        (out * torch.from_numpy(w)).sum().backward()
    assert applied == [1]
    np.testing.assert_allclose(float((out.detach() * torch.from_numpy(w))
                                     .sum()), float(want_out), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(
        ht.grad.numpy(), want_grad, rtol=1e-5,
        atol=1e-6 * max(1.0, float(np.abs(want_grad).max())))
