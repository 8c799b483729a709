"""The port's SDDMM / FusedMM slice against the JAX reference, on the CPU:
the plain block SDDMM and FusedMM (against the Pallas kernels in
interpret mode), ``core.sddmm`` and ``core.fusedmm`` forward and gradient
(against ``jax.grad`` through ``repro.core``), the dot-product GAT model's
logits and ``train_gnn`` loss curve, patched and unpatched, from the same
weights (``params_from_jax``).

Plans are pinned to BSR on both sides (the two tuners target different
hardware): layer 1 of gat then takes the fused route (K % 128 == 0) in
both packages, layer 2 (K = classes) the trusted composition.

The reference's fused route runs its Pallas kernel in interpret mode here
(the ``pallas_fusedmm`` fixture), as its own kernel tests do: its XLA
path slices the operands' tiles with ``dynamic_slice``, which clamps the
last block column back into range when y and h have fewer rows than the
padded BSR, and so reads other rows there. The Pallas wrapper pads.

Tolerance: fp32, rtol 1e-4 / atol 1e-4, as the reference's own SDDMM and
FusedMM tests (sums of up to ~130 products of N(0, 1) terms in another
order; softmax normalizes the weights to 1); gradients rtol 1e-3 /
atol 1e-3 as the reference's; gat losses over 5 AdamW epochs rtol 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.autotune import KernelPlan as JPlan
from repro.core.fusedmm import edge_weights as jax_edge_weights
from repro.core.fusedmm import fusedmm as jax_fusedmm
from repro.core.patch import patched as jax_patched
from repro.core.sddmm import sddmm as jax_sddmm
from repro.data import make_dataset as jax_make_dataset
from repro.kernels import ops as jops
from repro.models.gnn import build_bundle as jax_build_bundle
from repro.models.gnn import make_gnn as jax_make_gnn
from repro.train import train_gnn as jax_train_gnn

from repro_torch.core import baselines as tbase
from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.cache import build_cached_graph
from repro_torch.core.fusedmm import edge_weights, fusedmm
from repro_torch.core.patch import patched
from repro_torch.core.sddmm import masked_edge_scores, sddmm
from repro_torch.data import make_dataset
from repro_torch.kernels import fusedmm as kfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sddmm as ksddmm
from repro_torch.models.gnn import build_bundle, make_gnn, params_from_jax
from repro_torch.optim.optimizer import tree_map
from repro_torch.train.gnn import loss_and_grads, train_gnn

from conftest import random_coo

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
EDGE_OPS = ("softmax", "sigmoid", "none")
HIDDEN = 128          # gat layer 1 at K = 128 takes the fused kernel


@pytest.fixture()
def pallas_fusedmm(monkeypatch):
    """The reference's ``core.fusedmm`` on its fused route, through the
    Pallas kernel in interpret mode."""
    monkeypatch.setattr(jops, "fusedmm_bsr",
                        functools.partial(jops.fusedmm_bsr, interpret=True))


def _port_coo(coo):
    return tsp.coo_from_edges(np.asarray(coo.col)[: coo.nse],
                              np.asarray(coo.row)[: coo.nse],
                              np.asarray(coo.val)[: coo.nse],
                              coo.nrows, coo.ncols)


def _mat(rng, n, d):
    return rng.standard_normal((n, d)).astype(np.float32)


def _bsr_pair(rng, br, bc, n=300, m=280, nnz=2000):
    """The same BSR in both packages: rows 100..227 are empty, so at
    br <= 128 a block row owns only its explicit zero block; two padding
    blocks replicate the last block row."""
    ref, _ = random_coo(rng, n, m, nnz)
    keep = (np.asarray(ref.row) < 100) | (np.asarray(ref.row) >= 228)
    keep &= np.arange(ref.nnz_padded) < ref.nse
    ref = C.coo_from_edges(np.asarray(ref.col)[keep],
                           np.asarray(ref.row)[keep],
                           np.asarray(ref.val)[keep], n, m)
    nb = C.bsr_from_coo(ref, br=br, bc=bc).nblocks + 2
    want = C.bsr_from_coo(ref, br=br, bc=bc, pad_blocks_to=nb)
    got = tsp.bsr_from_coo(_port_coo(ref), br=br, bc=bc, pad_blocks_to=nb)
    for f in ("blk_row", "blk_col", "blocks"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f)))
    return want, got


# --------------------------------------------------------------------------
# the plain kernels against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 64, 130])
@pytest.mark.parametrize("scale_by_a", [True, False])
def test_sddmm_bsr_plain_matches_pallas_interpret(rng, d, scale_by_a):
    """x and y have fewer rows than the padded BSR: the rest read zero;
    unscaled scores fill every position of every stored tile."""
    want_bsr, bsr = _bsr_pair(rng, 32, 128)
    x, y = _mat(rng, 300, d), _mat(rng, 280, d)
    want = jops.sddmm_bsr(want_bsr, jnp.asarray(x), jnp.asarray(y),
                          scale_by_a=scale_by_a, interpret=True)
    got = tops.sddmm_bsr(bsr, torch.from_numpy(x), torch.from_numpy(y),
                         scale_by_a=scale_by_a)
    assert got.shape == (bsr.nblocks, 32, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not scale_by_a:
        assert (got[: bsr.n_real_blocks] != 0).float().mean() > 0.5


@pytest.mark.parametrize("edge_op", EDGE_OPS)
@pytest.mark.parametrize("br,bc", [(32, 128), (128, 128), (128, 256)])
def test_fusedmm_bsr_plain_matches_pallas_interpret(rng, edge_op, br, bc):
    """D = 40 and K = 48 unpadded, h with fewer rows than the padded
    columns; block rows of only zero tiles (br = 32) and padding blocks
    give zero rows."""
    want_bsr, bsr = _bsr_pair(rng, br, bc)
    x, y, h = _mat(rng, 300, 40), _mat(rng, 280, 40), _mat(rng, 280, 48)
    want = np.asarray(jops.fusedmm_bsr(
        want_bsr, jnp.asarray(x), jnp.asarray(y), jnp.asarray(h),
        edge_op=edge_op, interpret=True))
    got = tops.fusedmm_bsr(bsr, torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(h), edge_op=edge_op).numpy()
    assert got.shape == (bsr.nrows, 48)
    np.testing.assert_allclose(got[:300], want[:300], **TOL)
    assert (got[100:228] == 0).all() and (got[300:] == 0).all()
    assert np.abs(got[:100]).max() > 0


def test_fusedmm_plain_softmax_matches_dense_attention(rng):
    """The plain softmax FusedMM against masked dense attention: each row
    with a neighbour is a convex combination of its neighbours' h."""
    _, bsr = _bsr_pair(rng, 64, 128)
    x, y, h = _mat(rng, 300, 8), _mat(rng, 280, 8), _mat(rng, 280, 5)
    dense = np.zeros((bsr.nrows, bsr.ncols), np.float32)
    tiles = bsr.blocks.numpy()
    for b in range(bsr.nblocks):
        r, c = int(bsr.blk_row[b]), int(bsr.blk_col[b])
        dense[r * 64:(r + 1) * 64, c * 128:(c + 1) * 128] += tiles[b]
    mask = dense[:300, :280] != 0
    s = np.where(mask, x @ y.T, -np.inf)
    has = mask.any(1)
    p = np.exp(s[has] - s[has].max(1, keepdims=True))
    want = (p / p.sum(1, keepdims=True)) @ h
    got = kfused.fusedmm_bsr_plain(bsr, torch.from_numpy(x),
                                   torch.from_numpy(y), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy()[:300][has], want, **TOL)
    assert (got.numpy()[:300][~has] == 0).all()


def test_cuda_wrappers_take_no_cpu_tensor_and_size_their_smem(rng):
    """On a CPU tensor the hand kernels' wrappers raise (only the
    dispatchers run the plain versions there); the shared-memory
    reckoning matches the kernels' layout."""
    _, bsr = _bsr_pair(rng, 32, 128)
    x = torch.zeros((300, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ksddmm.sddmm_bsr_cuda(bsr, x, x[:280])
    with pytest.raises(ValueError, match="CUDA tensors"):
        kfused.fusedmm_bsr_cuda(bsr, x, x[:280], x[:280])
    # D = K = 256 at bc = 128: x slice 32 KB, weight tile 18 KB, and the
    # shared y-step / h-rows buffer at its h-rows size 32 KB
    assert kfused.smem_bytes(128, 256, 256) == 4 * (32 * 256 + 128 * 36 +
                                                    32 * 256)
    assert ksddmm.score_smem_bytes(128, 130) == 4 * (32 * 160 + 128 * 36)
    assert kfused.smem_bytes(256, 256, 512) <= ksddmm.SMEM_LIMIT
    assert kfused.smem_bytes(128, 2048, 128) > ksddmm.SMEM_LIMIT
    with pytest.raises(ValueError, match="edge_op"):
        tops.fusedmm_bsr(bsr, x, x[:280], x[:280], edge_op="relu")


def test_edge_score_kernels_build_every_tile_the_tuner_picks():
    """The kernels are built for exactly the tile widths of the tuner's
    BSR candidates, and every candidate's rows split into whole slices."""
    from repro_torch.core.autotune import _DEFAULT_TILES
    assert set(ksddmm.TILE_COLS) == {bc for _, bc in _DEFAULT_TILES}
    assert all(br % ksddmm.SLICE_ROWS == 0 for br, _ in _DEFAULT_TILES)


# --------------------------------------------------------------------------
# core.sddmm / core.fusedmm against jax.grad through repro.core
# --------------------------------------------------------------------------

def _graphs(rng, plan, n=90, m=70, nnz=600, k=24):
    ref, _ = random_coo(rng, n, m, nnz)
    jg = C.build_cached_graph(ref, k_hint=k, plan=JPlan(**plan))
    tg = build_cached_graph(_port_coo(ref), k_hint=k,
                            plan=KernelPlan(**plan))
    return jg, tg


@pytest.mark.parametrize("scale_by_a", [True, False])
def test_core_sddmm_forward_and_grad_match_reference(rng, scale_by_a):
    jg, tg = _graphs(rng, dict(kind="trusted"))
    x, y, c = _mat(rng, 90, 16), _mat(rng, 70, 16), rng.standard_normal(
        tg.coo.nnz_padded).astype(np.float32)

    def jloss(xx, yy):
        return jnp.sum(jax_sddmm(jg, xx, yy, scale_by_a=scale_by_a) * c)
    want = np.asarray(jax_sddmm(jg, jnp.asarray(x), jnp.asarray(y),
                                scale_by_a=scale_by_a))
    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                              jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    got = sddmm(tg, tx, ty, scale_by_a=scale_by_a)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert (got[tg.coo.nse:] == 0).all()
    gx, gy = torch.autograd.grad((got * torch.from_numpy(c)).sum(), (tx, ty))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), **GRAD_TOL)


def test_masked_edge_scores_broadcasts():
    xs = torch.arange(6.0).reshape(3, 1, 2)
    ys = torch.ones((3, 4, 2))
    valid = torch.arange(4)[None, :] < torch.tensor([[1], [4], [0]])
    s = masked_edge_scores(xs, ys, valid, scale=torch.full((3, 4), 2.0))
    assert torch.equal(s, torch.tensor([[2.0, 0, 0, 0], [10.0] * 4,
                                        [0.0] * 4]))


@pytest.mark.parametrize("edge_op", EDGE_OPS)
def test_edge_weights_match_reference(rng, edge_op):
    """Per-edge weights with invalid slots (zero) and a row without a
    valid slot, against the reference's ``edge_weights``."""
    s = rng.standard_normal(40).astype(np.float32) * 3
    row = np.sort(rng.integers(0, 8, 40)).astype(np.int32)
    valid = (rng.random(40) < 0.8) & (row != 3)
    want = np.asarray(jax_edge_weights(jnp.asarray(s), jnp.asarray(row), 8,
                                       jnp.asarray(valid), edge_op))
    got = edge_weights(torch.from_numpy(s), torch.from_numpy(row), 8,
                       torch.from_numpy(valid), edge_op)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[~torch.from_numpy(valid)] == 0).all()


@pytest.mark.parametrize("edge_op", EDGE_OPS)
@pytest.mark.parametrize("route", ["fused", "trusted"])
def test_core_fusedmm_forward_and_grad_match_reference(rng, edge_op, route,
                                                      pallas_fusedmm):
    """``fused``: a BSR plan at K = 128 (the kernel route, here its plain
    version); ``trusted``: K = 24 (not a multiple of 128), the trusted
    composition. Gradients of x, y and h through the recompute
    backward."""
    k = 128 if route == "fused" else 24
    jg, tg = _graphs(rng, dict(kind="bsr", br=32, bc=128), k=k)
    assert tg.bsr is not None
    x, y, h = _mat(rng, 90, 16), _mat(rng, 70, 16), _mat(rng, 70, k)
    c = _mat(rng, 90, k)

    def jloss(xx, yy, hh):
        return jnp.sum(jax_fusedmm(jg, xx, yy, hh, edge_op=edge_op) * c)
    jargs = tuple(jnp.asarray(t) for t in (x, y, h))
    want = np.asarray(jax_fusedmm(jg, *jargs, edge_op=edge_op))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    targs = tuple(torch.from_numpy(t).requires_grad_(True)
                  for t in (x, y, h))
    calls = []
    real = tops.fusedmm_bsr

    def spy(*a, **kw):
        calls.append(a[3].shape[1])
        return real(*a, **kw)
    tops.fusedmm_bsr = spy
    try:
        got = fusedmm(tg, *targs, edge_op=edge_op)
    finally:
        tops.fusedmm_bsr = real
    assert calls == ([k] if route == "fused" else [])
    assert got.shape == (90, k)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    grads = torch.autograd.grad((got * torch.from_numpy(c)).sum(), targs)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("edge_op", EDGE_OPS)
def test_fusedmm_baseline_matches_tuned(rng, edge_op):
    """The unfused baseline under plain autograd against the tuned
    recompute backward: same function, same gradients."""
    _, tg = _graphs(rng, dict(kind="trusted"))
    x, y, h = _mat(rng, 90, 8), _mat(rng, 70, 8), _mat(rng, 70, 12)
    outs = []
    for fn in (fusedmm, tbase.fusedmm_uncached):
        args = tuple(torch.from_numpy(t).requires_grad_(True)
                     for t in (x, y, h))
        out = fn(tg, *args, edge_op=edge_op)
        outs.append((out.detach(), torch.autograd.grad(
            (out ** 2).sum(), args)))
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(), **TOL)
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


# --------------------------------------------------------------------------
# the gat model and its training loop
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gat_setup():
    """reddit at scale 1/512 (455 nodes, 602 features, 41 classes), BSR
    128 x 128 pinned in both packages."""
    ref_ds = jax_make_dataset("reddit", scale=1 / 512, seed=1)
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    jb = jax_build_bundle(ref_ds, k_hint=HIDDEN,
                          plan=JPlan(kind="bsr", br=128, bc=128))
    tb = build_bundle(ds, k_hint=HIDDEN, arch="gat", plan=KernelPlan(
        kind="bsr", br=128, bc=128, fk=64, k_hint=HIDDEN))
    init, _ = jax_make_gnn("gat", ref_ds.num_features, HIDDEN,
                           ref_ds.num_classes)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    return ref_ds, ds, jb, tb, jp


def test_params_from_jax_takes_top_level_arrays(gat_setup):
    *_, jp = gat_setup
    p = params_from_jax(jp, device="cpu")
    assert set(p) == {"proj", "l1", "l2"}
    assert p["proj"].shape == jp["proj"].shape
    assert p["proj"].dtype == torch.float32
    assert np.array_equal(p["l1"]["wq"].numpy(), jp["l1"]["wq"])


@pytest.mark.parametrize("use_isplib", [True, False])
def test_gat_logits_match_reference(gat_setup, use_isplib, pallas_fusedmm):
    ref_ds, ds, jb, tb, jp = gat_setup
    _, japply = jax_make_gnn("gat", ref_ds.num_features, HIDDEN,
                             ref_ds.num_classes)
    with jax_patched(use_isplib):
        want = np.asarray(japply(jp, jb, ref_ds.x))
    _, apply = make_gnn("gat", ds.num_features, HIDDEN, ds.num_classes)
    tops_calls = []
    real = tops.fusedmm_bsr

    def spy(a, x, y, h, **kw):
        tops_calls.append(h.shape[1])
        return real(a, x, y, h, **kw)
    tops.fusedmm_bsr = spy
    try:
        with patched(use_isplib), torch.no_grad():
            got = apply(params_from_jax(jp, device="cpu"), tb, ds.x).numpy()
    finally:
        tops.fusedmm_bsr = real
    # patched: layer 1 (K = 128) fused, layer 2 (K = 41) trusted
    assert tops_calls == ([HIDDEN] if use_isplib else [])
    assert got.shape == (ds.num_nodes, ds.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("use_isplib", [True, False])
def test_train_gnn_gat_losses_match_reference(gat_setup, use_isplib,
                                              pallas_fusedmm):
    ref_ds, ds, jb, tb, jp = gat_setup
    want = jax_train_gnn("gat", ref_ds, hidden=HIDDEN, epochs=5, seed=0,
                         bundle=jb, use_isplib=use_isplib)
    got = train_gnn("gat", ds, hidden=HIDDEN, epochs=5, device="cpu",
                    bundle=tb, use_isplib=use_isplib,
                    params=params_from_jax(jp, device="cpu"))
    assert len(got.losses) == len(want.losses) == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.train_acc == pytest.approx(want.train_acc, abs=0.01)
    assert got.plan_kind == "bsr"


def test_train_gnn_builds_its_own_gat_bundle():
    """No gat-specific branch in the trainer: it builds the bundle for
    the arch (only A's cached graph) and trains."""
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    res = train_gnn("gat", ds, hidden=16, epochs=2, device="cpu")
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()


def test_gat_tuned_and_baseline_step_agree(gat_setup):
    """One step patched (fused forward, recompute backward) against one
    unpatched (unfused, plain autograd) from the same weights: loss rtol
    1e-6, gradients within 1e-5 of their largest element."""
    _, ds, _, tb, jp = gat_setup
    _, apply = make_gnn("gat", ds.num_features, HIDDEN, ds.num_classes)
    params = params_from_jax(jp, device="cpu")
    with patched(True):
        loss_t, g_t = loss_and_grads(apply, params, tb, ds.x, ds.y,
                                     ds.train_mask)
    with patched(False):
        loss_b, g_b = loss_and_grads(apply, params, tb, ds.x, ds.y,
                                     ds.train_mask)
    assert float(loss_t) == pytest.approx(float(loss_b), rel=1e-6)
    assert set(g_t) == {"proj", "l1", "l2"}
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=0,
        atol=1e-5 * float(b.abs().max()) + 1e-12), g_t, g_b)
