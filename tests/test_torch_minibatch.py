"""The port's minibatch slice against the JAX reference, on the CPU: the
sampling RNG and kernels' plain versions, the device sampler, the
differentiable block SpMM, one host- and one device-sampled training
step, layer-wise inference and ``train_gnn_minibatch`` loss curves.

Data: reddit at scale 1/512 (455 nodes), which both packages build bit
for bit; 2 layers, hidden 16. Inputs are made with numpy from a seed.
Where the reference reaches a Pallas kernel it also runs it with
``interpret=True``.

Bitwise: the RNG, ``segment_sample``, ``expand_indptr``, ``flat_gather``
and every field of ``DeviceSampler.sample_blocks`` (the reference
promises bitwise replay across its XLA and Pallas paths). Tolerance
elsewhere (fp32, other summation orders): block SpMM gradients, a step's
loss and gradients, layer-wise logits and the loss curves over 3 AdamW
epochs rtol 1e-5 / atol 1e-6 (x the largest reference magnitude where it
exceeds 1)."""
import importlib.util
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.core.autotune import KernelPlan as JPlan
from repro.core.patch import patched as jax_patched
from repro.data import make_dataset as jax_make_dataset
from repro.kernels import sample as jks
from repro.optim import adamw as jax_adamw
from repro.sampling import BlockPlanCache as JPlanCache
from repro.sampling import DeviceSampler as JDeviceSampler
from repro.sampling import NeighborSampler as JSampler
from repro.sampling import block_spmm as jax_block_spmm
from repro.sampling import device_graph_from_csr as jax_device_graph
from repro.sampling import num_seed_batches as jax_num_seed_batches
from repro.sampling import pack_block as jax_pack_block
from repro.sampling import plan_buckets as jax_plan_buckets
from repro.sampling import seed_batches as jax_seed_batches
from repro.train import gnn_minibatch as jmb

from repro_torch import obs
from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.patch import patched
from repro_torch.data import make_dataset
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sample as tks
from repro_torch.models.gnn import params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.optimizer import tree_map
from repro_torch.sampling import (BlockPlanCache, DeviceSampler,
                                  NeighborSampler, block_spmm,
                                  device_graph_from_csr, gather_rows,
                                  num_seed_batches,
                                  pack_block, plan_buckets, prefetch,
                                  seed_batches)
from repro_torch.train import gnn_minibatch as mb

FANOUTS = (4, 5)
HIDDEN = 16
BATCH = 64


def _tol(want) -> dict:
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def datasets():
    return (jax_make_dataset("reddit", scale=1 / 512, seed=1),
            make_dataset("reddit", scale=1 / 512, seed=1))


@pytest.fixture(scope="module")
def graphs(datasets):
    ref_ds, ds = datasets
    return jsp.csr_from_coo(ref_ds.coo), tsp.csr_from_coo(ds.coo)


# --------------------------------------------------------------------------
# RNG and the three sampling primitives (bitwise)
# --------------------------------------------------------------------------

def test_rng_matches_reference_bitwise():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1]
    assert (x >= 2 ** 31).sum() > 1000
    xt = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(
        tks._mix32(xt).numpy(), np.asarray(jks._mix32(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tks._bits_to_uniform(xt).numpy(),
        np.asarray(jks._bits_to_uniform(jnp.asarray(x))))
    gid = rng.integers(0, 2 ** 31 - 1, 512).astype(np.int32)
    slot = rng.integers(0, 64, 512).astype(np.int32)
    for seed, rnd, hop in ((0, 0, 0), (7, -1, 1), (2 ** 32 - 1, 2 ** 31 - 1,
                                                   3)):
        want = np.asarray(jks._edge_bits(seed, jnp.int32(rnd), hop,
                                         jnp.asarray(gid),
                                         jnp.asarray(slot)))
        got = tks._edge_bits(seed, rnd, hop, torch.from_numpy(gid),
                             torch.from_numpy(slot))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a Python int runs the same arithmetic
    assert tks._mix32(int(x[1])) == int(np.asarray(
        jks._mix32(jnp.uint32(x[1]))))


def _degrees(rng, f, width, num_nodes):
    """Degrees 0, <= width and > width, plus sentinel rows (the id
    ``num_nodes`` with degree 0)."""
    deg = rng.integers(0, 4 * width + 3, f).astype(np.int32)
    deg[:3] = 0
    deg[3:6] = [1, width - 1, width]
    deg[6:9] = [width + 1, 5 * width, 1000]
    gid = rng.integers(0, num_nodes, f).astype(np.int32)
    gid[-4:] = num_nodes
    deg[-4:] = 0
    return deg, gid


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("rnd", [0, -1, 100_003])
@pytest.mark.parametrize("width", [1, 5, 25, 40])
def test_segment_sample_matches_reference_bitwise(replace, rnd, width):
    rng = np.random.default_rng(width + 17 * int(replace))
    deg, gid = _degrees(rng, 97, width, 5000)
    kw = dict(width=width, fanout=width, seed=11, hop=1, replace=replace)
    got = tks.segment_sample(torch.from_numpy(deg), torch.from_numpy(gid),
                             rnd, **kw).numpy()
    for interpret in (None, True):
        want = np.asarray(jks.segment_sample(
            jnp.asarray(deg), jnp.asarray(gid), jnp.int32(rnd),
            interpret=interpret, **kw))
        np.testing.assert_array_equal(got, want)
    valid = tks.sample_valid_mask(torch.from_numpy(deg), width=width,
                                  fanout=width, replace=replace)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(
        jks.sample_valid_mask(jnp.asarray(deg), width=width, fanout=width,
                              replace=replace)))
    # valid slots are real, distinct (without replacement) ranks
    ranks = np.where(valid.numpy(), got, -1)
    for r, d in zip(ranks, deg):
        real = r[r >= 0]
        assert (real < d).all()
        if not replace:
            assert len(set(real.tolist())) == len(real) == min(d, width)


def test_full_neighbourhood_ranks_are_identity():
    deg = torch.tensor([0, 3, 7], dtype=torch.int32)
    got = tks.segment_sample(deg, deg, 5, width=7, fanout=None)
    want = jks.segment_sample(jnp.asarray(deg.numpy()),
                              jnp.asarray(deg.numpy()), 5, width=7,
                              fanout=None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tks.sample_valid_mask(deg, width=7, fanout=None).numpy(),
        np.asarray(jks.sample_valid_mask(jnp.asarray(deg.numpy()), width=7,
                                         fanout=None)))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_expand_indptr_and_flat_gather_match_reference(dtype):
    rng = np.random.default_rng(3)
    f, width, nse = 40, 6, 300
    start = rng.integers(0, nse - width, f).astype(np.int32)
    ranks = rng.integers(0, width, (f, width)).astype(np.int32)
    valid = rng.random((f, width)) < 0.7
    got = tks.expand_indptr(torch.from_numpy(start), torch.from_numpy(ranks),
                            torch.from_numpy(valid), sentinel=nse)
    arr = (rng.standard_normal(nse + 1) * 100).astype(dtype)
    for interpret in (None, True):
        want = np.asarray(jks.expand_indptr(
            jnp.asarray(start), jnp.asarray(ranks), jnp.asarray(valid),
            sentinel=nse, interpret=interpret))
        np.testing.assert_array_equal(got.numpy(), want)
        gathered = jks.flat_gather(jnp.asarray(arr), jnp.asarray(want),
                                   interpret=interpret)
        out = tks.flat_gather(torch.from_numpy(arr), got)
        assert out.dtype == torch.from_numpy(arr).dtype
        np.testing.assert_array_equal(out.numpy(), np.asarray(gathered))
    # out-of-range positions clip, as the reference's XLA path does
    pos = torch.tensor([[-3, 0, nse, nse + 9]], dtype=torch.int32)
    np.testing.assert_array_equal(
        tks.flat_gather(torch.from_numpy(arr), pos).numpy(),
        np.asarray(jks.flat_gather(jnp.asarray(arr),
                                   jnp.asarray(pos.numpy()))))


def test_cpu_dispatch_counts_no_launch_and_segment_ops_counts():
    tops.reset_kernel_launches()
    deg = torch.tensor([0, 3, 30], dtype=torch.int32)
    tks.segment_sample(deg, deg, 0, width=8, fanout=8)
    tks.flat_gather(deg, torch.zeros((1, 2), dtype=torch.int32))
    assert not any(tops.kernel_launches().values())
    assert {"segment_sample", "expand_indptr", "flat_gather"} <= \
        set(tops.kernel_launches())
    # the card check's operation count for the kernel's bound: one row of
    # Fisher-Yates, two of identity ranks
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fy = smoke.segment_sample_ops(deg, width=8, replace=False)
    assert fy > smoke.segment_sample_ops(deg[:2], width=8, replace=False) \
        == 16
    assert smoke.segment_sample_ops(deg, width=8, replace=True) > 0


# --------------------------------------------------------------------------
# the device sampler (bitwise)
# --------------------------------------------------------------------------

def _samplers(graphs, fanouts, *, caps=None, replace=False, base=32,
              batch=16, plans=("ell", "trusted")):
    jcsr, tcsr = graphs
    js = JDeviceSampler(jax_device_graph(jcsr), fanouts, batch_size=batch,
                        seed=3, replace=replace, base=base, src_caps=caps)
    ts = DeviceSampler(device_graph_from_csr(tcsr, device="cpu"), fanouts,
                       batch_size=batch, seed=3, replace=replace, base=base,
                       src_caps=caps)
    js.set_plans([JPlan(kind=k) if k != "trusted" else JPlan.trusted(16)
                  for k in plans])
    ts.set_plans([KernelPlan(kind=k) if k != "trusted"
                  else KernelPlan.trusted(16) for k in plans])
    return js, ts


def _bucket_tuple(b):
    return (b.n_dst, b.n_src, b.nnz, b.ell_width, b.sell_steps)


def _assert_blocks_equal(jblocks, tblocks):
    for a, b in zip(jblocks, tblocks):
        for f in ("src_ids", "dst_pos", "row", "col", "val", "degrees"):
            want, got = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert want.dtype == got.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert int(a.n_dst_real) == int(b.n_dst_real)
        assert int(a.nnz_real) == b.nnz_real
        assert (a.n_dst, a.n_src, a.plan_kind) == (b.n_dst, b.n_src,
                                                   b.plan_kind)
        assert (a.ell is None) == (b.ell is None) and b.sell is None
        if a.ell is not None:
            np.testing.assert_array_equal(b.ell.idx.numpy(),
                                          np.asarray(a.ell.idx))
            np.testing.assert_array_equal(b.ell.val.numpy(),
                                          np.asarray(a.ell.val))
            assert (b.ell.nrows, b.ell.ncols, b.ell.nse) == (
                a.ell.nrows, a.ell.ncols, a.ell.nse)


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("rnd", [0, -1, 7])
def test_device_sampler_matches_reference_bitwise(graphs, replace, rnd):
    js, ts = _samplers(graphs, FANOUTS, replace=replace)
    n = ts.graph.num_nodes
    seeds = (np.arange(16) * 7 % n).astype(np.int32)
    seeds[-3:] = n                                  # padded seed slots
    jb, jovf = js.sample_blocks_stats(jnp.asarray(seeds), jnp.int32(rnd))
    tb, tovf = ts.sample_blocks_stats(torch.from_numpy(seeds), rnd)
    _assert_blocks_equal(jb, tb)
    assert int(jovf) == int(tovf) == 0
    assert ts.signature == js.signature
    assert [_bucket_tuple(b) for b in ts.buckets] == \
        [_bucket_tuple(b) for b in js.buckets]
    # replay is bitwise
    _assert_blocks_equal(tb, ts.sample_blocks(torch.from_numpy(seeds), rnd))


def test_device_sampler_capacity_overflow_matches_reference(graphs):
    """Probed-too-small capacities: the tail is dropped (never mis-mapped)
    exactly as in the reference, and the overflow counts agree."""
    js, ts = _samplers(graphs, (6, 6), caps=(48, 64), base=8, batch=32,
                       plans=("trusted", "trusted"))
    assert ts._hop_dims[0][1] == 48 and ts._hop_dims[1][1] == 64
    n = ts.graph.num_nodes
    seeds = np.random.default_rng(7).permutation(n)[:32].astype(np.int32)
    jb, jovf = js.sample_blocks_stats(jnp.asarray(seeds), jnp.int32(3))
    tb, tovf = ts.sample_blocks_stats(torch.from_numpy(seeds), 3)
    _assert_blocks_equal(jb, tb)
    assert int(tovf) == int(jovf) > 0
    dropped = sum(int(b.n_dst - (b.dst_pos < b.n_src).sum()) for b in tb)
    assert dropped > 0


def test_sell_and_bsr_plans_remap_to_ell(graphs):
    _, ts = _samplers(graphs, FANOUTS, plans=("ell", "trusted"))
    ts.set_plans([KernelPlan(kind="sell", sell_c=8), KernelPlan(kind="bsr")])
    assert [s[3] for s in ts.signature] == ["ell", "ell"]


# --------------------------------------------------------------------------
# block SpMM gradient (fp32 tolerance)
# --------------------------------------------------------------------------

def _jplan(kind):
    return {"ell": JPlan(kind="ell"), "sell": JPlan(kind="sell", sell_c=8),
            "trusted": JPlan.trusted(8)}[kind]


def _tplan(kind):
    return {"ell": KernelPlan(kind="ell"),
            "sell": KernelPlan(kind="sell", sell_c=8),
            "trusted": KernelPlan.trusted(8)}[kind]


@pytest.mark.parametrize("kind", ["ell", "sell", "trusted"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_block_spmm_gradient_matches_jax_grad(graphs, kind, reduce):
    jcsr, tcsr = graphs
    seeds = np.arange(0, 60, 3)
    jblk = JSampler(jcsr, (6,), seed=2).sample(seeds, round=1)[0]
    tblk = NeighborSampler(tcsr, (6,), seed=2).sample(seeds, round=1)[0]
    sizes = dict(n_dst=32, n_src=256, nnz=32 * 6, ell_width=6)
    jpb = jax_pack_block(jblk, plan=_jplan(kind), **sizes)
    tpb = pack_block(tblk, plan=_tplan(kind), **sizes)
    rng = np.random.default_rng(5)
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
    np.testing.assert_allclose(float((out.detach() * torch.from_numpy(w))
                                     .sum()), float(want_out), rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_grad),
                               **_tol(want_grad))


# --------------------------------------------------------------------------
# one training step, host- and device-sampled (fp32 tolerance)
# --------------------------------------------------------------------------

def _jax_params(arch, ds, seed=0):
    init, _, _, _ = jmb.make_block_model(arch, ds.num_features, HIDDEN,
                                         ds.num_classes, len(FANOUTS))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


def _compare_step(want, got):
    (_, _, jloss, jgrads, _), (_, _, tloss, tgrads, _) = want, got
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for layer in jgrads:
        for name, g in jgrads[layer].items():
            g = np.asarray(g)
            np.testing.assert_allclose(tgrads[layer][name].numpy(), g,
                                       **_tol(g), err_msg=f"{layer}.{name}")


@pytest.mark.parametrize("arch", ["sage-mean", "gin"])
@pytest.mark.parametrize("kind", ["ell", "sell", "trusted"])
def test_host_step_matches_reference(datasets, graphs, arch, kind):
    ref_ds, ds = datasets
    jcsr, tcsr = graphs
    seed_ids, n_real = next(iter(seed_batches(
        np.nonzero(ds.train_mask.numpy())[0], BATCH, seed=0, epoch=0)))
    jblocks = JSampler(jcsr, FANOUTS, seed=0).sample(seed_ids[:n_real],
                                                     round=4)
    tblocks = NeighborSampler(tcsr, FANOUTS, seed=0).sample(
        seed_ids[:n_real], round=4)
    buckets = jax_plan_buckets(jblocks, batch_size=BATCH, fanouts=FANOUTS,
                               base=32)
    assert [_bucket_tuple(b) for b in buckets] == [
        _bucket_tuple(b) for b in plan_buckets(
            tblocks, batch_size=BATCH, fanouts=FANOUTS, base=32)]
    kw = [dict(n_dst=b.n_dst, n_src=b.n_src, nnz=b.nnz,
               ell_width=b.ell_width, sell_steps=b.sell_steps)
          for b in buckets]
    jpbs = tuple(jax_pack_block(b, plan=_jplan(kind), **k)
                 for b, k in zip(jblocks, kw))
    tpbs = [pack_block(b, plan=_tplan(kind), **k)
            for b, k in zip(tblocks, kw)]
    jp = _jax_params(arch, ref_ds)
    _, _, japply, _ = jmb.make_block_model(arch, ref_ds.num_features, HIDDEN,
                                           ref_ds.num_classes, 2)
    jopt = jax_adamw(1e-2, weight_decay=5e-4)
    jp_j = jax.tree_util.tree_map(jnp.asarray, jp)
    jstep = jmb.make_minibatch_step(japply, jopt, batch_size=BATCH)
    with jax_patched(True):
        want = jstep(jp_j, jopt.init(jp_j), jpbs, jnp.asarray(seed_ids),
                     jnp.asarray(n_real), jnp.asarray(ref_ds.x),
                     jnp.asarray(ref_ds.y), jnp.int32(0),
                     jmb.init_step_stats())
    _, _, tapply, _ = mb.make_block_model(arch, ds.num_features, HIDDEN,
                                          ds.num_classes, 2)
    opt = adamw(1e-2, weight_decay=5e-4)
    tp = params_from_jax(jp, device="cpu")
    tstep = mb.make_minibatch_step(tapply, opt, batch_size=BATCH)
    with patched(True):
        got = tstep(tp, opt.init(tp), tpbs, torch.from_numpy(seed_ids),
                    n_real, ds.x, ds.y, mb.init_step_stats("cpu"))
    _compare_step(want, got)
    # the updated params follow
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), **_tol(np.asarray(b))), got[0],
        jax.tree_util.tree_map(np.asarray, want[0]))


@pytest.mark.parametrize("plans", [("ell", "ell"), ("trusted", "ell")])
def test_device_step_matches_reference(datasets, graphs, plans):
    ref_ds, ds = datasets
    js, ts = _samplers(graphs, FANOUTS, batch=BATCH, base=32, plans=plans)
    n = ds.num_nodes
    seeds = np.random.default_rng(1).permutation(n)[:BATCH].astype(np.int32)
    n_real = BATCH - 5
    jp = _jax_params("sage-mean", ref_ds)
    _, _, japply, _ = jmb.make_block_model("sage-mean", ref_ds.num_features,
                                           HIDDEN, ref_ds.num_classes, 2)
    jopt = jax_adamw(1e-2, weight_decay=5e-4)
    jp_j = jax.tree_util.tree_map(jnp.asarray, jp)
    jstep = jmb.make_device_minibatch_step(japply, jopt, js,
                                           batch_size=BATCH)
    with jax_patched(True):
        want = jstep(jp_j, jopt.init(jp_j), jnp.asarray(seeds),
                     jnp.asarray(n_real), jnp.int32(9),
                     jnp.asarray(ref_ds.x), jnp.asarray(ref_ds.y),
                     jnp.int32(0), jmb.init_step_stats())
    _, _, tapply, _ = mb.make_block_model("sage-mean", ds.num_features,
                                          HIDDEN, ds.num_classes, 2)
    opt = adamw(1e-2, weight_decay=5e-4)
    tp = params_from_jax(jp, device="cpu")
    tstep = mb.make_device_minibatch_step(tapply, opt, ts, batch_size=BATCH)
    with patched(True):
        got = tstep(tp, opt.init(tp), torch.from_numpy(seeds), n_real, 9,
                    ds.x, ds.y, mb.init_step_stats("cpu"))
    _compare_step(want, got)
    assert got[4].drain() == {"skipped": 0, "overflow": int(
        want[4]["overflow"])}


@pytest.mark.parametrize("skip", [True, False])
def test_nonfinite_step_is_skipped_on_device(datasets, graphs, skip):
    """With the guard, a non-finite loss keeps the old params and moments
    and is counted; the decision is a device tensor (no Python branch on
    it). Without it, the update goes through."""
    _, ds = datasets
    _, ts = _samplers(graphs, FANOUTS, batch=BATCH, base=32)
    init, _, apply_blocks, _ = mb.make_block_model(
        "sage-mean", ds.num_features, HIDDEN, ds.num_classes, 2)
    p = init(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw(1e-2)
    s = opt.init(p)
    x = ds.x.clone()
    x[:, 0] = float("nan")
    step = mb.make_device_minibatch_step(apply_blocks, opt, ts,
                                         batch_size=BATCH,
                                         skip_nonfinite=skip)
    seeds = torch.arange(BATCH, dtype=torch.int32)
    p2, s2, loss, grads, stats = step(p, s, seeds, BATCH, 0, x, ds.y,
                                      mb.init_step_stats("cpu"))
    if not skip:
        assert stats.drain()["skipped"] == 0 and not torch.isfinite(loss)
        assert not torch.isfinite(p2["l0"]["w_self"]).all()
        assert int(s2.step) == 1
        return
    assert stats.drain()["skipped"] == 1 and float(loss) == 0.0
    assert s2.step.dtype == torch.int32 and int(s2.step) == 0
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             (p2, s2.mu, s2.nu), (p, s.mu, s.nu))
    tree_map(lambda g: torch.testing.assert_close(g, torch.zeros_like(g)),
             grads)


def test_skipped_then_normal_steps_match_reference(datasets, graphs):
    """A skipped step holds the AdamW step count, so the bias corrections
    of the steps after it are the reference's: one poisoned step, then two
    clean ones, from the same weights in both packages."""
    ref_ds, ds = datasets
    js, ts = _samplers(graphs, FANOUTS, batch=BATCH, base=32,
                       plans=("ell", "ell"))
    seeds = np.random.default_rng(2).permutation(
        ds.num_nodes)[:BATCH].astype(np.int32)
    x = np.array(ref_ds.x)
    bad_x = x.copy()
    bad_x[:, 0] = np.nan
    xs = [bad_x, x, x]
    jp = _jax_params("sage-mean", ref_ds)
    _, _, japply, _ = jmb.make_block_model("sage-mean", ref_ds.num_features,
                                           HIDDEN, ref_ds.num_classes, 2)
    jopt = jax_adamw(1e-2, weight_decay=5e-4)
    jstep = jmb.make_device_minibatch_step(japply, jopt, js,
                                           batch_size=BATCH)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate, jstats = jopt.init(jparams), jmb.init_step_stats()
    with jax_patched(True):
        for i, x in enumerate(xs):
            jparams, jstate, _, _, jstats = jstep(
                jparams, jstate, jnp.asarray(seeds), jnp.asarray(BATCH),
                jnp.int32(i), jnp.asarray(x), jnp.asarray(ref_ds.y),
                jnp.int32(i), jstats)
    _, _, tapply, _ = mb.make_block_model("sage-mean", ds.num_features,
                                          HIDDEN, ds.num_classes, 2)
    opt = adamw(1e-2, weight_decay=5e-4)
    tstep = mb.make_device_minibatch_step(tapply, opt, ts, batch_size=BATCH)
    tparams = params_from_jax(jp, device="cpu")
    tstate, tstats = opt.init(tparams), mb.init_step_stats("cpu")
    with patched(True):
        for i, x in enumerate(xs):
            tparams, tstate, _, _, tstats = tstep(
                tparams, tstate, torch.from_numpy(seeds), BATCH, i,
                torch.from_numpy(x), ds.y, tstats)
    assert int(tstate.step) == int(jstate.step) == 2
    assert tstats.drain()["skipped"] == int(jstats["skipped"]) == 1
    for got, want in [(tparams, jparams), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)]:
        tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), **_tol(np.asarray(b))), got,
            jax.tree_util.tree_map(np.asarray, want))


# --------------------------------------------------------------------------
# layer-wise inference, the loader, the trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["sage-mean", "sage-sum", "gin"])
@pytest.mark.parametrize("upto", [None, 1])
@pytest.mark.parametrize("tune", [False, True])
def test_layerwise_inference_matches_reference(datasets, graphs, arch, upto,
                                               tune):
    ref_ds, ds = datasets
    jcsr, tcsr = graphs
    jp = _jax_params(arch, ref_ds)
    dims = [ref_ds.num_features, HIDDEN, ref_ds.num_classes]
    _, semiring = jmb._block_arch(arch)
    with jax_patched(True):
        want = np.asarray(jmb.layerwise_inference(
            jax.tree_util.tree_map(jnp.asarray, jp), JSampler(jcsr, FANOUTS),
            jnp.asarray(ref_ds.x), arch=arch, dims=dims,
            plan_cache=JPlanCache(semiring=semiring, tune=tune),
            batch_size=128, bucket_base=32, upto=upto))
    cache = BlockPlanCache(semiring=semiring, tune=tune)
    with patched(True):
        got = mb.layerwise_inference(
            params_from_jax(jp, device="cpu"), NeighborSampler(tcsr, FANOUTS),
            ds.x, arch=arch, dims=dims, plan_cache=cache, batch_size=128,
            bucket_base=32, upto=upto).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **_tol(want))
    if tune:             # the H100 tuner reaches the kernels at K = 16
        assert set(cache.kinds()) & {"ell", "sell"}


def test_gathered_ell_matches_gather_then_ell(graphs):
    _, tcsr = graphs
    blk = NeighborSampler(tcsr, (None,)).full_block(np.arange(40))
    pb = pack_block(blk, plan=KernelPlan(kind="ell"), n_dst=64, n_src=512,
                    nnz=4096, ell_width=64)
    h = torch.randn((tcsr.nrows, 7), generator=torch.Generator()
                    .manual_seed(0))
    got = tops.gathered_ell_spmm(pb.ell, h, pb.src_ids)
    want = tops.ell_spmm(pb.ell, gather_rows(h, pb.src_ids))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_loader_matches_reference():
    ids = np.arange(3, 203)
    for bs in (64, 200, 256):
        assert num_seed_batches(len(ids), bs) == \
            jax_num_seed_batches(len(ids), bs)
        for epoch in (0, 3):
            got = list(seed_batches(ids, bs, seed=5, epoch=epoch))
            want = list(jax_seed_batches(ids, bs, seed=5, epoch=epoch))
            assert len(got) == len(want)
            for (a, na), (b, nb) in zip(got, want):
                assert na == nb
                np.testing.assert_array_equal(a, b)


def test_prefetch_order_errors_and_close():
    assert list(prefetch(iter(range(20)))) == list(range(20))

    def bad():
        yield 1
        raise RuntimeError("producer died")
    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)
    before = threading.active_count()
    it = prefetch(iter(range(1000)))
    next(it)
    it.close()
    assert threading.active_count() <= before


def test_device_counters_add_and_drain():
    c = obs.device_counters("a", "b", device="cpu")
    c2 = c.add("a", torch.tensor(3, dtype=torch.int32)).add("b", 2)
    assert c.drain() == {"a": 0, "b": 0} and c2.drain() == {"a": 3, "b": 2}
    assert int(c2["b"]) == 2
    with pytest.raises(KeyError):
        c.add("missing", 1)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_train_gnn_minibatch_losses_match_reference(datasets, sampler):
    ref_ds, ds = datasets
    kw = dict(fanouts=FANOUTS, batch_size=BATCH, hidden=HIDDEN, epochs=3,
              seed=0, bucket_base=32, infer_batch=128, sampler=sampler)
    want = jmb.train_gnn_minibatch("sage-mean", ref_ds, **kw)
    got = mb.train_gnn_minibatch(
        "sage-mean", ds, device="cpu",
        params=params_from_jax(_jax_params("sage-mean", ref_ds), device="cpu"),
        **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.overflow_edges == want.overflow_edges
    assert got.n_buckets == want.n_buckets
    assert got.steps_per_epoch == len(list(seed_batches(
        np.nonzero(ds.train_mask.numpy())[0], BATCH)))
    # at most two test nodes' argmax may flip on a last-bit difference
    assert abs(got.test_acc - want.test_acc) <= 2 / int(ds.test_mask.sum())
    assert got.sampler == sampler and got.device == "cpu"
    if sampler == "device":
        assert got.probed_caps == got.src_caps
        assert got.capacity_escalations == want.capacity_escalations


def test_profiled_host_run_records_trainer_and_loader_spans(datasets):
    _, ds = datasets
    with obs.profiled() as tracer:
        res = mb.train_gnn_minibatch(
            "gin", ds, fanouts=FANOUTS, batch_size=BATCH, hidden=HIDDEN,
            epochs=1, bucket_base=32, infer_batch=256, profile=True,
            device="cpu")
    names = {s.name for s in tracer.snapshot()}
    assert {"train.epoch", "train.step", "train.infer", "loader.sample",
            "loader.pack", "loader.h2d", "loader.stall",
            "op.block_spmm"} <= names
    assert len(res.losses) == 1 and np.isfinite(res.losses).all()


def test_device_trainer_escalates_on_overflow(datasets):
    _, ds = datasets
    with pytest.warns(UserWarning, match="escalating"):
        res = mb.train_gnn_minibatch(
            "sage-mean", ds, fanouts=FANOUTS, batch_size=BATCH,
            hidden=HIDDEN, epochs=2, bucket_base=8, sampler="device",
            device_caps=(8, 16), max_escalations=1, device="cpu")
    assert res.capacity_escalations == 1 and res.overflow_edges > 0
    assert res.src_caps == (16, 32)


def test_device_sampler_rejects_max_aggregation_and_full_fanouts(datasets):
    _, ds = datasets
    with pytest.raises(ValueError, match="sum/mean"):
        mb.train_gnn_minibatch("sage-max", ds, sampler="device",
                               device="cpu")
    with pytest.raises(ValueError, match="finite fanouts"):
        mb.train_gnn_minibatch("sage-mean", ds, fanouts=(None, 5),
                               sampler="device", device="cpu")
    with pytest.raises(ValueError, match="sampler must be"):
        mb.train_gnn_minibatch("sage-mean", ds, sampler="gpu", device="cpu")
