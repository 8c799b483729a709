"""The port's full-graph training slice against the JAX reference: AdamW,
the two-layer models patched and unpatched from the same weights
(``params_from_jax``), and ``train_gnn``'s loss curve, all on the CPU.

Data: reddit at scale 1/512 (455 nodes), which both packages build bit
for bit. The reference tunes for a TPU v5e and the port for the H100, so
their tuned paths run different kernels on the same function.

Tolerance: logits rtol 1e-4 with atol 1e-5 x max|reference logit| (fp32
summation order; sage-sum and gin logits reach the hundreds, where one
ulp is ~1e-5); losses over 5 AdamW epochs rtol 1e-4; AdamW alone rtol
1e-6 (the same fp32 arithmetic in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.patch import patched as jax_patched
from repro.data import make_dataset as jax_make_dataset
from repro.models.gnn import build_bundle as jax_build_bundle
from repro.models.gnn import make_gnn as jax_make_gnn
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply_updates
from repro.train import train_gnn as jax_train_gnn

from repro_torch import obs
from repro_torch.core.autotune import KernelPlan, autotune
from repro_torch.core.patch import patched
from repro_torch.data import make_dataset
from repro_torch.models.gnn import build_bundle, make_gnn, params_from_jax
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.optimizer import tree_map
from repro_torch.train.gnn import loss_and_grads, train_gnn

ARCHS = ("gcn", "sage-sum", "sage-mean", "sage-max", "gin")
HIDDEN = 32


@pytest.fixture(scope="module")
def datasets():
    return (jax_make_dataset("reddit", scale=1 / 512, seed=1),
            make_dataset("reddit", scale=1 / 512, seed=1))


@pytest.fixture(scope="module")
def bundles(datasets):
    ref_ds, ds = datasets
    return (jax_build_bundle(ref_ds, k_hint=HIDDEN),
            build_bundle(ds, k_hint=HIDDEN))


def _jax_params(arch, ds, seed=0):
    init, _ = jax_make_gnn(arch, ds.num_features, HIDDEN, ds.num_classes)
    return init(jax.random.PRNGKey(seed))


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_adamw_matches_reference_over_10_steps():
    rng = np.random.default_rng(0)
    p0 = {"l1": {"w": rng.standard_normal((6, 4)).astype(np.float32),
                 "b": rng.standard_normal(4).astype(np.float32)},
          "l2": {"w": rng.standard_normal((4, 3)).astype(np.float32)}}
    grads = [tree_map(lambda x: rng.standard_normal(x.shape)
                      .astype(np.float32), p0) for _ in range(10)]
    jopt = jax_adamw(1e-2, weight_decay=5e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    opt = adamw(1e-2, weight_decay=5e-4)
    tp = tree_map(torch.from_numpy, p0)
    ts = opt.init(tp)
    for g in grads:
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax_apply_updates(jp, u)
        u, ts = opt.update(tree_map(torch.from_numpy, g), ts, tp)
        tp = apply_updates(tp, u)
    assert ts.step == 10
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7), tp, jp)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_isplib", [True, False])
def test_make_gnn_logits_match_reference(datasets, bundles, arch,
                                         use_isplib):
    ref_ds, ds = datasets
    ref_bundle, bundle = bundles
    jp = _jax_params(arch, ref_ds)
    _, japply = jax_make_gnn(arch, ref_ds.num_features, HIDDEN,
                             ref_ds.num_classes)
    with jax_patched(use_isplib):
        want = np.asarray(japply(jp, ref_bundle, ref_ds.x))
    _, apply = make_gnn(arch, ds.num_features, HIDDEN, ds.num_classes)
    with patched(use_isplib), torch.no_grad():
        got = apply(params_from_jax(_to_np(jp), device="cpu"), bundle,
                    ds.x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def test_port_tunes_for_the_h100(bundles):
    """At this size the H100 model picks the BSR kernel (its K tile and
    shared memory now fit) where the v5e model gates K = 32 to trusted."""
    ref_bundle, bundle = bundles
    assert ref_bundle.tuned.plan.kind == "trusted"
    assert bundle.tuned.plan.kind == "bsr" and bundle.tuned.plan.fk == 128


@pytest.mark.parametrize("arch", ["gcn", "sage-mean"])
def test_train_gnn_losses_match_reference(datasets, arch):
    ref_ds, ds = datasets
    want = jax_train_gnn(arch, ref_ds, hidden=HIDDEN, epochs=5, seed=0)
    jp = _jax_params(arch, ref_ds, seed=0)
    got = train_gnn(arch, ds, hidden=HIDDEN, epochs=5, device="cpu",
                    params=params_from_jax(_to_np(jp), device="cpu"))
    assert len(got.losses) == len(want.losses) == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.train_acc == pytest.approx(want.train_acc, abs=0.01)
    assert got.epoch_time_s > 0 and got.device == "cpu"


@pytest.mark.parametrize("arch,plan", [("gcn", "bsr"), ("sage-mean", "sell"),
                                       ("gin", "ell"), ("sage-max", "sell")])
def test_tuned_and_baseline_step_agree(datasets, arch, plan):
    """One step patched (planned kernels, cached transpose) against one
    unpatched (uncached trusted path, plain autograd) from the same
    weights: loss rtol 1e-6, gradients within 1e-5 of their largest
    element."""
    _, ds = datasets
    bundle = build_bundle(ds, k_hint=HIDDEN, plan=KernelPlan(
        kind=plan, br=64, bc=128, fk=64, sell_c=8))
    init, apply = make_gnn(arch, ds.num_features, HIDDEN, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device="cpu")
    with patched(True):
        loss_t, g_t = loss_and_grads(apply, params, bundle, ds.x, ds.y,
                                     ds.train_mask)
    with patched(False):
        loss_b, g_b = loss_and_grads(apply, params, bundle, ds.x, ds.y,
                                     ds.train_mask)
    assert float(loss_t) == pytest.approx(float(loss_b), rel=1e-6)
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=0,
        atol=1e-5 * float(b.abs().max()) + 1e-12), g_t, g_b)


def test_train_gnn_profile_records_spans(datasets):
    _, ds = datasets
    with obs.profiled(ops=True) as tracer:
        res = train_gnn("sage-mean", ds, hidden=16, epochs=2, device="cpu",
                        profile=True)
    names = {s.name for s in tracer.snapshot()}
    assert {"train.build", "train.init", "train.step", "train.eval",
            "op.spmm"} <= names
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert dataclasses.asdict(res)["plan_kind"] == res.plan_kind


def test_measured_tuning_on_the_training_path(datasets, monkeypatch):
    """``train_gnn(measure_tuning=True)`` times the graph its arch uses on
    the run's own device: on the host when asked for, and with no card
    present a run on the card raises before training (it never times the
    host in its place)."""
    _, ds = datasets
    with obs.profiled() as tracer:
        res = train_gnn("sage-mean", ds, hidden=HIDDEN, epochs=2,
                        device="cpu", measure_tuning=True)
    measured = [s.attrs for s in tracer.snapshot()
                if s.name == "tuning.measure"]
    assert len(measured) == 1 and measured[0]["device"] == "cpu"
    assert measured[0]["winner"].startswith(res.plan_kind)
    assert np.isfinite(res.losses).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune(ds.coo, 32, measure=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gnn("gcn", ds, hidden=HIDDEN, epochs=2, measure_tuning=True)


@pytest.mark.parametrize("arch", ["gcn", "sage-mean"])
def test_bundle_for_one_arch_packs_only_its_graph(datasets, bundles, arch):
    """Built for one arch, the bundle plans and packs only the cached graph
    that arch aggregates over (GCN: Â and its transpose), and that graph
    is the one a bundle for every arch holds."""
    _, ds = datasets
    _, full = bundles
    plan = KernelPlan(kind="bsr", br=64, bc=128, fk=64)
    one = build_bundle(ds, k_hint=HIDDEN, plan=plan, arch=arch)
    g = one.graph(arch)
    assert (one.tuned is None) == (arch == "gcn")
    assert (one.tuned_norm is None) == (arch != "gcn")
    assert g.bsr is not None and g.bsr_t is not None
    assert torch.equal(g.coo.val, full.graph(arch).coo.val)
    with pytest.raises(ValueError, match="another arch"):
        one.graph("sage-sum" if arch == "gcn" else "gcn")
