"""The port's fault-injection suite on the CPU: every single-shard case of
the reference's ``tests/test_fault_injection.py`` against the port's
``train_gnn_minibatch`` (a run killed mid-epoch and resumed ends bitwise
equal to the clean run on both samplers; a finished run resumed is a
no-op; an injected NaN gradient is skipped, and with the guard off it
poisons the run; a dead prefetch worker restarts and the run stays
bitwise equal; an exhausted restart budget raises; a straggler is
flagged), then across packages: a checkpoint directory left by the
reference's killed run resumes in the port's trainer, and the two
packages' ``extra`` dicts agree.

Sizes are the reference suite's: reddit at scale 1/512, fanouts (4, 4),
batches of 64, hidden 32, 3 epochs. Cross-package tolerance: the
minibatch loss-curve tests' (``tests/test_torch_minibatch.py``): losses
rtol 1e-5; params rtol 1e-5 / atol 1e-6 x the largest reference
magnitude where it exceeds 1."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.data import make_dataset as jax_make_dataset
from repro.testing import FaultPlan as JFaultPlan
from repro.testing import expect_kill as jax_expect_kill
from repro.train import gnn_minibatch as jmb

from repro_torch.data import make_dataset
from repro_torch.models.gnn import params_from_jax
from repro_torch.optim.optimizer import tree_leaves
from repro_torch.sampling import num_seed_batches
from repro_torch.testing import FaultPlan, InjectedFault, expect_kill
from repro_torch.train import train_gnn_minibatch
from repro_torch.train.fault_tolerance import StragglerWatchdog

_KW = dict(fanouts=(4, 4), batch_size=64, hidden=32, epochs=3, seed=0)


@pytest.fixture(scope="module")
def ds():
    return make_dataset("reddit", scale=1 / 512, seed=1)


@pytest.fixture(scope="module")
def clean(ds):
    """The uninterrupted runs, by sampler."""
    return {s: _train(ds, sampler=s) for s in ("host", "device")}


def _train(dataset, **over):
    kw = dict(_KW, device="cpu")
    kw.update(over)
    return train_gnn_minibatch("sage-mean", dataset, **kw)


def _assert_bitwise(pa, pb, what):
    la, lb = tree_leaves(pa), tree_leaves(pb)
    assert len(la) == len(lb) > 0
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b), what


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_kill_resume_bitwise_single_shard(ds, clean, tmp_path, sampler):
    """Killed at step 7 (off the cadence of 3), resumed from step 6: the
    loader fast-forward replays step 6, and the final params equal the
    clean run's bit for bit."""
    d = str(tmp_path / sampler)
    exc = expect_kill(_train, ds, sampler=sampler, ckpt_dir=d, ckpt_every=3,
                      faults=FaultPlan(step_exception_at=7))
    assert "step 7" in str(exc)
    r = _train(ds, sampler=sampler, ckpt_dir=d, ckpt_every=3)
    assert r.resumed_step == 6, r.resumed_step
    assert r.losses == clean[sampler].losses
    _assert_bitwise(clean[sampler].final_params, r.final_params,
                    f"{sampler}: resumed params diverged from the clean run")
    assert r.ckpt_saves >= 1 and r.prefetch_restarts == 0


def test_resume_after_complete_is_noop(ds, tmp_path):
    d = str(tmp_path / "done")
    r1 = _train(ds, ckpt_dir=d, ckpt_every=3)
    r2 = _train(ds, ckpt_dir=d, ckpt_every=3)
    spe = num_seed_batches(int(ds.train_mask.sum()), _KW["batch_size"])
    assert r2.resumed_step == _KW["epochs"] * spe, r2.resumed_step
    assert r2.losses == r1.losses and r2.ckpt_saves == 0
    _assert_bitwise(r1.final_params, r2.final_params,
                    "a re-run of a complete run changed params")


def test_nan_grad_skipped_single_shard(ds, clean):
    r = _train(ds, faults=FaultPlan(nan_grad_at=(4, 0)))
    assert r.skipped_steps == 1, r.skipped_steps
    assert all(np.isfinite(r.losses)), r.losses
    assert abs(r.losses[-1] - clean["host"].losses[-1]) < 0.5, \
        (r.losses, clean["host"].losses)
    assert all(torch.isfinite(p).all() for p in tree_leaves(r.final_params))


def test_nan_guard_off_poisons_params(ds):
    """Control: with the guard off the same injection propagates."""
    r = _train(ds, faults=FaultPlan(nan_grad_at=(4, 0)),
               skip_nonfinite=False)
    assert not all(np.isfinite(r.losses)), r.losses


def test_prefetch_death_recovers_bitwise(ds, clean):
    with pytest.warns(UserWarning, match="prefetch worker died"):
        r = _train(ds, faults=FaultPlan(prefetch_death_at=5))
    assert r.prefetch_restarts == 1, r.prefetch_restarts
    assert r.losses == clean["host"].losses
    _assert_bitwise(clean["host"].final_params, r.final_params,
                    "the prefetch-restarted run diverged")


def test_prefetch_death_during_measured_tuning_recovers(ds):
    """With measured tuning the prefetch thread hands unplanned batches
    to the consumer and waits for it; a producer that dies there is
    rebuilt, and the handshake goes on with the new stream (no hang)."""
    with pytest.warns(UserWarning, match="prefetch worker died"):
        r = _train(ds, faults=FaultPlan(prefetch_death_at=1), epochs=2,
                   measure_tuning=True)
    assert r.prefetch_restarts == 1 and len(r.losses) == 2
    assert all(np.isfinite(r.losses)), r.losses


def test_prefetch_restarts_exhausted_raises(ds):
    with pytest.raises(InjectedFault):
        _train(ds, faults=FaultPlan(prefetch_death_at=5),
               prefetch_restarts=0)


def test_straggler_flagged(ds):
    """A 2 s delay before step 6 (the reference's test sleeps 0.5 s: an
    eager CPU step on a loaded test machine can take a few hundred ms,
    and the watchdog judges against their EMA)."""
    wd = StragglerWatchdog(threshold=3.0)
    _train(ds, faults=FaultPlan(straggler_at=6, straggler_delay_s=2.0),
           watchdog=wd, double_buffer=False)
    flagged = [e.step for e in wd.events if e.straggler]
    assert 6 in flagged, wd.summary()
    assert wd.straggler_count >= 1
    assert wd.total_steps == len(wd.events)
    # the first executed epoch is not observed
    spe = num_seed_batches(int(ds.train_mask.sum()), _KW["batch_size"])
    assert min(e.step for e in wd.events) == spe


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------

def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's run, killed at step 7 with a checkpoint every 3,
    resumes in the port's trainer (host sampler, started from the same
    weights by ``params_from_jax``): it restores step 6 and ends within
    the loss-curve tolerance of the reference's clean run."""
    jds = jax_make_dataset("reddit", scale=1 / 512, seed=1)
    d = str(tmp_path / "ref")
    want = jmb.train_gnn_minibatch("sage-mean", jds, **_KW)
    jax_expect_kill(jmb.train_gnn_minibatch, "sage-mean", jds, ckpt_dir=d,
                    ckpt_every=3, faults=JFaultPlan(step_exception_at=7),
                    **_KW)
    init, _, _, _ = jmb.make_block_model("sage-mean", jds.num_features,
                                         _KW["hidden"], jds.num_classes, 2)
    start = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    got = _train(make_dataset("reddit", scale=1 / 512, seed=1),
                 ckpt_dir=d, ckpt_every=3,
                 params=params_from_jax(start, device="cpu"))
    assert got.resumed_step == 6
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    for layer, p in want.final_params.items():
        for name, leaf in p.items():
            _close(got.final_params[layer][name].numpy(), leaf)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_extra_dicts_match_the_reference(tmp_path, sampler):
    """The resume metadata both packages write at the same step, killed at
    the same step, has the same keys and values (losses within the
    loss-curve tolerance)."""
    jds = jax_make_dataset("reddit", scale=1 / 512, seed=1)
    init, _, _, _ = jmb.make_block_model("sage-mean", jds.num_features,
                                         _KW["hidden"], jds.num_classes, 2)
    start = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    # the kill lands past an epoch boundary, so the history holds a loss
    spe = num_seed_batches(int(np.asarray(jds.train_mask).sum()),
                           _KW["batch_size"])
    kill = spe + 3
    jax_expect_kill(jmb.train_gnn_minibatch, "sage-mean", jds, ckpt_dir=jd,
                    ckpt_every=3, sampler=sampler,
                    faults=JFaultPlan(step_exception_at=kill), **_KW)
    expect_kill(_train, make_dataset("reddit", scale=1 / 512, seed=1),
                ckpt_dir=td, ckpt_every=3, sampler=sampler,
                faults=FaultPlan(step_exception_at=kill),
                params=params_from_jax(start, device="cpu"))
    steps = sorted(s for s in os.listdir(jd) if s.startswith("step_"))
    assert steps == sorted(s for s in os.listdir(td)
                           if s.startswith("step_"))
    for s in steps:
        with open(os.path.join(jd, s, "manifest.json")) as f:
            want = json.load(f)
        with open(os.path.join(td, s, "manifest.json")) as f:
            got = json.load(f)
        assert got["n_leaves"] == want["n_leaves"]
        assert [(e["file"], e["shape"], e["dtype"]) for e in got["leaves"]] \
            == [(e["file"], e["shape"], e["dtype"]) for e in want["leaves"]]
        we, ge = want["extra"], got["extra"]
        assert ge.keys() == we.keys()
        np.testing.assert_allclose(ge.pop("losses"), we.pop("losses"),
                                   rtol=1e-5)
        assert ge == we
