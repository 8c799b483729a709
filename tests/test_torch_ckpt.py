"""The port's checkpointer and resilient loop (``repro_torch.ckpt``,
``repro_torch.train.fault_tolerance``) on the CPU: each single-device
case of the reference's ``tests/test_ckpt_ft.py`` for the port, the
checkpoint directories of the two packages read across (an fp32 / int32
tree of params and an AdamW state, bit for bit both ways), and the
port's own cases: a bf16 leaf, a tensor changed in place right after an
asynchronous ``save`` returns, and a step that fails inside AdamW's
in-place update."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.optim.optimizer import AdamWState as JAdamWState

from repro_torch import obs
from repro_torch.ckpt import (Checkpointer, checkpoint_extra,
                              committed_steps, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.optim import adamw
from repro_torch.optim.optimizer import AdamWState, tree_leaves
from repro_torch.testing import corrupt_file
from repro_torch.train.fault_tolerance import (InPlaceUpdate, ResilientLoop,
                                               StragglerWatchdog)


def _tree(x=0.0):
    return {"w": torch.full((4, 3), x),
            "opt": {"mu": torch.full((4, 3), x + 1),
                    "step": torch.tensor(7)}}


def _batches():
    while True:
        yield torch.tensor(1.0)


def test_save_restore_roundtrip(tmp_path):
    t = _tree(2.5)
    save_checkpoint(str(tmp_path), 5, t)
    got, step = restore_checkpoint(str(tmp_path), _tree())
    assert step == 5
    for a, b in zip(tree_leaves(got), tree_leaves(t)):
        assert torch.equal(a, b)
    assert got["opt"]["step"].dtype == torch.int64


def test_uncommitted_checkpoint_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1.0))
    # a crash mid-save at step 2: the directory exists, no _COMMITTED
    d = os.path.join(str(tmp_path), "step_000000002")
    os.makedirs(d)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{}")
    assert latest_step(str(tmp_path)) == 1
    assert committed_steps(str(tmp_path)) == [1]
    _, step = restore_checkpoint(str(tmp_path), _tree())
    assert step == 1


def test_keep_n_gc_and_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(float(s)))
    ck.wait()
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(str(tmp_path))
                  if d.startswith("step_"))
    assert len(kept) == 2
    got, step = ck.restore(_tree())
    assert step == 4
    assert torch.equal(got["w"], torch.full((4, 3), 4.0))


def test_restore_with_shardings_is_not_ported(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(3.0))
    with pytest.raises(NotImplementedError, match="queue 1, item 5b"):
        restore_checkpoint(str(tmp_path), _tree(), shardings={"w": None})
    with pytest.raises(NotImplementedError, match="queue 1, item 5b"):
        Checkpointer(str(tmp_path)).restore(_tree(), shardings=object())


def test_watchdog_flags_and_escalates():
    wd = StragglerWatchdog(alpha=0.5, threshold=2.0, escalate_after=2)
    for i in range(5):
        assert not wd.observe(i, 1.0).straggler
    assert wd.observe(5, 10.0).straggler
    assert not wd.should_escalate
    wd.observe(6, 10.0)
    assert wd.should_escalate or wd.consecutive >= 1


def test_resilient_loop_recovers(tmp_path):
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:           # one transient failure
            raise RuntimeError("simulated device loss")
        return state + batch, {"loss": state}

    loop = ResilientLoop(step, Checkpointer(str(tmp_path), keep=3),
                         ckpt_every=2, max_restarts=2)
    state, end = loop.run(torch.tensor(0.0), _batches(), num_steps=6)
    assert loop.restarts == 1 and loop.emergency_saves == 1
    assert end >= 6 and float(state) > 0


def test_restore_falls_back_past_truncated_step(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1.0))
    save_checkpoint(str(tmp_path), 2, _tree(2.0))
    corrupt_file(os.path.join(str(tmp_path), "step_000000002",
                              "arr_00000.npy"), truncate_to=4)
    with pytest.warns(UserWarning, match="unreadable"):
        got, step = restore_checkpoint(str(tmp_path), _tree())
    assert step == 1
    assert torch.equal(got["w"], torch.full((4, 3), 1.0))
    with pytest.raises(Exception):
        restore_checkpoint(str(tmp_path), _tree(), step=2)


def test_restore_raises_when_all_steps_unreadable(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1.0))
    corrupt_file(os.path.join(str(tmp_path), "step_000000001",
                              "manifest.json"))
    with pytest.warns(UserWarning, match="unreadable"):
        with pytest.raises(FileNotFoundError, match="no readable"):
            restore_checkpoint(str(tmp_path), _tree())


def test_checkpoint_extra_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(3, _tree(1.0), extra={"losses": [0.5, 0.4], "caps": [256, 64]})
    ck.save(6, _tree(2.0), blocking=True, extra={"losses": [0.5, 0.4, 0.3]})
    assert ck.extra(3) == {"losses": [0.5, 0.4], "caps": [256, 64]}
    assert ck.extra() == {"losses": [0.5, 0.4, 0.3]}   # latest by default
    assert checkpoint_extra(str(tmp_path), 6) == ck.extra(6)
    with pytest.raises(FileNotFoundError):
        checkpoint_extra(str(tmp_path / "nothing-here"))


def test_watchdog_event_window_bounded():
    wd = StragglerWatchdog(alpha=0.5, threshold=2.0, max_events=4)
    for i in range(10):
        wd.observe(i, 1.0)
    wd.observe(10, 50.0)                      # flagged, then evicted below
    for i in range(11, 16):
        wd.observe(i, 1.0)
    assert [e.step for e in wd.events] == [12, 13, 14, 15]
    assert wd.total_steps == 16 and wd.straggler_count == 1
    assert not any(e.straggler for e in wd.events)


def test_watchdog_summary_and_span():
    wd = StragglerWatchdog(alpha=0.5, threshold=2.0)
    with obs.profiled() as tracer:
        for i, wall in enumerate((0.01, 0.01, 0.05, 0.01)):
            wd.observe(i, wall)
    spans = [s for s in tracer.snapshot() if s.name == "watchdog.step"]
    assert [s.attrs["straggler"] for s in spans] == [False, False, True,
                                                     False]
    summ = wd.summary()
    assert summ["total_steps"] == 4 and summ["straggler_count"] == 1
    assert summ["worst"][0]["step"] == 2 and summ["straggler_frac"] == 0.25


def test_resilient_loop_resumes_from_restored_step(tmp_path):
    """After an emergency restore the loop goes on from the (state, step)
    pair the restore returned: each step reaches on_metrics once."""
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 4:           # fails while attempting step 3
            raise RuntimeError("simulated device loss")
        return state + batch, {"loss": state}

    loop = ResilientLoop(step, Checkpointer(str(tmp_path), keep=3),
                         ckpt_every=2, max_restarts=2)
    seen = []
    state, end = loop.run(torch.tensor(0.0), _batches(), num_steps=6,
                          on_metrics=lambda s, m: seen.append(s))
    assert seen == [0, 1, 2, 3, 4, 5], seen
    assert float(state) == 6.0 and end == 6
    assert loop.restarts == 1 and loop.emergency_saves == 1


def test_resilient_loop_gives_up(tmp_path):
    def step(state, batch):
        raise RuntimeError("permanent failure")

    loop = ResilientLoop(step, Checkpointer(str(tmp_path), keep=1),
                         ckpt_every=10, max_restarts=1)
    with pytest.raises(RuntimeError, match="permanent"):
        loop.run(torch.tensor(0.0), _batches(), num_steps=3)


# --------------------------------------------------------------------------
# the two packages' directories, read across
# --------------------------------------------------------------------------

def _state_arrays(rng):
    params = {"l0": {"b": rng.standard_normal(5).astype(np.float32),
                     "w_neigh": rng.standard_normal((3, 5)).astype(
                         np.float32),
                     "w_self": rng.standard_normal((3, 5)).astype(
                         np.float32)},
              "l1": {"b": rng.standard_normal(2).astype(np.float32),
                     "w_self": rng.standard_normal((5, 2)).astype(
                         np.float32)}}
    mu = {k: {n: rng.standard_normal(a.shape).astype(np.float32)
              for n, a in p.items()} for k, p in params.items()}
    nu = {k: {n: rng.random(a.shape).astype(np.float32)
              for n, a in p.items()} for k, p in params.items()}
    return params, np.int32(17), mu, nu


def _torch_tree(params, step, mu, nu):
    conv = lambda t: {k: {n: torch.from_numpy(a.copy())   # noqa: E731
                          for n, a in p.items()} for k, p in t.items()}
    return {"params": conv(params),
            "opt_state": AdamWState(step=torch.tensor(step), mu=conv(mu),
                                    nu=conv(nu))}


def _jax_tree(params, step, mu, nu):
    conv = lambda t: {k: {n: jnp.asarray(a)                # noqa: E731
                          for n, a in p.items()} for k, p in t.items()}
    return {"params": conv(params),
            "opt_state": JAdamWState(step=jnp.asarray(step), mu=conv(mu),
                                     nu=conv(nu))}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_reads_across_packages_bitwise(tmp_path, rng, writer):
    """An fp32 / int32 tree (a params dict and an AdamW state) written by
    one package restores in the other bit for bit: the same leaf order,
    files and manifest entries."""
    arrays = _state_arrays(rng)
    zeros = _state_arrays(np.random.default_rng(99))
    extra = {"losses": [1.5, 1.25], "src_caps": None}
    if writer == "reference":
        jax_save(str(tmp_path), 9, _jax_tree(*arrays), extra=extra)
        got, step = restore_checkpoint(str(tmp_path), _torch_tree(*zeros))
        assert isinstance(got["opt_state"], AdamWState)
        leaves = [t.numpy() for t in tree_leaves(got["params"])]
        assert got["opt_state"].step.dtype == torch.int32
        assert int(got["opt_state"].step) == 17
        for name in ("mu", "nu"):
            leaves += [t.numpy() for t in
                       tree_leaves(getattr(got["opt_state"], name))]
    else:
        save_checkpoint(str(tmp_path), 9, _torch_tree(*arrays), extra=extra)
        got, step = jax_restore(str(tmp_path), _jax_tree(*zeros))
        assert int(got["opt_state"].step) == 17
        assert got["opt_state"].step.dtype == jnp.int32
        leaves = [np.asarray(got["params"][k][n])
                  for k in sorted(got["params"])
                  for n in sorted(got["params"][k])]
        for name in ("mu", "nu"):
            t = getattr(got["opt_state"], name)
            leaves += [np.asarray(t[k][n]) for k in sorted(t)
                       for n in sorted(t[k])]
    params, _, mu, nu = arrays
    want = [t[k][n] for t in (params, mu, nu) for k in sorted(t)
            for n in sorted(t[k])]
    assert step == 9 and len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert checkpoint_extra(str(tmp_path), 9) == extra


# --------------------------------------------------------------------------
# the port's own cases
# --------------------------------------------------------------------------

def test_bf16_leaf_round_trip(tmp_path):
    """numpy has no bfloat16: the leaf is stored as its bit pattern and
    the manifest names the dtype; the restore gives the same bits."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(6, 7, generator=g).to(torch.bfloat16)
    w[0, 0] = float("inf")
    w[0, 1] = -0.0
    tree = {"w": w, "m": torch.randn(6, 7, generator=g)}
    save_checkpoint(str(tmp_path), 1, tree)
    import json
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        dtypes = [e["dtype"] for e in json.load(f)["leaves"]]
    assert dtypes == ["float32", "bfloat16"]          # keys sorted: m, w
    got, _ = restore_checkpoint(str(tmp_path), {
        "w": torch.zeros(6, 7, dtype=torch.bfloat16),
        "m": torch.zeros(6, 7)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(got["m"], tree["m"])


def test_async_save_holds_the_values_at_the_call(tmp_path):
    """``save`` returns after its host copy: a tensor changed in place
    right after it restores to its value at the call."""
    t = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
         "s": torch.tensor(3, dtype=torch.int32)}
    want = {k: v.clone() for k, v in t.items()}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, t)
    t["w"].mul_(-2.0).add_(1.0)
    t["s"].add_(5)
    ck.wait()
    got, _ = ck.restore(t)
    assert torch.equal(got["w"], want["w"])
    assert torch.equal(got["s"], want["s"])


def test_async_save_error_raises_at_the_next_wait_and_save(tmp_path):
    """A failed background write raises at the caller's next ``wait``
    (or ``save``), once, and commits nothing."""
    base = tmp_path / "a_file"
    base.write_text("not a directory")
    ck = Checkpointer(str(base))
    ck.save(1, _tree(1.0))
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                  # reported once
    ck.save(2, _tree(2.0))
    with pytest.raises(OSError):
        ck.save(3, _tree(3.0))
    assert latest_step(str(base)) is None


def test_in_place_failure_restores_the_durable_step(tmp_path):
    """A step that fails inside AdamW's in-place update, after its first
    leaf was written, is not saved as an emergency checkpoint: the loop
    restores the newest durable step and replays from it, ending where an
    unfailed run ends."""
    opt = adamw(0.1, weight_decay=0.1)
    grads = {"a": torch.full((3,), 0.5), "b": torch.full((2, 2), -1.0)}
    faults = {"armed": True}

    def make_step():
        in_place = InPlaceUpdate()

        def step(state, batch):
            params, s = state
            in_place.begin()
            if faults["armed"] and int(s.step) == 2:
                faults["armed"] = False
                # the first leaf written, then the failure
                params["a"].add_(100.0)
                raise RuntimeError("failure inside update_in_place")
            g = {k: v * batch for k, v in grads.items()}
            return (params, opt.update_in_place(g, s, params)), \
                {"loss": s.step.float()}
        step.in_place = in_place
        return step

    def fresh():
        params = {"a": torch.ones(3), "b": torch.ones(2, 2)}
        return params, opt.init(params)

    faults["armed"] = False
    want, _ = ResilientLoop(make_step(), Checkpointer(str(tmp_path / "w")),
                            ckpt_every=2).run(fresh(), _batches(),
                                              num_steps=5)
    faults["armed"] = True
    ck = Checkpointer(str(tmp_path / "g"))
    loop = ResilientLoop(make_step(), ck, ckpt_every=2)
    got, end = loop.run(fresh(), _batches(), num_steps=5)
    assert loop.restarts == 1 and loop.emergency_saves == 0
    assert end == 5 and not faults["armed"]
    assert all(not ck.extra(s).get("emergency")
               for s in committed_steps(ck.base))
    for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        assert torch.equal(a, b)
    assert int(got[1].step) == int(want[1].step) == 5


def test_in_place_failure_without_a_durable_step_raises(tmp_path):
    in_place = InPlaceUpdate()

    def step(state, batch):
        in_place.begin()
        raise RuntimeError("failure inside update_in_place")
    step.in_place = in_place
    loop = ResilientLoop(step, Checkpointer(str(tmp_path)), ckpt_every=10)
    with pytest.raises(RuntimeError, match="inside update_in_place"):
        loop.run(torch.tensor(0.0), _batches(), num_steps=3)
    assert loop.emergency_saves == 0 and latest_step(str(tmp_path)) is None
