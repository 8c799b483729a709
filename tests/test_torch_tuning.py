"""The port's measured tuning against the JAX reference, on the CPU: the
measured override under an injected timer, a real host-clock pass, the
tuning curve, the ``TuningDB`` and its device rule, the training paths
with ``measure_tuning=True``, ``patch_fn`` and the launcher.

The injected timer gives both packages the same seconds in call order, so
their candidates, order, winner and ``est_*`` fields must be equal
exactly (hardware model ``TPU_V5E`` on both sides). Tolerances elsewhere:
``patch_fn`` output rtol 1e-6 / atol 1e-6 against the reference's (fp32,
another summation order); loss curves as the existing curve tests, rtol
1e-4 over 5 full-graph epochs and 1e-5 over 3 minibatch epochs (the
measured picks may differ between the packages, and with them the fp32
summation order, never the function)."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import build_cached_graph as jax_build_cached_graph
from repro.core import coo_from_edges as jax_coo_from_edges
from repro.core import patch_fn as jax_patch_fn
from repro.core import resolve as jax_resolve
from repro.core import unpatch as jax_unpatch
from repro.data import make_dataset as jax_make_dataset
from repro.models.gnn import make_gnn as jax_make_gnn
from repro.train import gnn_minibatch as jmb
from repro.train import train_gnn as jax_train_gnn

from repro_torch import obs
from repro_torch.core import patch_fn, suggest_embedding_size, tuning_curve
from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import TPU_V5E, KernelPlan, TuningDB
from repro_torch.core.cache import build_cached_graph
from repro_torch.core.patch import is_patched, patched, resolve
from repro_torch.data import make_dataset
from repro_torch.models.gnn import params_from_jax
from repro_torch.sampling import BlockPlanCache
from repro_torch.train import gnn_minibatch as mb
from repro_torch.train.gnn import train_gnn

from conftest import random_coo

# the modules (``repro.core`` binds the name ``autotune`` to the function)
jat = importlib.import_module("repro.core.autotune")
tat = importlib.import_module("repro_torch.core.autotune")

ROOT = Path(__file__).resolve().parents[1]
HIDDEN = 32
MB_KW = dict(fanouts=(4, 5), batch_size=64, hidden=16, epochs=3, seed=0,
             bucket_base=32, infer_batch=128)


def _graph(kind: str, seed: int = 0):
    """(reference COO, port COO) of one 200 x 200 graph: ``skewed`` (a
    few hub rows, power-law degrees) or ``regular`` (6 to 8 neighbours a
    row)."""
    rng = np.random.default_rng(seed)
    n = 200
    if kind == "skewed":
        deg = np.minimum((rng.pareto(1.2, n) * 3 + 1).astype(int), n)
    else:
        deg = rng.integers(6, 9, n)
    dst = np.repeat(np.arange(n), deg)
    src = np.concatenate([rng.choice(n, d, replace=False) for d in deg])
    val = rng.standard_normal(len(dst)).astype(np.float32)
    return (jax_coo_from_edges(src, dst, val, n, n),
            tsp.coo_from_edges(src, dst, val, n, n))


def _instants(spans, name):
    return [s.attrs for s in spans if s.name == name]


class _Timer:
    """``_time_callable`` stand-in: the i-th call returns ``times[i]``
    (the last entry once they run out) and runs nothing."""

    def __init__(self, times):
        self.times, self.calls = list(times), 0

    def __call__(self, fn, *args, reps=3):
        t = self.times[min(self.calls, len(self.times) - 1)]
        self.calls += 1
        return t


def _reference_measure(monkeypatch, ref, k, semiring, times):
    monkeypatch.setattr(jat, "_time_callable", _Timer(times))
    with jobs.profiled() as tracer:
        plan = jat.autotune(ref, k, hw=jat.HardwareModel(), measure=True,
                            semiring_reduce=semiring)
    return plan, _instants(tracer.snapshot(), "tuning.measure")[-1]


def _port_measure(monkeypatch, coo, k, semiring, times):
    monkeypatch.setattr(tat, "_time_callable", _Timer(times))
    with obs.profiled() as tracer:
        plan = tat.autotune(coo, k, hw=TPU_V5E, measure=True,
                            semiring_reduce=semiring, device="cpu")
    return plan, _instants(tracer.snapshot(), "tuning.measure")[-1]


# --------------------------------------------------------------------------
# the measured override against the reference (injected timer)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("winner", ["trusted", "sell", "ell"])
@pytest.mark.parametrize("k", [128, 96])
@pytest.mark.parametrize("semiring", ["sum", "mean", "max"])
@pytest.mark.parametrize("kind", ["skewed", "regular"])
def test_measured_override_matches_reference(monkeypatch, kind, semiring,
                                             k, winner):
    """Same seconds in call order on both sides: the same candidate labels
    in the same order, the same winner and the same ``est_*`` exactly.
    The table gives ``winner``'s family the least time (trusted wins
    where that family is not a candidate)."""
    ref, coo = _graph(kind)
    _, probe = _reference_measure(monkeypatch, ref, k, semiring,
                                  [1.0 + i for i in range(16)])
    labels = [name for name, _ in probe["candidates"]]
    times = [0.5 if name.startswith(winner) else 2.0 + 0.25 * i
             for i, name in enumerate(labels)]

    want, jrec = _reference_measure(monkeypatch, ref, k, semiring, times)
    got, trec = _port_measure(monkeypatch, coo, k, semiring, times)

    assert [n for n, _ in trec["candidates"]] == labels
    assert trec["candidates"] == jrec["candidates"]
    assert trec["winner"] == jrec["winner"]
    assert got.to_json() == dataclasses.asdict(want)
    assert got.kind == (winner if winner in {lbl[:len(winner)]
                                             for lbl in labels}
                        else "trusted")
    if semiring == "max" or k % 128:
        assert labels == ["trusted"]
    assert [n for n, _ in trec["estimated"]] == labels
    assert trec["device"] == "cpu"


# --------------------------------------------------------------------------
# a real measured pass on the host, and its failure modes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("semiring", ["sum", "mean", "max"])
def test_host_clock_pass_is_finite_and_logged(semiring):
    _, coo = _graph("regular")
    before = obs.metrics().counter("tuning.measured").value
    with obs.profiled() as tracer:
        plan = tat.autotune(coo, 128, measure=True, semiring_reduce=semiring,
                            device="cpu")
    rec = _instants(tracer.snapshot(), "tuning.measure")
    assert len(rec) == 1 and rec[0]["device"] == "cpu"
    assert np.isfinite(plan.est_trusted_s) and plan.est_trusted_s > 0
    assert all(np.isfinite(t) and t > 0 for _, t in rec[0]["candidates"])
    if semiring != "max":           # H100 model: every K has candidates
        assert np.isfinite(plan.est_generated_s)
        assert len(rec[0]["candidates"]) > 1
    assert obs.metrics().counter("tuning.measured").value == before + 1


def test_measured_pass_never_falls_back_to_the_host(monkeypatch):
    """No card and no ``device="cpu"``: the pass raises, it never times
    the host instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    timer = _Timer([1.0])
    monkeypatch.setattr(tat, "_time_callable", timer)
    _, coo = _graph("regular")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tat.autotune(coo, 64, measure=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning_curve(coo, (16, 32), measure=True)
    with pytest.raises(ValueError, match="no measured tuning"):
        tat.autotune(coo, 64, measure=True, device="meta")
    assert timer.calls == 0
    assert tat.autotune(coo, 64).kind in ("bsr", "ell", "sell", "trusted")


def test_failing_candidate_raises(monkeypatch):
    """A candidate whose kernel fails is an error, never skipped."""
    _, coo = _graph("regular")
    from repro_torch.kernels import ops as kops

    def broken(a, h):
        raise RuntimeError("kernel failed to launch")
    monkeypatch.setattr(kops, "ell_spmm", broken)
    monkeypatch.setattr(kops, "sell_spmm", broken)
    monkeypatch.setattr(kops, "bsr_spmm", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        tat.autotune(coo, 128, measure=True, device="cpu")


# --------------------------------------------------------------------------
# the tuning curve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["skewed", "regular", "reddit"])
def test_analytic_tuning_curve_matches_reference(kind):
    if kind == "reddit":
        ref = jax_make_dataset("reddit", scale=1 / 512, seed=1).coo
        coo = make_dataset("reddit", scale=1 / 512, seed=1).coo
    else:
        ref, coo = _graph(kind)
    want = jat.tuning_curve(ref, hw=jat.HardwareModel())
    got = tuning_curve(coo, hw=TPU_V5E)
    assert got == want
    assert suggest_embedding_size(got) == jat.suggest_embedding_size(want)


def test_measured_curve_packs_each_plan_once(monkeypatch):
    """The measured curve on the host: every K, finite speedups, and one
    host packing a candidate plan across the Ks."""
    _, coo = _graph("skewed")
    packed = []
    real = tsp.sell_from_coo

    def counting(a, c=8, sigma=0):
        packed.append((c, sigma))
        return real(a, c=c, sigma=sigma)
    monkeypatch.setattr(tsp, "sell_from_coo", counting)
    ks = (16, 32, 64)
    with obs.profiled() as tracer:
        curve = tuning_curve(coo, ks, measure=True, device="cpu")
    assert [r["k"] for r in curve] == list(ks)
    assert all(np.isfinite(r["speedup"]) and r["speedup"] > 0
               for r in curve)
    assert suggest_embedding_size(curve) in ks
    timed = [lbl for rec in _instants(tracer.snapshot(), "tuning.measure")
             for lbl, _ in rec["candidates"] if lbl.startswith("sell")]
    assert len(timed) == len(ks) and len(packed) == len(set(packed)) >= 1


# --------------------------------------------------------------------------
# the TuningDB and its device rule
# --------------------------------------------------------------------------

def test_db_miss_then_hit_times_nothing(tmp_path, monkeypatch):
    _, coo = _graph("skewed")
    path = str(tmp_path / "db.json")
    timer = _Timer([3.0, 1.0, 2.0, 2.5])
    monkeypatch.setattr(tat, "_time_callable", timer)
    miss0 = obs.metrics().counter("tuning.db.miss").value
    hit0 = obs.metrics().counter("tuning.db.hit").value
    g1 = build_cached_graph(coo, k_hint=64, measure=True, device="cpu",
                            db=TuningDB(path))
    calls = timer.calls
    assert calls >= 2 and g1.plan.kind != "trusted"
    with obs.profiled() as tracer:
        g2 = build_cached_graph(coo, k_hint=64, measure=True, device="cpu",
                                db=TuningDB(path))
    assert timer.calls == calls
    assert g2.plan == g1.plan
    assert obs.metrics().counter("tuning.db.miss").value == miss0 + 1
    assert obs.metrics().counter("tuning.db.hit").value == hit0 + 1
    plan_events = _instants(tracer.snapshot(), "tuning.plan")
    assert plan_events[-1]["source"] == "db"
    rows = json.loads(Path(path).read_text())["plans"]
    assert list(rows) == [TuningDB.key(coo, 64) + "@cpu"]


@pytest.mark.parametrize("semiring", ["sum", "mean"])
def test_db_key_equals_reference(semiring):
    ref, coo = _graph("skewed")
    key = TuningDB.key(coo, 96, semiring)
    assert key == jat.TuningDB.key(ref, 96, semiring)
    assert TuningDB.measured_key(key, "cpu") == key + "@cpu"


def test_cpu_row_is_not_served_on_the_card(tmp_path, monkeypatch):
    """A row measured on the host never serves a request that measures on
    the card (nor one on another card): the request measures afresh."""
    _, coo = _graph("regular")
    db = TuningDB(str(tmp_path / "db.json"))
    cpu_plan = KernelPlan(kind="ell", k_hint=64, est_generated_s=1.0,
                          est_trusted_s=2.0)
    db.put(coo, 64, cpu_plan, device="cpu")
    db.save()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = {"name": "NVIDIA H100 80GB HBM3"}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: card["name"])
    seen = []

    def fake_override(a, k, plan, stats, *, hw=None, semiring="sum",
                      device="cuda", packs=None):
        seen.append(str(device))
        return KernelPlan(kind="sell", k_hint=k)
    monkeypatch.setattr(tat, "_measure_override", fake_override)
    assert db.get(coo, 64, device="cpu") == cpu_plan
    assert db.get(coo, 64) is None
    assert db.get(coo, 64, device="cuda") is None
    g = build_cached_graph(coo, k_hint=64, measure=True, db=db)
    assert seen == ["cuda"] and g.plan.kind == "sell"
    assert db.get(coo, 64, device="cpu") == cpu_plan
    assert db.get(coo, 64, device="cuda") == g.plan
    card["name"] = "NVIDIA A100-SXM4-80GB"
    assert db.get(coo, 64, device="cuda") is None          # another card
    assert sorted(json.loads(Path(db.path).read_text())["plans"]) == sorted(
        [TuningDB.key(coo, 64) + "@cpu",
         TuningDB.key(coo, 64) + "@NVIDIA H100 80GB HBM3"])


def test_reference_written_db_loads(tmp_path):
    """The reference's file loads in the port: its rows serve requests
    that measure nothing, and never a measured request."""
    ref, coo = _graph("skewed")
    path = str(tmp_path / "db.json")
    jdb = jat.TuningDB(path)
    jax_build_cached_graph(ref, k_hint=128, measure=True, db=jdb)
    jdb.put_key("block64x128nse512k16srmean", jat.KernelPlan(kind="ell"))
    jdb.save()
    want = jdb.get(ref, 128)
    db = TuningDB(path)
    assert len(db) == 2
    assert db.get(coo, 128).to_json() == dataclasses.asdict(want)
    assert db.get_key("block64x128nse512k16srmean").kind == "ell"
    assert db.get(coo, 128, device="cpu") is None
    g = build_cached_graph(coo, k_hint=128, db=db)
    assert g.plan.to_json() == dataclasses.asdict(want)
    # and the reference reads the port's measured rows as rows of its own
    build_cached_graph(coo, k_hint=64, measure=True, device="cpu", db=db)
    again = jat.TuningDB(path)
    assert len(again) == 3
    assert again.get_key(TuningDB.key(coo, 64) + "@cpu") is not None


def test_block_plan_cache_measures_once_per_bucket(tmp_path):
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    from repro_torch.sampling import NeighborSampler
    blk = NeighborSampler(tsp.csr_from_coo(ds.coo), (10, 25),
                          seed=0).sample(np.arange(64))[0]
    db = TuningDB(str(tmp_path / "db.json"))
    cache = BlockPlanCache(semiring="mean", measure=True, db=db,
                           device="cpu")
    sizes = dict(n_dst=blk.n_dst, n_src=blk.n_src, nnz=blk.nnz, k_hint=128)
    assert cache.will_measure(**sizes)
    before = obs.metrics().counter("tuning.measured").value
    with obs.profiled() as tracer:
        plan = cache.plan_for(blk, **sizes)
        assert cache.plan_for(blk, **sizes) is plan
    assert not cache.will_measure(**sizes)
    assert obs.metrics().counter("tuning.measured").value == before + 1
    assert _instants(tracer.snapshot(), "tuning.plan")[0]["source"] == \
        "measure"
    key = BlockPlanCache.key(blk.n_dst, blk.n_src, blk.nnz, 128, "mean")
    assert db.get_key(key, device="cpu") == plan and db.get_key(key) is None
    fresh = BlockPlanCache(semiring="mean", measure=True, db=db,
                           device="cpu")
    assert not fresh.will_measure(**sizes)
    assert fresh.plan_for(blk, **sizes) == plan
    assert obs.metrics().counter("tuning.measured").value == before + 1


# --------------------------------------------------------------------------
# the training paths with measured tuning
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def datasets():
    return (jax_make_dataset("reddit", scale=1 / 512, seed=1),
            make_dataset("reddit", scale=1 / 512, seed=1))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["gcn", "sage-mean"])
def test_train_gnn_measured_matches_reference(datasets, tmp_path, arch):
    ref_ds, ds = datasets
    want = jax_train_gnn(arch, ref_ds, hidden=HIDDEN, epochs=5, seed=0,
                         measure_tuning=True,
                         tuning_db=jat.TuningDB(str(tmp_path / "j.json")))
    init, _ = jax_make_gnn(arch, ref_ds.num_features, HIDDEN,
                           ref_ds.num_classes)
    params = params_from_jax(_np_tree(init(jax.random.PRNGKey(0))),
                             device="cpu")
    path = str(tmp_path / "t.json")
    before = obs.metrics().counter("tuning.measured").value
    got = train_gnn(arch, ds, hidden=HIDDEN, epochs=5, device="cpu",
                    params=params, measure_tuning=True,
                    tuning_db=TuningDB(path))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert obs.metrics().counter("tuning.measured").value == before + 1
    rows = json.loads(Path(path).read_text())["plans"]
    assert len(rows) == 1 and next(iter(rows)).endswith("@cpu")
    assert rows[next(iter(rows))]["kind"] == got.plan_kind
    again = train_gnn(arch, ds, hidden=HIDDEN, epochs=2, device="cpu",
                      params=params, measure_tuning=True,
                      tuning_db=TuningDB(path))
    assert obs.metrics().counter("tuning.measured").value == before + 1
    assert again.plan_kind == got.plan_kind


def _mb_params(ref_ds):
    init, _, _, _ = jmb.make_block_model(
        "sage-mean", ref_ds.num_features, MB_KW["hidden"],
        ref_ds.num_classes, len(MB_KW["fanouts"]))
    return params_from_jax(_np_tree(init(jax.random.PRNGKey(0))),
                           device="cpu")


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_train_gnn_minibatch_measured_matches_reference(datasets, tmp_path,
                                                        sampler):
    ref_ds, ds = datasets
    want = jmb.train_gnn_minibatch(
        "sage-mean", ref_ds, sampler=sampler, measure_tuning=True,
        tuning_db=jat.TuningDB(str(tmp_path / "j.json")), **MB_KW)
    path = str(tmp_path / "t.json")
    before = obs.metrics().counter("tuning.measured").value
    got = mb.train_gnn_minibatch(
        "sage-mean", ds, sampler=sampler, device="cpu",
        params=_mb_params(ref_ds), measure_tuning=True,
        tuning_db=TuningDB(path), **MB_KW)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.n_buckets == want.n_buckets
    measured = obs.metrics().counter("tuning.measured").value - before
    rows = json.loads(Path(path).read_text())["plans"]
    assert measured >= 1 and all(k.endswith("@cpu") for k in rows)
    again = mb.train_gnn_minibatch(
        "sage-mean", ds, sampler=sampler, device="cpu",
        params=_mb_params(ref_ds), measure_tuning=True,
        tuning_db=TuningDB(path), **dict(MB_KW, epochs=1))
    assert obs.metrics().counter("tuning.measured").value - before == \
        measured
    assert again.plan_kinds == got.plan_kinds


def test_host_sampler_measures_in_the_consumer_thread(datasets,
                                                      monkeypatch):
    """With the host sampler every timed window runs in the training
    loop's thread, never in the prefetch thread."""
    _, ds = datasets
    threads = []
    real = tat._time_callable

    def recording(fn, *args, reps=3):
        threads.append(threading.current_thread().name)
        return real(fn, *args, reps=reps)
    monkeypatch.setattr(tat, "_time_callable", recording)
    res = mb.train_gnn_minibatch("sage-mean", ds, sampler="host",
                                 device="cpu", measure_tuning=True,
                                 **dict(MB_KW, epochs=2))
    assert threads and set(threads) == {threading.main_thread().name}
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()


# --------------------------------------------------------------------------
# patch_fn and the launcher
# --------------------------------------------------------------------------

def test_patch_fn_matches_reference(rng):
    """The reference's ``test_patch_fn_decorator`` case through both
    packages: the decorated call runs patched, matches the reference,
    and restores the patch state it found."""
    ref, _ = random_coo(rng, 30, 30, 100)
    h = rng.standard_normal((30, 8)).astype(np.float32)
    g_ref = jax_build_cached_graph(ref, tune=False)

    @jax_patch_fn
    def run_ref(gg, hh):
        return jax_resolve("spmm")(gg, hh, "sum")

    jax_unpatch()
    want = np.asarray(run_ref(g_ref, h))

    coo = tsp.coo_from_edges(np.asarray(ref.col)[: ref.nse],
                             np.asarray(ref.row)[: ref.nse],
                             np.asarray(ref.val)[: ref.nse], 30, 30)
    g = build_cached_graph(coo, tune=False)
    seen = []

    @patch_fn
    def run(gg, hh):
        seen.append(is_patched())
        return resolve("spmm")(gg, hh, "sum")

    for state in (False, True):
        with patched(state):
            got = run(g, torch.from_numpy(h))
            assert is_patched() is state
    with patched(True):
        tuned = resolve("spmm")(g, torch.from_numpy(h), "sum")
    assert seen == [True, True] and run.__name__ == "run"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, tuned)


def _launch(*argv):
    code = ("import runpy, sys\n"
            f"sys.argv = ['train', *{list(argv)!r}]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.train',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_launcher_trains_with_measured_tuning_without_jax(tmp_path):
    db = tmp_path / "db.json"
    args = ("--mode", "gnn", "--arch", "sage-mean", "--dataset", "reddit",
            "--scale", str(1 / 512), "--epochs", "3", "--hidden", "32",
            "--device", "cpu", "--measure-tuning", "--tuning-db", str(db))
    out = _launch(*args)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "JAX_LOADED False"
    assert lines[0].startswith("[gnn] sage-mean on reddit (iSpLib=True, "
                               "plan=")
    assert "per-epoch" in lines[1] and "test acc" in lines[1]
    rows = json.loads(db.read_text())["plans"]
    assert len(rows) == 1 and next(iter(rows)).endswith("@cpu")


def test_launcher_refuses_lm_mode():
    """LM mode runs since LM training was ported, and its checkpoint
    flags since checkpointing was; what it still refuses, before it
    builds anything, are the mesh flags not ported yet (exit 2, naming
    the ROADMAP item: here a resume over several ranks), and it loads no
    JAX."""
    out = _launch("--mode", "lm", "--arch", "llama3-8b", "--mesh-data", "2",
                  "--resume", "--ckpt-dir", "unused")
    assert out.returncode == 2
    assert "queue 1, item 5b" in out.stderr
    assert out.stdout.splitlines()[-1] == "JAX_LOADED False"
