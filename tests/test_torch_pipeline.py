"""The port's GPipe pipeline (``dist.pipeline.pipeline_apply`` over
``dist.make_pipe_mesh``) and its int8 error feedback under a ``'model'``
axis (``train/lm.make_train_step(compression=True, mesh=)``, the
launcher's ``--grad-compression int8 --mesh-model 2``), against the JAX
reference on the CPU.

One spawn of four gloo CPU ranks (``dist.run_ranks``, one compute thread
a rank, as ``(data, model)`` = (2, 2)) runs every case:

- ``pipeline_apply`` over a ``('pipe',)`` mesh of the four ranks, at the
  reference test's shapes (4 stages of ``tanh(a @ w)``, B 8, width 16)
  for ``microbatches`` in {1, 4, 8}, held to the sequential composition
  ``fn(params[3], ... fn(params[0], x))`` computed by JAX on one device
  within 1e-5 (the reference test's own oracle and tolerance: its own
  ``shard_map`` run is red, ROADMAP.md queue 3, item 3). Under autograd
  it raises, naming the backward's ROADMAP item.
- Three steps of qwen2's fp32 smoke config with ``compression=True`` on
  the (2, 2) mesh (each data rank half the batch, the ``'model'`` axis
  splitting the heads, ``d_ff`` and the vocabulary) against the
  reference's single-device compressed step on the whole batch: the
  metrics within 1e-4 and the params as ``test_torch_lm_train``'s
  ``_adam_close`` holds them. At each step every split leaf's int8 scale
  is bitwise the scale of its whole corrected gradient (gathered over
  ``'model'``), on every rank.
- The launcher's ``--mesh-model 2 --grad-compression int8`` against its
  one-rank ``--grad-compression int8`` run."""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.optim import compression as JO
from repro.train import lm as JTL

from repro_torch import dist as tdist
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.dist.partition import gather_params, param_shardings
from repro_torch.optim.optimizer import tree_leaves, tree_map
from repro_torch.train import lm as TTL

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
RANK_TIMEOUT = 300.0
S, B, D = 4, 8, 16                 # the reference test's pipeline shapes
MICROBATCHES = (1, 4, 8)
EF_ARCH, EF_B, EF_S, EF_STEPS, EF_LR = "qwen2-1.5b", 4, 32, 3, 3e-3


@pytest.fixture(autouse=True)
def _one_compute_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _pipe_inputs():
    rng = np.random.default_rng(0)
    params = (rng.standard_normal((S, D, D)).astype(np.float32)
              * np.float32(0.3))
    x = rng.standard_normal((B, D)).astype(np.float32)
    return params, x


def _stage(w, a):
    return torch.tanh(a @ w)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _pipe_case(pipe) -> dict:
    params, x = _pipe_inputs()
    p, xt = torch.from_numpy(params), torch.from_numpy(x)
    out = {}
    for m in MICROBATCHES:
        tdist.reset_wire_stats()
        out[m] = (_np(tdist.pipeline_apply(_stage, pipe, p, xt,
                                           microbatches=m)),
                  tdist.wire_stats()["ppermute"]["calls"])
    try:
        tdist.pipeline_apply(_stage, pipe, p.clone().requires_grad_(True),
                             xt)
        out["grad"] = "no raise"
    except NotImplementedError as exc:
        out["grad"] = str(exc)
    return out


def _ef_case(mesh) -> dict:
    from repro_torch.optim import compression as TO
    cfg = get_smoke_config(EF_ARCH)
    n_data, i = mesh.shape["data"], mesh.index("data")
    part = EF_B // n_data
    like = TTL.full_param_shapes(cfg)
    sh = param_shardings(mesh, like)
    step_fn, opt = TTL.make_train_step(cfg, lr=EF_LR, compression=True,
                                       mesh=mesh)
    state = TTL.make_train_state(cfg, torch.Generator().manual_seed(0), opt,
                                 compression=True, mesh=mesh)
    seen = []
    real = TTL.ef_compress_update

    def record(grads, ef, shardings=None):
        corrected = tree_map(lambda g, r: g.float() + r, grads, ef.residual)
        out = real(grads, ef, shardings)
        seen.append((corrected, out[0]))
        return out

    TTL.ef_compress_update = record
    steps, scales_match, n_split = [], [], 0
    try:
        for k in range(EF_STEPS):
            toks, tgts = synthetic_lm_batch(EF_B, EF_S, cfg.vocab, step=k)
            batch = {"tokens": torch.from_numpy(toks[i * part:(i + 1) * part]),
                     "targets": torch.from_numpy(
                         tgts[i * part:(i + 1) * part])}
            state, m = step_fn(state, batch)
            corrected, qtree = seen.pop()
            whole = gather_params(mesh, corrected, like)
            ok = []
            for c, (_, scale), s in zip(tree_leaves(whole),
                                        tree_leaves(qtree), tree_leaves(sh)):
                if s.is_split:
                    _, want = TO.int8_compress(c)
                    ok.append(bool(torch.equal(scale, want)))
            scales_match.append(all(ok))
            n_split = len(ok)
            steps.append(dict(
                metrics={key: float(v) for key, v in m.items()},
                params=tree_map(_np, gather_params(mesh, state.params,
                                                   like))))
    finally:
        TTL.ef_compress_update = real
    return dict(steps=steps, scales_match=scales_match, n_split=n_split)


def _pipe_rank(mesh) -> dict:
    torch.set_num_threads(1)
    pipe = tdist.make_pipe_mesh(device="cpu")
    return dict(pipe=_pipe_case(pipe), ef=_ef_case(mesh),
                pipe_coord=(pipe.shape["pipe"], pipe.index("pipe")),
                coords=(mesh.index("data"), mesh.index("model")))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("pipe_ranks")
    return tdist.run_ranks(_pipe_rank, RANKS, str(store), device="cpu",
                           timeout_s=RANK_TIMEOUT, model=2)


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

def _sequential() -> np.ndarray:
    """The reference test's oracle: the stages composed on one device."""
    params, x = _pipe_inputs()
    p, ref = jnp.asarray(params), jnp.asarray(x)
    for s in range(S):
        ref = jnp.tanh(ref @ p[s])
    return np.asarray(ref)


@pytest.mark.parametrize("m", MICROBATCHES)
def test_pipeline_matches_the_sequential_composition(ranks, m):
    want = _sequential()
    for r in ranks:
        got, hops = r["pipe"][m]
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err < 1e-5, (m, err)
        assert hops == S + m - 1            # one ring hop a step
    # every rank holds the drained outputs: the same bits
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["pipe"][m][0], ranks[0]["pipe"][m][0])


def test_pipeline_under_autograd_raises(ranks):
    for r in ranks:
        assert "ROADMAP.md queue 1, item 5b.6" in r["pipe"]["grad"]
    mesh = types.SimpleNamespace(shape={"pipe": 4})
    w = torch.zeros((4, 2, 2), requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 5b.6"):
        tdist.pipeline_apply(_stage, mesh, w, torch.zeros((4, 2)))


def test_pipe_mesh_is_one_axis_over_every_rank(ranks):
    mesh = tdist.make_pipe_mesh(device="cpu")
    assert mesh.shape == {"pipe": 1} and mesh.index("pipe") == 0
    assert sorted(r["pipe_coord"] for r in ranks) == [
        (RANKS, i) for i in range(RANKS)]


# --------------------------------------------------------------------------
# int8 error feedback under a 'model' axis
# --------------------------------------------------------------------------

_EF_REF: dict = {}


def _ef_reference() -> list:
    """The reference's single-device compressed step from the port's
    init, three steps on the whole batches: metrics and params."""
    if "steps" in _EF_REF:
        return _EF_REF["steps"]
    from repro_torch.models.lm import transformer as TT
    jcfg, cfg = jax_smoke_config(EF_ARCH), get_smoke_config(EF_ARCH)
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = tree_map(lambda t: jnp.array(t.numpy(), copy=True), tp)
    jstep, jopt = JTL.make_train_step(jcfg, lr=EF_LR, compression=True)
    state = JTL.TrainState(jp, jopt.init(jp), JO.ef_init(jp))
    step = jax.jit(jstep)
    out = []
    for k in range(EF_STEPS):
        toks, tgts = synthetic_lm_batch(EF_B, EF_S, cfg.vocab, step=k)
        state, m = step(state, {"tokens": jnp.asarray(toks),
                                "targets": jnp.asarray(tgts)})
        out.append(dict(metrics={key: float(v) for key, v in m.items()},
                        params=jax.tree_util.tree_map(np.asarray,
                                                      state.params)))
    _EF_REF["steps"] = out
    return out


def _adam_close(got: dict, want: dict, bound, what):
    """``test_torch_lm_train``'s param check: all but 0.1 % of the
    elements within 1e-4 relative, every element within ``bound`` (the
    first AdamW steps move an element by about lr a step, so a sign that
    rounding flips costs up to 2 lr)."""
    off = total = 0
    for key in want:
        if isinstance(want[key], dict):
            o, n = _adam_close(got[key], want[key], bound, f"{what}/{key}")
        else:
            w = np.asarray(want[key], np.float32)
            d = np.abs(np.asarray(got[key], np.float32) - w)
            o, n = int((d > 1e-4 * (np.abs(w).max() + np.abs(w))).sum()), \
                d.size
            assert d.max() <= bound, (what, key, d.max(), bound)
        off, total = off + o, total + n
    assert off <= 1e-3 * total, (what, off, total)
    return off, total


def test_int8_error_feedback_under_a_model_axis_matches_the_reference(
        ranks):
    want = _ef_reference()
    for r in ranks:
        for k, (got, ref) in enumerate(zip(r["ef"]["steps"], want)):
            for key, v in ref["metrics"].items():
                np.testing.assert_allclose(
                    got["metrics"][key], v, rtol=1e-4,
                    atol=1e-4 * abs(v), err_msg=f"step {k} {key}")
            _adam_close(got["params"], ref["params"], EF_LR * 3 * (k + 1),
                        f"step {k} params")


def test_split_leaves_quantise_onto_their_whole_leafs_scale(ranks):
    for r in ranks:
        assert r["ef"]["n_split"] > 0
        assert r["ef"]["scales_match"] == [True] * EF_STEPS, r["coords"]


def _launch(*flags, timeout=RANK_TIMEOUT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm",
         "--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--device", "cpu",
         "--steps", "2", "--log-every", "1", "--lr", "3e-3",
         "--grad-compression", "int8", *flags],
        capture_output=True, text=True, env=env, timeout=timeout,
        cwd=str(ROOT))


def _losses(out: str) -> list:
    return [(float(line.split()[3]), float(line.split()[5]))
            for line in out.splitlines() if line.startswith("  step ")]


def test_launcher_int8_over_two_model_ranks_as_one_rank():
    one = _launch()
    two = _launch("--mesh-model", "2")
    assert one.returncode == 0, one.stderr[-3000:]
    assert two.returncode == 0, two.stderr[-3000:]
    assert "mesh {'data': 1, 'model': 2} (gloo), grad sync int8" in \
        two.stdout
    got, want = _losses(two.stdout), _losses(one.stdout)
    assert len(got) == len(want) == 2, (two.stdout, one.stdout)
    for (lg, ng), (lw, nw) in zip(got, want):
        assert abs(lg - lw) <= 1e-4 and abs(ng - nw) <= 1e-3, (got, want)
