"""The port's tensor and expert parallelism over the ``'model'`` axis
(``dist.partition.shard_params`` / ``gather_params``, the Megatron pair
of ``dist.collectives``, the split layers of ``models/lm``, the sharded
``global_norm``, ``train/lm.make_train_step(mesh=)``, the launcher's
``--mesh-model``) against the JAX reference, on the CPU.

Two spawns of gloo CPU ranks (``dist.run_ranks``, one compute thread a
rank): 2 ranks on a ``'model'`` axis of 2, and 4 ranks as ``'data'`` 2 x
``'model'`` 2. Each runs every case of four fp32 smoke configs: qwen2
(tied embeddings, QKV bias, one KV head a rank), phi3.5-moe, mixtral
with ``n_expert_replicas=2`` (a replica on each model rank) and
internvl2 (an image prefix). The weights are the reference's
``init_params``, carried across with ``params_from_jax``'s arrays and
``shard_params``. The reference's own sharded LM tests are red in this
repository's runs, so the port is held against the reference's
**single-device** functions: ``loss_fn`` and its gradients
(``jax.value_and_grad``), one ``make_train_step`` step, and ``prefill``
+ 4 ``decode_step``s. With a ``'data'`` axis of 2 each data rank takes
half the batch (the MoE routes and drops per rank), so the reference is
the mean of its results on the two halves (its optimizer applied to the
mean gradient) and its logits on each half.

Tolerance: atol and rtol ``TOL`` = 1e-5 x the largest reference value
of each compared leaf (the loss, a gradient, an updated param, a step's
logits): the same fp32 sums in another order (a split product's partial
sums, the vocabulary's max and log-sum-exp reduced over ranks). The
updated params add AdamW's part: its first step moves an element by lr
x / (|x| + eps), x the clipped gradient c g, so the gradient's own
tolerance, TOL (max|g| + |g|), reaches the element as lr c eps TOL
(max|g| + |g|) / (c |g| + eps)^2, never more than 2 lr (where the
gradient is rounding noise: the key bias's is zero in exact arithmetic,
the softmax being blind to a shift of every score). Within
each run, the leaves every model rank holds whole (norm scales, the
router, image-prefix and meta rows) are bitwise equal across the model
ranks after each of 3 steps."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm.transformer as JT
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.lm.moe import tie_expert_replica_grads as jax_tie
from repro.train import lm as JTL

from repro_torch import dist as tdist
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.dist.collectives import (axis_sum, copy_to_axis,
                                          reduce_from_axis)
from repro_torch.dist.partition import (gather_params, param_shardings,
                                        shard_params)
from repro_torch.models.lm import transformer as TT
from repro_torch.optim.optimizer import global_norm, tree_leaves, tree_map
from repro_torch.train import lm as TTL

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 300.0
TOL = 1e-5
ARCHS = ("qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "mixtral-8x7b",
         "internvl2-2b")
B, S, CAP, DECODE, MORE_STEPS = 4, 32, 64, 4, 2
MESHES = {"m2": (2, 2), "d2m2": (4, 2)}       # (ranks, model)


@pytest.fixture(autouse=True)
def _one_compute_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    if arch == "mixtral-8x7b":
        cfg = dataclasses.replace(cfg, n_expert_replicas=2)
        jcfg = dataclasses.replace(jcfg, n_expert_replicas=2)
    return cfg, jcfg


def _inputs(arch) -> dict:
    """The reference's params and the batch, as numpy."""
    cfg, jcfg = _cfgs(arch)
    params = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(3)))
    toks, tgts = synthetic_lm_batch(B, S, cfg.vocab, step=1)
    rng = np.random.default_rng(5)
    batch = {"tokens": toks, "targets": tgts}
    if cfg.family == "vlm":
        batch["image_emb"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    dec = rng.integers(0, cfg.vocab, (B, DECODE)).astype(np.int32)
    return dict(params=params, batch=batch, decode=dec)


def _rows(tree: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in tree.items()}


def _np(t):
    return t.detach().cpu().numpy().copy()     # the steps update in place


def _serve(cfg, params, batch, dec, module):
    """prefill + DECODE decode steps: the logits of each (numpy)."""
    tensor = module is TT
    conv = (lambda a: torch.from_numpy(a)) if tensor else jnp.asarray
    pre = {k: conv(v) for k, v in batch.items() if k != "targets"}
    cache, logits = module.prefill(cfg, params, pre, CAP)
    out = [logits]
    for i in range(DECODE):
        logits, cache = module.decode_step(cfg, params, cache,
                                           conv(dec[:, i:i + 1]))
        out.append(logits)
    return [_np(x) if tensor else np.asarray(x) for x in out]


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _arch_rank(mesh, arch, d) -> dict:
    cfg, _ = _cfgs(arch)
    n_data, i = mesh.shape["data"], mesh.index("data")
    part = B // n_data
    full = TT.params_from_jax(d["params"], device="cpu")
    like = TTL.full_param_shapes(cfg)
    local = shard_params(mesh, full)
    batch = {k: torch.from_numpy(v) for k, v in
             _rows(d["batch"], i * part, (i + 1) * part).items()}
    # loss and gradients, averaged over 'data'
    with mesh:
        loss, _, grads = TTL.loss_and_grads(cfg, local, batch)
    grads = tdist.pmean(grads, mesh, "data")
    loss = tdist.pmean(loss.reshape(1), mesh, "data")[0]
    sh = param_shardings(mesh, like)
    whole = gather_params(mesh, grads, like)
    norms = (float(global_norm(grads, sh)), float(global_norm(whole)))
    # one make_train_step step, then MORE_STEPS more on the same batch
    step_fn, opt = TTL.make_train_step(cfg, mesh=mesh)
    state = TTL.TrainState(tree_map(torch.clone, local), opt.init(local),
                           None)
    state, metrics = step_fn(state, batch)
    stepped = tree_map(_np, gather_params(mesh, state.params, like))
    def whole_leaves(params):         # the leaves every model rank holds
        out = []
        tree_map(lambda p, s: None if s.is_split else out.append(p),
                 params, sh)
        return {str(j): p for j, p in enumerate(out)}
    replicated = [tdist.replicas_equal(whole_leaves(state.params), mesh,
                                       "model")]
    for _ in range(MORE_STEPS):
        state, _ = step_fn(state, batch)
        replicated.append(tdist.replicas_equal(whole_leaves(state.params),
                                               mesh, "model"))
    with torch.no_grad(), mesh:
        logits = _serve(cfg, local, _rows(d["batch"], i * part,
                                          (i + 1) * part),
                        d["decode"][i * part:(i + 1) * part], TT)
    return dict(loss=float(loss), grads=tree_map(_np, whole),
                norms=norms, step=stepped,
                metrics={k: float(v) for k, v in metrics.items()},
                replicated=replicated,
                n_whole=len(whole_leaves(state.params)),
                logits=logits)


def _pair_rank(mesh) -> dict:
    """The Megatron pair against ``axis_sum`` on rank-dependent inputs."""
    r = mesh.index("model")
    x = torch.arange(6.0).reshape(2, 3) * (r + 1)
    g = torch.full((2, 3), 1.0 + r)
    out = {}
    for name, fn in (("copy", copy_to_axis), ("reduce", reduce_from_axis),
                     ("axis_sum", axis_sum)):
        xi = x.clone().requires_grad_(True)
        y = fn(xi, mesh, "model")
        y.backward(g)
        out[name] = (_np(y), _np(xi.grad))
    return out


def _tp_rank(mesh, inputs) -> dict:
    torch.set_num_threads(1)
    res = {arch: _arch_rank(mesh, arch, inputs[arch]) for arch in ARCHS}
    res["pair"] = _pair_rank(mesh)
    res["coords"] = (mesh.index("data"), mesh.index("model"))
    return res


@pytest.fixture(scope="module")
def inputs():
    return {arch: _inputs(arch) for arch in ARCHS}


_RUNS: dict = {}


@pytest.fixture(scope="module", params=sorted(MESHES))
def tp_run(request, inputs, tmp_path_factory):
    """One spawn of the ranks of a mesh: every rank's results."""
    name = request.param
    if name not in _RUNS:
        n, m = MESHES[name]
        store = tmp_path_factory.mktemp(f"tp_{name}")
        _RUNS[name] = tdist.run_ranks(_tp_rank, n, str(store),
                                      args=(inputs,), device="cpu",
                                      timeout_s=RANK_TIMEOUT, model=m)
    return name, _RUNS[name]


# --------------------------------------------------------------------------
# the reference, single-device
# --------------------------------------------------------------------------

_REFS: dict = {}


def _reference(arch, n_data, d) -> dict:
    key = (arch, n_data)
    if key in _REFS:
        return _REFS[key]
    _, jcfg = _cfgs(arch)
    params = jax.tree_util.tree_map(jnp.asarray, d["params"])
    part = B // n_data
    halves = [{k: jnp.asarray(v) for k, v in
               _rows(d["batch"], i * part, (i + 1) * part).items()}
              for i in range(n_data)]
    vg = jax.value_and_grad(lambda p, b: JT.loss_fn(jcfg, p, b),
                            has_aux=True)
    outs = [vg(params, h) for h in halves]
    loss = float(np.mean([float(o[0][0]) for o in outs]))
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / n_data,
                                   *[o[1] for o in outs])
    step_fn, opt = JTL.make_train_step(jcfg)
    state = JTL.TrainState(params, opt.init(params), None)
    tied = jax_tie(jcfg, grads)
    if n_data == 1:                 # the reference's step as it is
        new, metrics = jax.jit(step_fn)(state, halves[0])
        stepped = new.params
        norm = float(metrics["grad_norm"])
    else:                           # its update of the mean gradient
        upd, _ = opt.update(tied, state.opt_state, params)
        stepped = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype),
                                         params, upd)
        norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                                  for g in jax.tree_util.tree_leaves(tied))))
    logits = [np.concatenate(parts, 0) for parts in zip(*[
        _serve(jcfg, params, _rows(d["batch"], i * part, (i + 1) * part),
               d["decode"][i * part:(i + 1) * part], JT)
        for i in range(n_data)])]
    _REFS[key] = dict(
        loss=loss, grads=jax.tree_util.tree_map(np.asarray, grads),
        step=jax.tree_util.tree_map(np.asarray, stepped), norm=norm,
        tied=jax.tree_util.tree_map(np.asarray, tied), logits=logits)
    return _REFS[key]


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def _walk(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got), set(want))
        for k in want:
            _walk(got[k], want[k], f"{what}/{k}")
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    _close(got, want, what)


def _n_data(name):
    n, m = MESHES[name]
    return n // m


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_single_device(tp_run, inputs, arch):
    name, ranks = tp_run
    ref = _reference(arch, _n_data(name), inputs[arch])
    for r in ranks:
        _close(r[arch]["loss"], ref["loss"], f"{name} {arch} loss")
        _walk(r[arch]["grads"], ref["grads"], f"{name} {arch} grads")


def _walk_step(got, want, grad, lr, clip, what=""):
    """Updated params: TOL x max|want| (and TOL relative), plus the
    gradient's tolerance carried through AdamW's first step."""
    if isinstance(want, dict):
        for k in want:
            _walk_step(got[k], want[k], grad[k], lr, clip, f"{what}/{k}")
        return
    eps, g = 1e-8, np.abs(grad).astype(np.float64)
    adam = lr * clip * eps * TOL * (g.max() + g) / (clip * g + eps) ** 2
    bound = TOL * (np.abs(want).max() + np.abs(want)) + np.minimum(
        adam, 2 * lr)
    excess = np.abs(got.astype(np.float64) - want) - bound
    assert excess.max() <= 0, (what, float(excess.max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_single_device(tp_run, inputs, arch):
    name, ranks = tp_run
    ref = _reference(arch, _n_data(name), inputs[arch])
    lr = 3e-4                               # both step factories' default
    clip = min(1.0, 1.0 / ref["norm"])      # clip_norm 1.0, both
    for r in ranks:
        _walk_step(r[arch]["step"], ref["step"], ref["tied"], lr, clip,
                   f"{name} {arch} params")
        _close(r[arch]["metrics"]["loss"], ref["loss"], "step loss")
        _close(r[arch]["metrics"]["grad_norm"], ref["norm"], "grad norm")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_logits_match_single_device(tp_run, inputs, arch):
    name, ranks = tp_run
    ref = _reference(arch, _n_data(name), inputs[arch])
    m = MESHES[name][1]
    # every rank returns its data block's whole logits
    for j in range(m):
        got = [np.concatenate(parts, 0) for parts in zip(
            *[r[arch]["logits"] for r in ranks if r["coords"][1] == j])]
        assert len(got) == DECODE + 1
        for step, (g, w) in enumerate(zip(got, ref["logits"])):
            assert g.shape == w.shape, (step, g.shape, w.shape)
            _close(g, w, f"{name} {arch} logits of step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_leaves_stay_bitwise_equal_across_model_ranks(tp_run, arch):
    name, ranks = tp_run
    for r in ranks:
        assert r[arch]["n_whole"] > 0
        assert r[arch]["replicated"] == [True] * (1 + MORE_STEPS), name


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_global_norm_is_the_whole_trees(tp_run, arch):
    name, ranks = tp_run
    for r in ranks:
        split, whole = r[arch]["norms"]
        assert abs(split - whole) <= 1e-6 * whole, (name, split, whole)


def test_megatron_pair_against_axis_sum(tp_run):
    """copy_to_axis: identity forward, the ranks' gradients summed
    backward (axis_sum's backward); reduce_from_axis: axis_sum's forward,
    the gradient unchanged backward."""
    name, ranks = tp_run
    m = MESHES[name][1]
    for r in ranks:
        mi = r["coords"][1]
        x = np.arange(6.0).reshape(2, 3) * (mi + 1)
        total_x = sum(np.arange(6.0).reshape(2, 3) * (k + 1)
                      for k in range(m))
        total_g = sum(np.full((2, 3), 1.0 + k) for k in range(m))
        y, gx = r["pair"]["copy"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(gx, total_g)
        y, gx = r["pair"]["reduce"]
        np.testing.assert_array_equal(y, total_x)
        np.testing.assert_array_equal(gx, np.full((2, 3), 1.0 + mi))
        ys, gs = r["pair"]["axis_sum"]
        np.testing.assert_array_equal(ys, total_x)
        np.testing.assert_array_equal(gs, total_g)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _launch(*flags, timeout=RANK_TIMEOUT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm",
         "--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--device", "cpu",
         "--steps", "2", "--log-every", "1", "--lr", "3e-3", *flags],
        capture_output=True, text=True, env=env, timeout=timeout,
        cwd=str(ROOT))


def _losses(out: str) -> list:
    return [(float(line.split()[3]), float(line.split()[5]))
            for line in out.splitlines() if line.startswith("  step ")]


def test_launcher_model_axis_takes_two_steps_as_one_rank():
    one = _launch()
    two = _launch("--mesh-model", "2")
    assert one.returncode == 0, one.stderr[-3000:]
    assert two.returncode == 0, two.stderr[-3000:]
    assert "mesh {'data': 1, 'model': 2} (gloo)" in two.stdout
    got, want = _losses(two.stdout), _losses(one.stdout)
    assert len(got) == len(want) == 2, (two.stdout, one.stdout)
    # the printed loss and norm: 4 decimals and 3
    for (lg, ng), (lw, nw) in zip(got, want):
        assert abs(lg - lw) <= 1e-4 and abs(ng - nw) <= 1e-3, (got, want)


def test_launcher_resume_over_two_model_ranks_exits_2(tmp_path):
    out = _launch("--mesh-model", "2", "--resume", "--ckpt-dir",
                  str(tmp_path))
    assert out.returncode == 2
    assert "ROADMAP.md queue 1, item 5b.4" in out.stderr
