"""The port's manual expert-parallel MoE path (``models/lm/moe._moe_manual``:
each model rank its sequence block, ``dist.collectives.all_to_all`` over
the expert-parallel groups of ``Mesh.axis_group``, the sequence's pair
``split_to_axis`` / ``gather_from_axis``), its one-process stand-in
``moe_manual_reference``, and a whole model over such a mesh, against
the JAX reference on the CPU.

One spawn of eight gloo CPU ranks (``dist.run_ranks``, one compute
thread a rank) runs every case on two meshes: ``(data, model)`` = (2, 4)
(the spawn's own) and (1, 8) (made in the ranks). Three layer cases:

- ``phi`` — phi3.5-moe's smoke config (4 experts) on (2, 4), R = 1;
- ``mixtral_r2`` — mixtral's smoke config with ``n_expert_replicas=2``
  on (1, 8): two expert-parallel groups of four ranks;
- ``phi_drops`` — phi3.5 on (2, 4) with 32 tokens a rank and capacity
  factor 1.0 (16 slots a peer for 64 picks over 4 experts), where slots
  drop (the test asserts it): the manual path's per-peer capacity is not
  the einsum route's, so the oracle is the reference's manual path.

Each layer case is held against the reference's ``moe_layer`` under a
``jax.make_mesh((data, model))`` on 8 forced CPU devices (one
subprocess for every case, as ``test_multidevice.py`` runs it): the
output, the aux loss, and the gradients of ``sum(out**2) + aux`` in
``router``, ``wg``, ``wu`` and ``wd``. A rank's loss is
``sum(out_rank**2) + aux`` and its gradients are summed over
``'data'`` explicitly: the aux loss's backward hands each rank its own
tokens' share, so the sum is the reference's whole-batch gradient, with
no convention of the train step's. ``moe_manual_reference`` is held
against the same reference in this process.

The whole model (phi3.5 on (2, 4), mixtral with two replicas on (1, 8),
both under ``WHOLE_ATTENTION_RULES``: 2 KV heads cannot split over 4 or
8 ranks) is held against the one-process model whose MoE layers run
``moe_manual_reference`` (:func:`emulated_manual_path`, which swaps the
transformer's ``moe_layer``): the loss and every gradient (the ranks'
``loss_and_grads`` with the step's ``data_aux_scale``, averaged over
``'data'``; and, plain, summed over ``'data'`` against the one-process
gradients' matching sum), one ``make_train_step`` step, and prefill + 4
decode steps (the prefill through the manual path, decode's one
position through the split einsum). The leaves every model rank holds
whole stay bitwise equal across the ranks over 3 steps.

Tolerance: atol and rtol ``TOL`` = 1e-5 x the largest reference value
of each compared tensor (the same fp32 sums in other orders), the
updated params with AdamW's first step's amplification of that, as in
``tests/test_torch_tensor_parallel.py``."""
import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import dist as tdist
from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch as TD
from repro_torch.data import synthetic_lm_batch
from repro_torch.dist.partition import (WHOLE_ATTENTION_RULES, gather_params,
                                        param_shardings, shard_params)
from repro_torch.models.lm import moe as TM
from repro_torch.models.lm import transformer as TT
from repro_torch.optim.optimizer import tree_leaves, tree_map
from repro_torch.train import lm as TTL

ROOT = Path(__file__).resolve().parents[1]
RANKS = 8
RANK_TIMEOUT = 300.0
TOL = 1e-5
PHI, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x7b"
LAYER_CASES = {
    "phi": dict(arch=PHI, data=2, model=4, reps=1, cf=1.25, b=4, s=32),
    "mixtral_r2": dict(arch=MIXTRAL, data=1, model=8, reps=2, cf=1.25, b=2,
                       s=64),
    "phi_drops": dict(arch=PHI, data=2, model=4, reps=1, cf=1.0, b=4,
                      s=64),
}
MODEL_CASES = {"phi": (PHI, 2, 4, 1), "mixtral_r2": (MIXTRAL, 1, 8, 2)}
B, S, CAP, DECODE, MORE_STEPS = 4, 32, 64, 4, 2


@pytest.fixture(autouse=True)
def _one_compute_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer_cfg(c):
    return dataclasses.replace(get_smoke_config(c["arch"]),
                               n_expert_replicas=c["reps"],
                               capacity_factor=c["cf"])


def _model_cfg(arch, reps):
    return dataclasses.replace(get_smoke_config(arch),
                               n_expert_replicas=reps)


def _np(t):
    return t.detach().cpu().numpy().copy()


@contextlib.contextmanager
def emulated_manual_path(model: int, data: int = 1):
    """Inside the block the one-process model computes what the ranks of
    a ``(data, model)`` mesh compute: its MoE layers run
    ``moe_manual_reference`` where those ranks take the manual path (the
    sequence dividing over ``model``, the batch over ``data``), and the
    einsum route elsewhere (decode's one position)."""
    plain = TT.moe_layer

    def layer(cfg, p, x):
        b, s, _ = x.shape
        if cfg.moe_sparse_dispatch and s % model == 0 and b % data == 0 \
                and cfg.n_experts * cfg.n_expert_replicas == model:
            return TM.moe_manual_reference(cfg, p, x, model, data)
        return plain(cfg, p, x)

    TT.moe_layer = layer
    try:
        yield
    finally:
        TT.moe_layer = plain


# --------------------------------------------------------------------------
# the reference, one subprocess on 8 forced CPU devices
# --------------------------------------------------------------------------

_REF_BODY = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.models.lm.moe import init_moe, moe_layer
cases = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, c in cases.items():
    cfg = dataclasses.replace(get_smoke_config(c["arch"]),
                              n_expert_replicas=c["reps"],
                              capacity_factor=c["cf"])
    mesh = jax.make_mesh((c["data"], c["model"]), ("data", "model"))
    p = init_moe(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (c["b"], c["s"], cfg.d_model)), jnp.float32)

    def loss(p):
        o, aux = moe_layer(cfg, p, x)
        return jnp.sum(o ** 2) + aux, (o, aux)
    with mesh:
        (_, (o, aux)), g = jax.jit(jax.value_and_grad(loss,
                                                      has_aux=True))(p)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out[name] = dict(p=tree(p), x=np.asarray(x), out=np.asarray(o),
                     aux=float(aux), grads=tree(g))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_ref")
    src, dst = d / "cases.pkl", d / "ref.pkl"
    src.write_bytes(pickle.dumps(LAYER_CASES))
    code = ("import os\nos.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            + textwrap.dedent(_REF_BODY))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code, str(src), str(dst)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return pickle.loads(dst.read_bytes())


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _layer_rank(mesh, c, ref) -> dict:
    cfg = _layer_cfg(c)
    n_data, i = mesh.shape["data"], mesh.index("data")
    part = c["b"] // n_data
    full = {k: torch.from_numpy(v) for k, v in ref["p"].items()}
    local = shard_params(mesh, {"moe": full})["moe"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in local.items()}
    x = torch.from_numpy(ref["x"][i * part:(i + 1) * part]
                         ).requires_grad_(True)
    tdist.reset_wire_stats()
    with mesh:
        took = TM._manual_ok(cfg, x.shape[1], mesh)
        out, aux = TM.moe_layer(cfg, leaves, x)
        loss = torch.sum(out ** 2) + aux
    loss.backward()
    wire = tdist.wire_stats()
    grads = tdist.psum({k: v.grad for k, v in leaves.items()}, mesh, "data")
    whole = {k: (v if k == "router" else
                 tdist.gather_dim(v, mesh, "model", 0))
             for k, v in grads.items()}
    return dict(took=took, out=_np(out), aux=float(aux),
                grads={k: _np(v) for k, v in whole.items()},
                all_to_all=wire.get("all_to_all", {}).get("calls", 0))


def _whole_leaves(params, sh):
    out = []
    tree_map(lambda p, s: None if s.is_split else out.append(p), params, sh)
    return {str(j): p for j, p in enumerate(out)}


def _model_rank(mesh, arch, reps, d) -> dict:
    cfg = _model_cfg(arch, reps)
    n_data, i = mesh.shape["data"], mesh.index("data")
    part = B // n_data
    rows = {k: torch.from_numpy(v[i * part:(i + 1) * part])
            for k, v in d["batch"].items()}
    with tdist.use_rules(WHOLE_ATTENTION_RULES):
        like = TTL.full_param_shapes(cfg)
        sh = param_shardings(mesh, like)
        step_fn, opt = TTL.make_train_step(cfg, mesh=mesh)
        state = TTL.make_train_state(cfg, torch.Generator().manual_seed(7),
                                     opt, mesh=mesh)
        with mesh:
            scale = TTL.data_aux_scale(cfg, mesh, rows)
            loss, _, grads = TTL.loss_and_grads(cfg, state.params, rows,
                                                aux_scale=scale)
            _, _, plain = TTL.loss_and_grads(cfg, state.params, rows)
        grads = tdist.pmean(grads, mesh, "data")
        loss = tdist.pmean(loss.reshape(1), mesh, "data")[0]
        whole = gather_params(mesh, grads, like)
        summed = gather_params(mesh, tdist.psum(plain, mesh, "data"), like)
        state, metrics = step_fn(state, rows)
        stepped = tree_map(_np, gather_params(mesh, state.params, like))
        replicated = [tdist.replicas_equal(_whole_leaves(state.params, sh),
                                           mesh, "model")]
        for _ in range(MORE_STEPS):
            state, _ = step_fn(state, rows)
            replicated.append(tdist.replicas_equal(
                _whole_leaves(state.params, sh), mesh, "model"))
        params = TT.init_params(cfg, torch.Generator().manual_seed(7), "cpu",
                                mesh=mesh)
        with torch.no_grad(), mesh:
            tdist.reset_wire_stats()
            cache, logits = TT.prefill(cfg, params, {"tokens": rows["tokens"]},
                                       CAP)
            pre_a2a = tdist.wire_stats().get("all_to_all", {}).get("calls", 0)
            out = [_np(logits)]
            dec = torch.from_numpy(d["decode"][i * part:(i + 1) * part])
            tdist.reset_wire_stats()
            for t in range(DECODE):
                logits, cache = TT.decode_step(cfg, params, cache,
                                               dec[:, t:t + 1])
                out.append(_np(logits))
            dec_a2a = tdist.wire_stats().get("all_to_all", {}).get("calls", 0)
    return dict(loss=float(loss), grads=tree_map(_np, whole), step=stepped,
                aux_scale=scale, summed=tree_map(_np, summed),
                metrics={k: float(v) for k, v in metrics.items()},
                replicated=replicated, logits=out, a2a=(pre_a2a, dec_a2a),
                n_whole=len(_whole_leaves(state.params, sh)))


def _ep_rank(mesh, ref, inputs) -> dict:
    torch.set_num_threads(1)
    mesh8 = tdist.make_data_mesh(1, model=8, device="cpu")
    meshes = {(mesh.shape["data"], mesh.shape["model"]): mesh, (1, 8): mesh8}
    res = {"coords": {k: (m.index("data"), m.index("model"))
                      for k, m in meshes.items()}}
    for name, c in LAYER_CASES.items():
        res[name] = _layer_rank(meshes[(c["data"], c["model"])], c,
                                ref[name])
    for name, (arch, data, model, reps) in MODEL_CASES.items():
        res["model_" + name] = _model_rank(meshes[(data, model)], arch, reps,
                                           inputs[name])
    return res


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for name, (arch, *_rest) in MODEL_CASES.items():
        cfg = get_smoke_config(arch)
        toks, tgts = synthetic_lm_batch(B, S, cfg.vocab, step=2)
        rng = np.random.default_rng(11)
        out[name] = dict(batch={"tokens": toks, "targets": tgts},
                         decode=rng.integers(0, cfg.vocab, (B, DECODE)
                                             ).astype(np.int32))
    return out


@pytest.fixture(scope="module")
def ranks(reference, inputs, tmp_path_factory):
    store = tmp_path_factory.mktemp("ep_ranks")
    return tdist.run_ranks(_ep_rank, RANKS, str(store),
                           args=(reference, inputs), device="cpu",
                           timeout_s=RANK_TIMEOUT, model=4)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

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


def _drops(c, ref) -> int:
    """The (token, choice) pairs past their peer's ``Cs`` slots, over every
    rank of the case's mesh."""
    cfg = _layer_cfg(c)
    x = torch.from_numpy(ref["x"])
    router = torch.from_numpy(ref["p"]["router"])
    bl, sl = c["b"] // c["data"], c["s"] // c["model"]
    cs = TM.manual_capacity(cfg, bl * sl)
    n = 0
    for i in range(c["data"]):
        for j in range(c["model"]):
            flat = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].reshape(
                bl * sl, -1)
            _, _, top_i = TM.route_manual(flat.float() @ router, cfg.top_k)
            pos, _ = TD._slot_positions(top_i.reshape(-1).to(torch.int32),
                                        cfg.n_experts)
            n += int((pos >= cs).sum())
    return n


def _rows_of(ranks, mesh_key, model_coord=0):
    """The ranks of ``mesh_key``'s first model column, in data order."""
    picked = [r for r in ranks if r["coords"][mesh_key][1] == model_coord]
    return sorted(picked, key=lambda r: r["coords"][mesh_key][0])


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_manual_layer_matches_the_references_manual_path(ranks, reference,
                                                         case):
    c, ref = LAYER_CASES[case], reference[case]
    key = (c["data"], c["model"])
    for r in ranks:
        got = r[case]
        assert got["took"], case                 # the manual path ran
        assert got["all_to_all"] == 4            # 2 forward, 2 backward
        _close(got["aux"], ref["aux"], f"{case} aux")
        _walk(got["grads"], ref["grads"], f"{case} grads")
    for j in range(c["model"]):
        out = np.concatenate([r[case]["out"]
                              for r in _rows_of(ranks, key, j)], 0)
        _close(out, ref["out"], f"{case} out (model rank {j})")


def test_a_drop_case_drops_slots(reference):
    assert _drops(LAYER_CASES["phi_drops"], reference["phi_drops"]) > 0


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_manual_reference_matches_the_reference(reference, case):
    c, ref = LAYER_CASES[case], reference[case]
    cfg = _layer_cfg(c)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in ref["p"].items()}
    out, aux = TM.moe_manual_reference(cfg, p, torch.from_numpy(ref["x"]),
                                       c["model"], c["data"])
    (torch.sum(out ** 2) + aux).backward()
    _close(_np(out), ref["out"], f"{case} out")
    _close(float(aux), ref["aux"], f"{case} aux")
    _walk({k: _np(v.grad) for k, v in p.items()}, ref["grads"],
          f"{case} grads")


_ORACLES: dict = {}


def _oracle(name, d) -> dict:
    """The one-process model under :func:`emulated_manual_path`: loss and
    gradients (and the gradients without the aux term), one step,
    prefill + decode logits."""
    if name in _ORACLES:
        return _ORACLES[name]
    arch, data, model, reps = MODEL_CASES[name]
    cfg = _model_cfg(arch, reps)
    batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
    with emulated_manual_path(model, data):
        step_fn, opt = TTL.make_train_step(cfg)
        state = TTL.make_train_state(cfg, torch.Generator().manual_seed(7),
                                     opt, device="cpu")
        loss, _, grads = TTL.loss_and_grads(cfg, state.params, batch)
        _, _, no_aux = TTL.loss_and_grads(
            dataclasses.replace(cfg, router_aux_weight=0.0), state.params,
            batch)
        norm = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                    for g in tree_leaves(
                                        TM.tie_expert_replica_grads(
                                            cfg, grads)))))
        tied = tree_map(_np, TM.tie_expert_replica_grads(cfg, grads))
        state, metrics = step_fn(state, batch)
        params = TT.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
        with torch.no_grad():
            cache, logits = TT.prefill(cfg, params,
                                       {"tokens": batch["tokens"]}, CAP)
            out = [_np(logits)]
            dec = torch.from_numpy(d["decode"])
            for t in range(DECODE):
                logits, cache = TT.decode_step(cfg, params, cache,
                                               dec[:, t:t + 1])
                out.append(_np(logits))
    _ORACLES[name] = dict(loss=float(loss), grads=tree_map(_np, grads),
                          no_aux=tree_map(_np, no_aux),
                          tied=tied, norm=norm,
                          step=tree_map(_np, state.params),
                          metrics={k: float(v) for k, v in metrics.items()},
                          logits=out)
    return _ORACLES[name]


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_whole_model_loss_and_gradients_match_the_emulation(ranks, inputs,
                                                            name):
    want = _oracle(name, inputs[name])
    for r in ranks:
        got = r["model_" + name]
        _close(got["loss"], want["loss"], f"{name} loss")
        _walk(got["grads"], want["grads"], f"{name} grads")


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_whole_model_plain_gradients_summed_over_data(ranks, inputs, name):
    """Each rank's ``loss_and_grads`` unscaled (its rows' mean
    cross-entropy plus the whole batch's aux loss, whose backward is the
    rank's own share), summed explicitly over ``'data'``: D x the
    one-process cross-entropy gradient plus the whole aux gradient, i.e.
    ``(D - 1) grad(xent) + grad(xent + w aux)``. The train step's
    ``data_aux_scale`` is D exactly where the manual path ran."""
    arch, data, model, reps = MODEL_CASES[name]
    want = _oracle(name, inputs[name])
    expect = tree_map(lambda g, g0: (data - 1) * g0.astype(np.float64) + g,
                      want["grads"], want["no_aux"])
    for r in ranks:
        got = r["model_" + name]
        assert got["aux_scale"] == data, (name, got["aux_scale"])
        _walk(got["summed"], expect, f"{name} summed grads")


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_whole_model_train_step_matches_the_emulation(ranks, inputs, name):
    want = _oracle(name, inputs[name])
    clip = min(1.0, 1.0 / want["norm"])
    for r in ranks:
        got = r["model_" + name]
        _walk_step(got["step"], want["step"], want["tied"], 3e-4, clip,
                   f"{name} params")
        _close(got["metrics"]["loss"], want["metrics"]["loss"], "step loss")
        _close(got["metrics"]["grad_norm"], want["norm"], "grad norm")
        assert got["replicated"] == [True] * (1 + MORE_STEPS), name
        assert got["n_whole"] > 0


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_whole_model_serving_matches_the_emulation(ranks, inputs, name):
    arch, data, model, reps = MODEL_CASES[name]
    cfg = _model_cfg(arch, reps)
    want = _oracle(name, inputs[name])
    for j in range(model):
        got = _rows_of(ranks, (data, model), j)
        for r in got:
            # the prefill's layers through the manual path (2 exchanges
            # a layer), decode's one position through the split einsum
            assert r["model_" + name]["a2a"] == (2 * cfg.n_layers, 0)
        logits = [np.concatenate(parts, 0) for parts in zip(
            *[r["model_" + name]["logits"] for r in got])]
        assert len(logits) == DECODE + 1
        for step, (g, w) in enumerate(zip(logits, want["logits"])):
            assert g.shape == w.shape, (step, g.shape, w.shape)
            _close(g, w, f"{name} logits of step {step}")


def test_expert_groups_are_the_references():
    cfg = _model_cfg(MIXTRAL, 2)
    assert TM.ep_groups(cfg) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert TM.manual_capacity(cfg, 16) == 16       # int(10) rounded up
    assert TM.manual_capacity(cfg, 4) == 8          # at least 8
    assert TM.manual_capacity(dataclasses.replace(cfg, capacity_factor=1.0),
                              32) == 16
    # a mesh of one rank never takes the manual path
    x = torch.zeros((1, 8, cfg.d_model))
    assert not TM._manual_ok(cfg, x.shape[1], None)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _launch(*flags, timeout=RANK_TIMEOUT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm",
         "--arch", PHI, "--smoke", "--device", "cpu", "--steps", "2",
         "--log-every", "1", "--lr", "3e-3", *flags],
        capture_output=True, text=True, env=env, timeout=timeout,
        cwd=str(ROOT))


def _losses(out: str) -> list:
    return [(float(line.split()[3]), float(line.split()[5]))
            for line in out.splitlines() if line.startswith("  step ")]


def _emulated_launch(steps: int = 2) -> list:
    """The launcher's run (seed 0, lr 3e-3, batch 8 x 128, its token
    stream) in this process, with the MoE layers' manual path emulated for
    a ``'model'`` axis of 4: each step's (loss, grad_norm)."""
    from repro_torch.data import token_stream
    cfg = get_smoke_config(PHI)
    step_fn, opt = TTL.make_train_step(cfg, lr=3e-3)
    state = TTL.make_train_state(cfg, torch.Generator().manual_seed(0), opt,
                                 device="cpu")
    out = []
    with emulated_manual_path(4):
        for _, (toks, tgts) in zip(range(steps),
                                   token_stream(8, 128, cfg.vocab)):
            state, m = step_fn(state, {"tokens": torch.from_numpy(toks),
                                       "targets": torch.from_numpy(tgts)})
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def test_launcher_model_axis_of_the_experts_takes_the_manual_path():
    """``--mesh-model 4`` on phi3.5's smoke config (4 experts): the MoE
    layers take the manual path and the launcher keeps the attention
    whole by itself (the default rules would cut its 2 KV heads), two
    steps, whose printed losses and norms are the one-process
    emulation's (the einsum route's differ from step 1 on: the per-peer
    capacity drops slots it keeps)."""
    four = _launch("--mesh-model", "4")
    assert four.returncode == 0, four.stderr[-3000:]
    assert "mesh {'data': 1, 'model': 4} (gloo)" in four.stdout
    assert "the attention whole" in four.stdout
    assert "manual expert parallelism" in four.stdout
    got, want = _losses(four.stdout), _emulated_launch()
    assert len(got) == len(want) == 2, four.stdout
    # the printed loss and norm: 4 decimals and 3
    for (lg, ng), (lw, nw) in zip(got, want):
        assert abs(lg - lw) <= 1e-4 and abs(ng - nw) <= 1e-3, (got, want)


def test_the_active_rules_reach_another_thread():
    """The autograd engine runs a card tensor's backward on a thread of its
    own, where a recomputed layer must see the forward's rules (as it
    sees the active mesh)."""
    import threading
    seen = []
    worker = threading.Thread(
        target=lambda: seen.append(tdist.current_rules()))
    with tdist.use_rules(WHOLE_ATTENTION_RULES):
        worker.start()
        worker.join()
    assert seen == [WHOLE_ATTENTION_RULES]
    assert tdist.current_rules() is tdist.LM_RULES
