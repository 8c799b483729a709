"""The port's LM training slice against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through ``repro`` and
``repro_torch``: the optimizers, schedules and int8 error-feedback
compression on identical grads; the gradients of both LM kernels'
``autograd.Function``s (flash attention's plain backward, the ragged
GEMM's dX and dW) against ``jax.grad`` of the reference's XLA routes;
``moe_mlp`` / ``route_topk`` gradients and the replica tie; ``loss_fn``
and its gradients for the five ported smoke configs; the remat policies;
and three steps of ``make_train_step`` (plain, ``accum=2``,
``compression=True``) against the reference's jitted step.

Tolerances, all fp32:
- the optimizer, the schedules and the compression on identical inputs:
  updates and states within 1e-6 relative (the same elementwise fp32
  arithmetic; ``pow`` and ``sqrt`` may round 1 ulp apart), int8 codes,
  scales and EF residuals bitwise;
- single ops and their gradients (attention, the ragged GEMM, the MoE
  MLP): atol / rtol 1e-5 x the largest reference value — the same sums
  in another order over at most a few hundred terms of magnitude ~1;
- ``loss_fn`` and its gradients: loss rtol 1e-5, each gradient within
  1e-4 of its largest reference element (the residual stream reaches
  ~10^2 through the experts' fan-in rule, where an fp32 ulp is ~1e-5);
- three train steps: the four metrics rtol 1e-4; params within 1e-4
  relative (of the element and of the leaf's largest) for all but 0.1 %
  of all their elements, and every element within 3 lr a step taken.
  AdamW's direction m_hat / sqrt(v_hat) does not shrink with the
  gradient: where the accumulated m_hat is near 0 against sqrt(v_hat) (a
  gradient that changed sign between steps), fp32 sums in another order
  move that element by a sizeable part of an update (measured over the
  five smoke configs, from the port's init and from the reference's: at
  most 0.033 % of the elements off, by at most 2.3 lr; the metrics
  within 2.2e-5).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm.transformer as JT
import repro.optim as JO
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import dispatch as JD
from repro.models.lm import attention as JA
from repro.models.lm.moe import tie_expert_replica_grads as jax_tie
from repro.train import lm as JTL

import repro_torch.optim as TO
from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch as TD
from repro_torch.data import synthetic_lm_batch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain_lse)
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as TLM
from repro_torch.models.lm import transformer as TT
from repro_torch.models.lm.moe import tie_expert_replica_grads
from repro_torch.optim import optimizer as TOO
from repro_torch.optim.optimizer import tree_leaves, tree_map
from repro_torch.train import lm as TTL

ARCHS = ("phi3.5-moe-42b-a6.6b", "mixtral-8x7b", "llama3-8b", "qwen2-1.5b",
         "gemma-7b")
OP_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_compute_thread():
    """One intra-op thread a test: the suite runs beside other workers,
    and a process's idle OpenMP threads spin between the many small ops
    these tests run, which slowed each such test 40x or more beside the
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _n(a):
    return np.asarray(a.detach().cpu().float().numpy()
                      if isinstance(a, torch.Tensor) else a, np.float32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rel, what=""):
    want, got = np.asarray(want, np.float32), _n(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=what)


def _walk_close(got: dict, want: dict, rel, what=""):
    assert set(got) == set(want), (what, set(got), set(want))
    for key in want:
        if isinstance(want[key], dict):
            _walk_close(got[key], want[key], rel, f"{what}/{key}")
        else:
            _close(got[key], want[key], rel, f"{what}/{key}")


def _jparams(cfg, seed=0):
    """The same random params for both packages: the port's init (the
    reference's rules), copied to the reference (the port's train step
    updates its params in place)."""
    tp = TLM.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    return tree_map(lambda t: jnp.array(t.numpy(), copy=True), tp), tp


def _batch(cfg, b, s, step):
    toks, tgts = synthetic_lm_batch(b, s, cfg.vocab, step=step)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)},
            {"tokens": _t(toks), "targets": _t(tgts)})


# --------------------------------------------------------------------------
# optimizers, schedules, compression
# --------------------------------------------------------------------------

def _tree(rng, dtype):
    shapes = {"a": (6, 5), "blk": {"w": (4, 3, 2), "b": (7,)}}

    def make(s):
        return _rand(rng, *s) if not isinstance(s, dict) else \
            {k: make(v) for k, v in s.items()}
    np_tree = make(shapes)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), np_tree),
            tree_map(lambda a: _t(a).to(tdt), np_tree))


def _same_tree(got, want, rel, what):
    """Nested dicts matched by key (JAX orders its leaves by sorted key),
    dtypes equal."""
    assert set(got) == set(want), what
    for key in want:
        if isinstance(want[key], dict):
            _same_tree(got[key], want[key], rel, f"{what}/{key}")
            continue
        a, b = got[key], want[key]
        assert str(a.dtype).split(".")[-1] == str(b.dtype), (what, a.dtype,
                                                             b.dtype)
        _close(a, np.asarray(b, np.float32), rel, f"{what}/{key}")


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("sched", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_matches_reference(rng, dtype, sched, clip):
    """bf16 (or fp32) params with fp32 moments, clipping, a schedule:
    three updates on identical grads."""
    jp, tp = _tree(rng, dtype)
    lr = {"constant": (1e-2, 1e-2),
          "warmup_cosine": (JO.warmup_cosine(1e-2, 2, 6),
                            TO.warmup_cosine(1e-2, 2, 6))}[sched]
    jopt = JO.adamw(lr[0], weight_decay=0.1, clip_norm=clip,
                    state_dtype=jnp.float32)
    topt = TO.adamw(lr[1], weight_decay=0.1, clip_norm=clip,
                    state_dtype=torch.float32)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        jg, tg = _tree(np.random.default_rng(10 + i), dtype)
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        _same_tree(tu, ju, 1e-6, f"updates {i}")
        _same_tree(ts.mu, js.mu, 1e-6, f"mu {i}")
        _same_tree(ts.nu, js.nu, 1e-6, f"nu {i}")
        assert int(ts.step) == int(js.step) == i + 1
        jp, tp = JO.apply_updates(jp, ju), TO.apply_updates(tp, tu)
        _same_tree(tp, jp, 1e-6, f"params {i}")


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_matches_reference(rng, momentum, nesterov):
    jp, tp = _tree(rng, "f32")
    jopt = JO.sgd(0.1, momentum=momentum, nesterov=nesterov, clip_norm=1.0)
    topt = TO.sgd(0.1, momentum=momentum, nesterov=nesterov, clip_norm=1.0)
    js, ts = jopt.init(jp), topt.init(tp)
    assert (ts.momentum is None) == (momentum == 0.0)
    for i in range(3):
        jg, tg = _tree(np.random.default_rng(20 + i), "f32")
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        _same_tree(tu, ju, 1e-6, f"sgd updates {i}")


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_global_norm_and_clip_match_reference(rng, dtype, max_norm):
    jt, tt = _tree(rng, dtype)
    _close(TO.global_norm(tt), np.asarray(JO.global_norm(jt)), 1e-6)
    jc, jn = JO.clip_by_global_norm(jt, max_norm)
    tc, tn = TO.clip_by_global_norm(tt, max_norm)
    _close(tn, np.asarray(jn), 1e-6)
    _same_tree(tc, jc, 1e-6, "clipped")


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)), ("linear_warmup", (0.1, 5)),
    ("cosine_decay", (0.1, 7, 0.1)), ("warmup_cosine", (0.1, 3, 10))])
def test_schedules_match_reference(name, args):
    """The step stays a device tensor; the fp32 values match over the
    warm-up, the decay and past its end."""
    tf, jf = getattr(TO, name)(*args), getattr(JO, name)(*args)
    for i in range(14):
        got = tf(torch.tensor(i, dtype=torch.int32))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        _close(got, np.asarray(jf(jnp.asarray(i, jnp.int32))), 1e-6,
               f"{name} step {i}")


def test_int8_compression_and_error_feedback_are_bitwise(rng):
    """int8 codes, scales and EF residuals over 3 steps, bitwise; a
    half-way quotient rounds to even, as ``jnp.round``."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.0], np.float32)
    q, s = TO.int8_compress(_t(x), amax=torch.tensor(127.0))
    assert float(s) == 1.0 and q.tolist() == [0, 2, 2, 0, -2, 127, 3]
    jq, js = JO.int8_compress(jnp.asarray(x), jnp.asarray(127.0))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    jp, tp = _tree(rng, "f32")
    jef, tef = JO.ef_init(jp), TO.ef_init(tp)
    for i in range(3):
        jg, tg = _tree(np.random.default_rng(30 + i), "bf16")
        jq, jef = JO.ef_compress_update(jg, jef)
        tq, tef = TO.ef_compress_update(tg, tef)
        for key in ("a", "blk/w", "blk/b"):
            (a, sa), (b, sb) = _at(jq, key), _at(tq, key)
            assert b.dtype == torch.int8
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert float(sb) == float(sa)
            np.testing.assert_array_equal(
                TO.int8_decompress(b, sb).numpy(),
                np.asarray(JO.int8_decompress(a, sa)))
        for key in ("a", "blk/w", "blk/b"):
            np.testing.assert_array_equal(_at(tef.residual, key).numpy(),
                                          np.asarray(_at(jef.residual, key)))


# --------------------------------------------------------------------------
# the kernels' gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,window,chunk", [
    (1, 4, 2, 40, 40, 16, True, None, 1024),     # causal, GQA
    (2, 4, 1, 30, 50, 8, True, 12, 1024),        # S < T, windowed, G = 4
    (1, 2, 2, 37, 37, 8, False, None, 16),       # not causal, ragged chunk
    (1, 4, 2, 33, 45, 16, True, 20, 16)])        # windowed, ragged chunk
def test_flash_backward_plain_matches_jax_grad(rng, b, hq, hkv, s, t, d,
                                               causal, window, chunk):
    """``flash_attention_bwd_plain`` (from the forward's LSE) against
    ``jax.grad`` of the reference's ``chunked_attention``; the LSE
    against a direct log-sum-exp of the scaled scores."""
    q, k, v = _rand(rng, b, hq, s, d), _rand(rng, b, hkv, t, d), \
        _rand(rng, b, hkv, t, d)
    do = _rand(rng, b, hq, s, d)

    def f(q_, k_, v_):
        out = JA.chunked_attention(q_, k_, v_, causal=causal, window=window)
        return jnp.sum(out * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    o, lse = flash_attention_plain_lse(_t(q), _t(k), _t(v), causal=causal,
                                       window=window)
    got = flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, _t(do), lse,
                                    causal=causal, window=window,
                                    chunk=chunk)
    for name, g, w in zip("qkv", got, want):
        _close(g, np.asarray(w), OP_TOL, f"d{name}")
    sc = np.einsum("bkgsd,bktd->bkgst", q.reshape(b, hkv, hq // hkv, s, d),
                   k) / np.sqrt(d)
    qp = (t - s) + np.arange(s)[:, None]
    kp = np.arange(t)[None, :]
    keep = (kp <= qp) if causal else np.ones((s, t), bool)
    if window is not None:
        keep &= kp > qp - window
    sc = np.where(keep, sc, -np.inf)
    mx = sc.max(-1, keepdims=True)
    ref = (mx + np.log(np.exp(sc - mx).sum(-1, keepdims=True)))[..., 0]
    _close(lse, ref.reshape(b, hq, s), 1e-6, "lse")


def test_flash_function_gradients_match_jax_grad(rng):
    """``ops.flash_attention`` as an ``autograd.Function`` on the CPU (the
    plain pieces), windowed GQA, against ``jax.grad``."""
    b, hq, hkv, s, t, d = 1, 4, 2, 24, 24, 16
    q, k, v = _rand(rng, b, hq, s, d), _rand(rng, b, hkv, t, d), \
        _rand(rng, b, hkv, t, d)
    do = _rand(rng, b, hq, s, d)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(JA.chunked_attention(
        *a, causal=True, window=8) * do), argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=True, window=8)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    out.backward(_t(do))
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _close(g, np.asarray(w), OP_TOL, f"d{name}")


def test_ragged_function_dx_and_dw_match_jax_grad_of_einsum(rng):
    """dX through the kernel's own function on Wᵀ, dW one batched product
    over equal expert groups, against ``jax.grad`` of the einsum route."""
    e, c, d, f, tm = 3, 256, 16, 24, 128
    x, w, dy = _rand(rng, e * c, d), _rand(rng, e, d, f), \
        _rand(rng, e * c, f)
    want = jax.grad(lambda x_, w_: jnp.sum(jnp.einsum(
        "ecd,edf->ecf", x_.reshape(e, c, d), w_).reshape(e * c, f) * dy),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    te = torch.arange(e * c // tm, dtype=torch.int32) // (c // tm)
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    out = tops.ragged_gemm(tx, tw, te, n_groups=e)
    out.backward(_t(dy))
    _close(tx.grad, np.asarray(want[0]), OP_TOL, "dx")
    _close(tw.grad, np.asarray(want[1]), OP_TOL, "dw")
    # without the groups no weight gradient can be formed; dX still can
    tx2, tw2 = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    with pytest.raises(ValueError, match="equal expert groups"):
        tops.ragged_gemm(tx2, tw2, te).backward(_t(dy))
    tx3 = _t(x).requires_grad_(True)
    tops.ragged_gemm(tx3, _t(w), te).backward(_t(dy))
    _close(tx3.grad, np.asarray(want[0]), OP_TOL, "dx without groups")


@pytest.mark.parametrize("reps", [1, 2])
def test_moe_mlp_and_route_topk_gradients_match_reference(rng, reps):
    """Gradients in x, the router logits (through the gates and the aux
    loss) and the three weights, against ``jax.grad`` of the reference's
    einsum route; 2 replicas take the padded-capacity path."""
    t, e, d, f = 200, 4, 32, 48
    x, logits = _rand(rng, t, d), _rand(rng, t, e)
    wg, wu, wd = (_rand(rng, e * reps, d, f), _rand(rng, e * reps, d, f),
                  _rand(rng, e * reps, f, d))
    dout = _rand(rng, t, d)

    def jloss(x_, lg, a, b, c):
        r = JD.expand_replicas(JD.route_topk(lg, 2, capacity_factor=1.0),
                               reps)
        out = JD.moe_mlp(x_, r, a, b, c, use_kernel=False)
        return jnp.sum(out * dout) + 0.5 * r.aux_loss
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *map(jnp.asarray, (x, logits, wg, wu, wd)))
    args = [_t(a).requires_grad_(True) for a in (x, logits, wg, wu, wd)]
    r = TD.expand_replicas(TD.route_topk(args[1], 2, capacity_factor=1.0),
                           reps)
    out = TD.moe_mlp(args[0], r, *args[2:])
    (torch.sum(out * _t(dout)) + 0.5 * r.aux_loss).backward()
    for name, a, w in zip(("x", "logits", "wg", "wu", "wd"), args, want):
        _close(a.grad, np.asarray(w), OP_TOL, f"d{name}")


def test_tie_expert_replica_grads_matches_reference(rng):
    """mixtral's smoke config with 2 replicas: the tied sums, and every
    leaf outside the expert weights untouched."""
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              n_expert_replicas=2)
    jcfg = dataclasses.replace(jax_smoke_config("mixtral-8x7b"),
                               n_expert_replicas=2)
    shapes = TLM.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert shapes["layers"]["moe"]["wg"].shape[1] == 8
    g_np = tree_map(lambda a: np.random.default_rng(a.numel()).standard_normal(
        tuple(a.shape)).astype(np.float32), shapes)
    want = jax_tie(jcfg, jax.tree_util.tree_map(jnp.asarray, g_np))
    got = tie_expert_replica_grads(cfg, tree_map(_t, g_np))
    _walk_close(got, jax.tree_util.tree_map(np.asarray, want), 0.0)
    wg = got["layers"]["moe"]["wg"]
    assert torch.equal(wg[:, :4], wg[:, 4:])
    assert tie_expert_replica_grads(get_smoke_config("llama3-8b"),
                                    {"x": torch.ones(2)})["x"].sum() == 2


# --------------------------------------------------------------------------
# loss_fn, remat, the train step, the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    """``loss_fn`` (loss, xent, aux) and every parameter's gradient; a
    ``logit_chunk`` of 16 over 40 (or 80) positions leaves a remainder
    chunk."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), logit_chunk=16)
    cfg = dataclasses.replace(get_smoke_config(arch), logit_chunk=16)
    jp, tp = _jparams(jcfg)
    jb, tb = _batch(cfg, 2, 80 if cfg.window else 40, 3)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: JT.loss_fn(jcfg, p, bt), has_aux=True))(jp, jb)
    loss, metrics, grads = TTL.loss_and_grads(cfg, tp, tb)
    _close(loss, np.asarray(jl), 1e-5, "loss")
    for key in ("xent", "aux"):
        _close(metrics[key], np.asarray(jm[key]), 1e-5, key)
    _walk_close(grads, jax.tree_util.tree_map(np.asarray, jg), 1e-4,
                f"{arch} grads")
    got, _ = TLM.Model(cfg).loss(tp, tb)
    assert float(got) == float(loss)


def test_remat_policies_give_equal_gradients():
    """none, full (non-reentrant checkpoint a layer) and dots (selective:
    the 2-D products kept) recompute the same arithmetic: bitwise equal
    losses and gradients on the CPU."""
    base = get_smoke_config("phi3.5-moe-42b-a6.6b")
    params = TLM.init_params(base, torch.Generator().manual_seed(0),
                             device="cpu")
    _, tb = _batch(base, 2, 32, 1)
    runs = {}
    for remat in TT.REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat=remat)
        runs[remat] = TTL.loss_and_grads(cfg, params, tb)
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0]), remat
        for a, b in zip(tree_leaves(runs[remat][2]),
                        tree_leaves(runs["none"][2])):
            assert torch.equal(a, b), remat
    with pytest.raises(ValueError, match="remat"):
        TTL.loss_and_grads(dataclasses.replace(base, remat="offload"),
                           params, tb)


@pytest.mark.parametrize("arch,kw", [
    ("phi3.5-moe-42b-a6.6b", {}),
    ("llama3-8b", {"accum": 2}),
    ("qwen2-1.5b", {"compression": True})])
def test_train_step_matches_reference(arch, kw):
    """Three steps of ``make_train_step`` against the reference's jitted
    step from the same params and batches: the four metrics and the
    params after each step."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jstep, jopt = JTL.make_train_step(jcfg, lr=3e-3, **kw)
    step, opt = TTL.make_train_step(cfg, lr=3e-3, **kw)
    comp = kw.get("compression", False)
    jp, tp = _jparams(cfg)
    jstate = JTL.TrainState(jp, jopt.init(jp),
                            JO.ef_init(jp) if comp else None)
    state = TTL.TrainState(tp, opt.init(tp),
                           TO.ef_init(tp) if comp else None)
    jit_step = jax.jit(jstep)
    for i in range(3):
        jb, tb = _batch(cfg, 4, 32, i)
        jstate, jm = jit_step(jstate, jb)
        state, m = step(state, tb)
        assert set(m) == set(jm) == {"loss", "xent", "aux", "grad_norm"}
        for key in jm:
            _close(m[key], np.asarray(jm[key]), 1e-4, f"step {i} {key}")
        _adam_close(state.params, jstate.params, 3e-3 * 3 * (i + 1),
                    f"{arch} step {i} params")
    assert int(state.opt_state.step) == 3


def test_train_step_at_head_dim_256_matches_reference():
    """gemma's family at its head dim 256 (the card's split backward
    instance) on a narrow config: 1 layer, d_model 512, 2 / 2 heads of
    256, GeGLU d_ff 1,024, vocab 512, fp32. ``loss_fn`` and every
    gradient against ``jax.grad`` of the reference's (loss rtol 1e-5,
    gradients within 1e-4 of their largest element, as for the smoke
    configs), then one ``make_train_step`` step against the reference's
    jitted step (metrics rtol 1e-4, params as ``_adam_close`` holds
    them)."""
    narrow = dict(n_layers=1, d_model=512, n_heads=2, n_kv_heads=2,
                  d_head=256, d_ff=1024, vocab=512, logit_chunk=16)
    jcfg = dataclasses.replace(jax_smoke_config("gemma-7b"), **narrow)
    cfg = dataclasses.replace(get_smoke_config("gemma-7b"), **narrow)
    assert cfg.head_dim == 256
    jp, tp = _jparams(cfg)
    jb, tb = _batch(cfg, 2, 40, 5)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: JT.loss_fn(jcfg, p, bt), has_aux=True))(jp, jb)
    loss, metrics, grads = TTL.loss_and_grads(cfg, tp, tb)
    _close(loss, np.asarray(jl), 1e-5, "loss")
    _close(metrics["xent"], np.asarray(jm["xent"]), 1e-5, "xent")
    _walk_close(grads, jax.tree_util.tree_map(np.asarray, jg), 1e-4,
                "head dim 256 grads")
    jstep, jopt = JTL.make_train_step(jcfg, lr=3e-3)
    step, opt = TTL.make_train_step(cfg, lr=3e-3)
    jstate, jm1 = jax.jit(jstep)(JTL.TrainState(jp, jopt.init(jp), None), jb)
    state, m1 = step(TTL.TrainState(tp, opt.init(tp), None), tb)
    for key in jm1:
        _close(m1[key], np.asarray(jm1[key]), 1e-4, f"step {key}")
    _adam_close(state.params, jstate.params, 3e-3 * 3, "head dim 256 step")


def _adam_close(got: dict, want: dict, bound, what):
    """The train steps' param check (the module docstring's reasons):
    all but 0.1 % of all the params' elements within 1e-4 relative, every
    element within ``bound``."""
    off = total = 0
    for key in want:
        if isinstance(want[key], dict):
            o, n = _adam_close(got[key], want[key], bound, f"{what}/{key}")
        else:
            w = np.asarray(want[key], np.float32)
            d = np.abs(_n(got[key]) - w)
            o, n = int((d > 1e-4 * (np.abs(w).max() + np.abs(w))).sum()), \
                d.size
            assert d.max() <= bound, (what, key, d.max(), bound)
        off, total = off + o, total + n
    assert off <= 1e-3 * total, (what, off, total)
    return off, total


def test_in_place_step_equals_the_functional_update():
    """The step's in-place update (leaf by leaf, in slices) gives the
    bits of ``opt.update`` + ``apply_updates`` on the same grads."""
    cfg = get_smoke_config("mixtral-8x7b")
    step, opt = TTL.make_train_step(cfg, lr=1e-2)
    state = TTL.make_train_state(cfg, torch.Generator().manual_seed(0), opt,
                                 device="cpu")
    _, tb = _batch(cfg, 2, 16, 0)
    p0 = tree_map(torch.clone, state.params)
    s0 = opt.init(p0)
    _, _, grads = TTL.loss_and_grads(cfg, p0, tb)
    updates, s1 = opt.update(grads, s0, p0)
    want = TO.apply_updates(p0, updates)
    old = TOO._SLICE
    TOO._SLICE = 1000           # several slices a leaf
    try:
        new, metrics = step(state, tb)
    finally:
        TOO._SLICE = old
    assert new.params is state.params          # updated in place
    for a, b in zip(tree_leaves(new.params), tree_leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(new.opt_state.mu), tree_leaves(s1.mu)):
        assert torch.equal(a, b)
    assert float(metrics["grad_norm"]) == float(TO.global_norm(grads))


def test_launcher_lm_smoke_on_cpu(capsys):
    """The acceptance command: 20 steps of phi3.5-moe's smoke config on
    the CPU, the reference's step lines, the loss decreased."""
    rc = launch_train.main(["--mode", "lm", "--arch",
                            "phi3.5-moe-42b-a6.6b", "--smoke", "--steps",
                            "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "step     0 loss" in out and "loss decreased: OK" in out


_REFUSED = {"--grad-compression": "ROADMAP.md queue 1, item 5b.5",
            "--grad-sync": "--grad-sync shardmap with --mesh-model > 1",
            "--resume": "ROADMAP.md queue 1, item 5b.4"}


@pytest.mark.parametrize("flag", [
    ["--mesh-model", "2", "--grad-compression", "int8"],
    ["--mesh-model", "2", "--grad-sync", "shardmap"],
    ["--mesh-data", "2", "--grad-sync", "shardmap", "--resume",
     "--ckpt-dir", "unused"]])
def test_launcher_refuses_unported_flags(capsys, flag):
    """What is not ported exits 2 before anything is built: int8 error
    feedback over a model axis, the explicit data-parallel step over one
    (it replicates the params), a resume over several ranks."""
    rc = launch_train.main(["--mode", "lm", "--arch", "llama3-8b", "--smoke",
                            "--device", "cpu", *flag])
    assert rc == 2
    why = _REFUSED[next(f for f in reversed(flag[:-1]) if f in _REFUSED)
                   if "--resume" not in flag else "--resume"]
    assert why in capsys.readouterr().err


def test_launcher_checkpoints_restarts_and_resumes_on_cpu(capsys, tmp_path):
    """``--inject-fault 7`` fails step 7 once, before it runs: the
    resilient loop saves the last good state as an emergency checkpoint,
    restores it and finishes the 20 steps with a lower loss; ``--resume``
    then goes on from the newest step. lr 3e-3: on the smoke config's
    random tokens, 20 steps at the default 3e-4 move the loss less than
    one batch's noise."""
    d = str(tmp_path / "ckpt")
    common = ["--mode", "lm", "--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
              "--device", "cpu", "--lr", "3e-3", "--ckpt-dir", d,
              "--ckpt-every", "5"]
    rc = launch_train.main([*common, "--steps", "20", "--inject-fault", "7"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "restarts=1 emergency_saves=1 last step 20" in out, out
    assert "loss decreased: OK" in out
    from repro_torch.ckpt import checkpoint_extra, latest_step
    assert latest_step(d) == 20 and checkpoint_extra(d, 20) == {}
    rc = launch_train.main([*common, "--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "resumed from step 20" in out and "last step 23" in out, out
    assert "step    20 loss" in out


def test_train_entry_points_default_to_cuda_and_refuse_data_parallel():
    """The entry points default to the card; the data-parallel step
    refuses to run without the mesh its axis belongs to."""
    for fn in (TTL.make_train_state, TT.Model.init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(ValueError, match="mesh"):
        TTL.make_train_step(cfg, sync_axis="data")
    with pytest.raises(ValueError, match="mesh"):
        TTL.make_data_parallel_step(cfg, None)
    if not torch.cuda.is_available():
        _, opt = TTL.make_train_step(cfg)
        with pytest.raises((RuntimeError, AssertionError)):
            TTL.make_train_state(cfg, torch.Generator().manual_seed(0), opt)
