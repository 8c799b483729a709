"""The port's LM serving slice against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through ``repro`` and
``repro_torch``: the plain versions of the two LM kernels against the
Pallas kernels in interpret mode and the reference's XLA routes, the
attention paths, MoE routing (bitwise), dispatch / combine and
``moe_mlp``, norms, RoPE and the GLU, and ``prefill`` + 4 ``decode_step``
calls (logits and every cache field) for five smoke configs, from the
reference's params handed over by ``params_from_jax``.

Tolerances, all fp32: single ops (a matmul, an attention) atol / rtol
1e-5 — the same sums in another order (~1e-7 relative per term) over at
most a few hundred terms of magnitude ~1; the integer routing fields
bitwise; whole prefill / decode runs rtol 1e-4 with atol 1e-4 x the
largest reference value of that field — the expert weights' fan-in
rule (std 1 / sqrt(E)) drives the residual stream to magnitudes of ~10^2
to 10^3, where one fp32 ulp is ~1e-5 to 1e-4."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm.transformer as JT
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import dispatch as JD
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ragged_gemm import ragged_gemm_pallas
from repro.models.lm import attention as JA
from repro.models.lm import layers as JL

from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch as TD
from repro_torch.data import synthetic_lm_batch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ragged_gemm import ragged_gemm_plain
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import lm as TLM
from repro_torch.models.lm import attention as TA
from repro_torch.models.lm import layers as TL
from repro_torch.models.lm import transformer as TT
from repro_torch.train.lm import make_decode_step, make_prefill_step

OP_TOL = dict(atol=1e-5, rtol=1e-5)
SERVE_ARCHS = ("phi3.5-moe-42b-a6.6b", "mixtral-8x7b", "llama3-8b",
               "qwen2-1.5b", "gemma-7b")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _n(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else a)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# ragged_gemm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("e,t,dm,f,tiles", [
    (4, 512, 128, 256, (3, 0, 3, 1)),        # non-monotone, one unused
    (2, 256, 256, 128, (1, 0)),
    (3, 384, 64, 96, (2, 2, 0))])
def test_ragged_gemm_plain_matches_pallas(rng, e, t, dm, f, tiles):
    x, w = _rand(rng, t, dm), _rand(rng, e, dm, f)
    te = np.asarray(tiles, np.int32)
    want = ragged_gemm_pallas(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(te), tm=128, tn=f if f < 256
                              else 256, interpret=True)
    got = ragged_gemm_plain(_t(x), _t(w), _t(te), tm=128)
    np.testing.assert_allclose(_n(got), np.asarray(want), **OP_TOL)
    tops.reset_kernel_launches()
    via_ops = tops.ragged_gemm(_t(x), _t(w), _t(te), tm=128)
    assert torch.equal(via_ops, got)
    assert not any(tops.kernel_launches().values())


def test_ragged_gemm_never_pads(rng):
    x, w = _t(_rand(rng, 200, 16)), _t(_rand(rng, 2, 16, 8))
    with pytest.raises(ValueError, match="not a multiple of tm"):
        tops.ragged_gemm(x, w, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="one expert per 128-row tile"):
        tops.ragged_gemm(x[:128], w, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no ragged GEMM implementation"):
        tops.ragged_gemm(x[:128].to("meta"), w.to("meta"),
                         torch.zeros(1, dtype=torch.int32, device="meta"))


# --------------------------------------------------------------------------
# flash attention (the reference's chunked and banded routes), decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None), (False, 96)])
def test_flash_plain_matches_pallas_and_chunked(hq, hkv, causal, window):
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, t, d = 2, 128, 256, 32                  # S < T: end-aligned
    q, k, v = _rand(rng, b, hq, s, d), _rand(rng, b, hkv, t, d), \
        _rand(rng, b, hkv, t, d)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, bq=128, bk=128,
                                    interpret=True)
    chunked = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                window=window)
    np.testing.assert_allclose(_n(got), np.asarray(pallas), **OP_TOL)
    np.testing.assert_allclose(_n(got), np.asarray(chunked), **OP_TOL)
    oracle = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(_n(got), _n(oracle), **OP_TOL)
    via_ops = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                   window=window)
    assert torch.equal(via_ops, got)


def test_chunked_attention_ragged_last_chunk(rng):
    """T not a multiple of the chunk: the reference pads and masks, the
    port takes a short last chunk."""
    q, k, v = _rand(rng, 1, 4, 50, 32), _rand(rng, 1, 2, 300, 32), \
        _rand(rng, 1, 2, 300, 32)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=77, chunk=128)
    got = TA.chunked_attention(_t(q), _t(k), _t(v), window=77, chunk=128)
    np.testing.assert_allclose(_n(got), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("s,w", [(256, 64), (300, 96), (32, 64)])
def test_windowed_flash_matches_reference_banded(rng, s, w):
    """The prefill block's sliding-window layers: the reference calls
    ``banded_attention``, the port ``ops.flash_attention`` with the
    window (the same masked softmax)."""
    q, k, v = _rand(rng, 2, 4, s, 32), _rand(rng, 2, 2, s, 32), \
        _rand(rng, 2, 2, s, 32)
    want = JA.banded_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), window=w, chunk=64)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=w)
    np.testing.assert_allclose(_n(got), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("window", [1 << 30, 5, 1])
def test_decode_attention_matches_reference(rng, window):
    b, hq, hkv, c, d = 3, 4, 2, 12, 32
    q, k, v = _rand(rng, b, hq, 1, d), _rand(rng, b, hkv, c, d), \
        _rand(rng, b, hkv, c, d)
    slot_pos = rng.integers(-1, 20, (b, c)).astype(np.int32)
    pos = np.asarray([9, 15, 19], np.int32)
    want = JA.decode_attention(
        jnp.asarray(q), JA.KVSlice(jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(slot_pos)),
        jnp.asarray(pos), window=window)
    got = TA.decode_attention(_t(q), TA.KVSlice(_t(k), _t(v), _t(slot_pos)),
                              _t(pos), window=window)
    np.testing.assert_allclose(_n(got), np.asarray(want), **OP_TOL)


# --------------------------------------------------------------------------
# MoE routing, dispatch / combine, moe_mlp
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,e,k,cf,reps", [(64, 4, 2, 1.25, 1),
                                           (300, 8, 2, 1.0, 1),
                                           (500, 4, 1, 0.5, 1),
                                           (96, 4, 2, 1.25, 2)])
def test_route_topk_matches_reference_bitwise(rng, t, e, k, cf, reps):
    logits = _rand(rng, t, e)
    jr = JD.expand_replicas(JD.route_topk(jnp.asarray(logits), k,
                                          capacity_factor=cf), reps)
    tr = TD.expand_replicas(TD.route_topk(_t(logits), k, capacity_factor=cf),
                            reps)
    assert (tr.capacity, tr.num_experts) == (jr.capacity, jr.num_experts)
    for name in ("expert_idx", "pos", "keep"):
        np.testing.assert_array_equal(_n(getattr(tr, name)),
                                      np.asarray(getattr(jr, name)), name)
    np.testing.assert_allclose(_n(tr.gates), np.asarray(jr.gates), **OP_TOL)
    np.testing.assert_allclose(float(tr.aux_loss), float(jr.aux_loss),
                               rtol=1e-6)
    if cf < 1:
        assert not _n(tr.keep).all()          # drops exercised


@pytest.mark.parametrize("ref_kernel", [True, False])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_dispatch_combine_and_moe_mlp(rng, ref_kernel, act):
    """The port's one route (``ops.ragged_gemm``) against both of the
    reference's: its kernel route and its einsum route."""
    t, e, d, f = 200, 4, 32, 48
    logits, x = _rand(rng, t, e), _rand(rng, t, d)
    wg, wu, wd = _rand(rng, e, d, f), _rand(rng, e, d, f), _rand(rng, e, f, d)
    jr = JD.route_topk(jnp.asarray(logits), 2, capacity_factor=0.75)
    tr = TD.route_topk(_t(logits), 2, capacity_factor=0.75)
    buf = TD.dispatch(_t(x), tr)
    np.testing.assert_array_equal(_n(buf), np.asarray(
        JD.dispatch(jnp.asarray(x), jr)))
    np.testing.assert_allclose(
        _n(TD.combine(buf[..., :24], tr)),
        np.asarray(JD.combine(JD.dispatch(jnp.asarray(x), jr)[..., :24], jr)),
        **OP_TOL)
    jact = jax.nn.silu if act == "silu" else jax.nn.gelu
    tact = TL.act_fn(type("C", (), {"act": act})())
    want = JD.moe_mlp(jnp.asarray(x), jr, *map(jnp.asarray, (wg, wu, wd)),
                      act=jact, use_kernel=ref_kernel)
    got = TD.moe_mlp(_t(x), tr, _t(wg), _t(wu), _t(wd), act=tact)
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_dispatch_is_literal_spmm(rng):
    t, e, d = 40, 4, 8
    r = TD.route_topk(_t(_rand(rng, t, e)), 2, capacity_factor=1.0, tm=8)
    x = _t(_rand(rng, t, d))
    p, pt = TD.as_coo_matrices(r, t)
    dense = torch.zeros((p.nrows, t))
    dense[p.row.long(), p.col.long()] = p.val
    np.testing.assert_allclose(_n(dense @ x),
                               _n(TD.dispatch(x, r).reshape(-1, d)), **OP_TOL)
    assert (pt.nrows, pt.ncols) == (t, e * r.capacity)


def test_replica_capacity_fault_raises_like_the_reference(rng):
    """``expand_replicas`` rounds the per-replica capacity to 8, not to tm:
    T = 2048, E = 8, 2 replicas gives capacity 320, which no 128-row tile
    divides. The port pads each expert's rows to 384 with zero rows that
    are never kept nor combined, so its ``moe_mlp`` equals the
    reference's einsum route (the route its model path takes), drop set
    included: expert 0's logits are raised so that it overflows."""
    t, e, d, f = 2048, 8, 8, 8
    logits, x = _rand(rng, t, e), _rand(rng, t, d)
    logits[:, 0] += 1.5
    wg, wu = _rand(rng, 2 * e, d, f), _rand(rng, 2 * e, d, f)
    wd = _rand(rng, 2 * e, f, d)
    jr = JD.expand_replicas(JD.route_topk(jnp.asarray(logits), 2), 2)
    tr = TD.expand_replicas(TD.route_topk(_t(logits), 2), 2)
    assert tr.capacity == jr.capacity == 320
    np.testing.assert_array_equal(_n(tr.keep), np.asarray(jr.keep))
    assert not bool(tr.keep.all())             # the drop set is not empty
    want = JD.moe_mlp(jnp.asarray(x), jr, *map(jnp.asarray, (wg, wu, wd)),
                      use_kernel=False)
    got = TD.moe_mlp(_t(x), tr, _t(wg), _t(wu), _t(wd))
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_mixtral_published_replicas_cannot_decode():
    """mixtral-8x7b's published routing (8 experts, top-2, 2 replicas)
    at decode: any batch up to 409 tokens gets capacity 128, 64 a
    replica, which no 128-row tile divides. The port pads the replica
    slots to whole tiles, and ``decode_step`` matches the reference's
    (which takes its einsum route) at batches 1, 4 and 409: logits and
    every cache field, from the reference's params."""
    from repro.configs import get_config as jax_get_config
    full = jax_get_config("mixtral-8x7b")
    routing = dict(n_experts=full.n_experts, top_k=full.top_k,
                   n_expert_replicas=full.n_expert_replicas,
                   capacity_factor=full.capacity_factor)
    assert full.n_expert_replicas == 2
    jcfg = dataclasses.replace(jax_smoke_config("mixtral-8x7b"), **routing)
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), **routing)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(2))
    params = TLM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    jdec = jax.jit(lambda p, c, t: JT.decode_step(jcfg, p, c, t))
    for b in (1, 4, 409):
        toks = np.random.default_rng(b).integers(
            0, cfg.vocab, (b, 1)).astype(np.int32)
        jlogits, jcache = jdec(jparams, JT.init_cache(jcfg, b, 8),
                               jnp.asarray(toks))
        logits, cache = TLM.decode_step(
            cfg, params, TLM.init_cache(cfg, b, 8, device="cpu"),
            torch.from_numpy(toks))
        _close(logits, jlogits, f"mixtral 2 replicas, batch {b}, logits")
        assert set(cache) == set(jcache)
        for key in jcache:
            _close(cache[key], jcache[key],
                   f"mixtral 2 replicas, batch {b}, cache[{key}]")


# --------------------------------------------------------------------------
# norms, RoPE, GLU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_norms_rope_and_glu(rng, theta):
    x = _rand(rng, 2, 7, 64) * 3 + 1
    scale, bias = _rand(rng, 64), _rand(rng, 64)
    np.testing.assert_allclose(
        _n(TL.rmsnorm(_t(x), _t(scale))),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), **OP_TOL)
    np.testing.assert_allclose(
        _n(TL.layernorm(_t(x), _t(scale), _t(bias))),
        np.asarray(JL.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias))), **OP_TOL)
    # positions up to 64 within OP_TOL; far positions within the angle's
    # own fp32 resolution: XLA's and torch's exp may round a frequency 1
    # ulp apart, and at position P that moves the angle by up to P * 2^-22
    # rad, so each output by up to 2 max|x| P 2^-22
    xh = _rand(rng, 2, 7, 4, 32)
    for pos, atol in (([0, 1, 2, 3, 17, 40, 64], OP_TOL["atol"]),
                      ([0, 1, 500, 1000, 2047, 3000, 4095],
                       2 * float(np.abs(xh).max()) * 4095 * 2.0 ** -22)):
        pos = np.asarray([pos] * 2, np.int32)
        np.testing.assert_allclose(
            _n(TL.rope(_t(xh), _t(pos), theta)),
            np.asarray(JL.rope(jnp.asarray(xh), jnp.asarray(pos), theta)),
            atol=atol, rtol=OP_TOL["rtol"])
    for arch in ("llama3-8b", "gemma-7b"):           # silu, gelu (tanh)
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
        p = {n: _rand(rng, *s) for n, s in
             (("wg", (128, 256)), ("wu", (128, 256)), ("wd", (256, 128)))}
        xm = _rand(rng, 2, 5, 128)
        want = JL.glu_mlp(jcfg, {n: jnp.asarray(a) for n, a in p.items()},
                          jnp.asarray(xm))
        got = TL.glu_mlp(tcfg, {n: _t(a) for n, a in p.items()}, _t(xm))
        np.testing.assert_allclose(_n(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


# --------------------------------------------------------------------------
# prefill + decode, whole models
# --------------------------------------------------------------------------

def _close(got, want, what):
    want = np.asarray(want)
    got = _n(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, what)
    else:
        np.testing.assert_allclose(
            got, want, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(want).max()), 1e-30), err_msg=what)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    assert jcfg.__dict__ == cfg.__dict__
    # mixtral (window 64): an 80-token prompt, and a buffer of 82 slots
    # that the decode steps wrap around
    b, s, cap = (2, 80, 82) if cfg.window else (2, 24, 32)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = TLM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    toks, _ = synthetic_lm_batch(b, s, cfg.vocab, step=3)
    jcache, jlogits = jax.jit(lambda p, bt: JT.prefill(jcfg, p, bt, cap))(
        jparams, {"tokens": jnp.asarray(toks)})
    cache, logits = make_prefill_step(cfg, cap)(
        params, {"tokens": torch.from_numpy(toks)})
    _close(logits, jlogits, f"{arch} prefill logits")
    assert set(cache) == set(jcache)
    for key in jcache:
        _close(cache[key], jcache[key], f"{arch} prefill cache[{key}]")
    jdec = jax.jit(lambda p, c, t: JT.decode_step(jcfg, p, c, t))
    dec = make_decode_step(cfg)
    nxt = np.random.default_rng(7).integers(0, cfg.vocab, (b, 4)
                                            ).astype(np.int32)
    for i in range(4):
        jlogits, jcache = jdec(jparams, jcache, jnp.asarray(nxt[:, i:i + 1]))
        logits, cache = dec(params, cache, torch.from_numpy(nxt[:, i:i + 1]))
        _close(logits, jlogits, f"{arch} decode {i} logits")
        for key in jcache:
            _close(cache[key], jcache[key], f"{arch} decode {i} cache[{key}]")
    if cfg.window:     # the buffer wrapped: slot 0 now holds position 82
        assert int(cache["slot_pos"][0, 0]) == s + 2


def test_decode_step_writes_the_callers_cache_in_place():
    """The stated contract: ``decode_step`` writes the new token's K/V
    into the cache it is given, and the returned cache holds those same
    tensors; ``pos`` and ``slot_pos`` come back as new tensors."""
    cfg = get_smoke_config("llama3-8b")
    params = TLM.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks, _ = synthetic_lm_batch(2, 6, cfg.vocab)
    cache, _ = TLM.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                           8)
    k_before = cache["k"].clone()
    pos, slot_pos = cache["pos"].clone(), cache["slot_pos"].clone()
    _, new = TLM.Model(cfg).decode(params, cache,
                                   torch.ones((2, 1), dtype=torch.int32))
    assert new["k"] is cache["k"] and new["v"] is cache["v"]
    assert not torch.equal(cache["k"][:, :, :, 6], k_before[:, :, :, 6])
    assert torch.equal(cache["k"][:, :, :, :6], k_before[:, :, :, :6])
    assert torch.equal(cache["pos"], pos)
    assert torch.equal(cache["slot_pos"], slot_pos)
    assert torch.equal(new["pos"], pos + 1)
    assert int(new["slot_pos"][0, 6]) == 6


def test_forward_hidden_matches_reference():
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(1))
    params = TLM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    toks, _ = synthetic_lm_batch(2, 40, cfg.vocab)
    jh, jaux = jax.jit(lambda p, t: JT.forward_hidden(jcfg, p, {"tokens": t})
                       )(jparams, jnp.asarray(toks))
    h, aux = TLM.forward_hidden(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(h, jh, "hidden")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_tokens_and_configs_equal_the_reference():
    from repro.configs import arch_names as jax_arch_names
    from repro.data.tokens import synthetic_lm_batch as jax_batch
    from repro_torch.configs import arch_names, get_config
    from repro.configs import get_config as jax_get_config
    assert arch_names() == jax_arch_names()
    for arch in arch_names():
        assert get_config(arch).__dict__ == jax_get_config(arch).__dict__
        assert get_smoke_config(arch).__dict__ == \
            jax_smoke_config(arch).__dict__
    for got, want in zip(synthetic_lm_batch(3, 17, 500, step=2, host=1),
                         jax_batch(3, 17, 500, step=2, host=1)):
        np.testing.assert_array_equal(got, want)


def test_params_from_jax_keeps_bf16_and_structure():
    cfg = jax_smoke_config("qwen2-1.5b")
    jparams = JT.init_params(type(cfg)(**{**cfg.__dict__,
                                         "dtype": "bfloat16"}),
                             jax.random.PRNGKey(0))
    params = TLM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    wq = params["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 128, 128)
    np.testing.assert_array_equal(
        wq.float().numpy(),
        np.asarray(jparams["layers"]["attn"]["wq"]).astype(np.float32))
    assert params["layers"]["ln1"]["scale"].dtype == torch.float32


def test_init_params_shapes_and_init_rule():
    """The port's own init: the reference's shapes, dtypes and fan-in
    rule (an expert weight's std is 1 / sqrt(E))."""
    arch = "phi3.5-moe-42b-a6.6b"
    params = TLM.Model(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda: JT.init_params(jax_smoke_config(arch),
                                                   jax.random.PRNGKey(0)))
    for path, spec in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == spec.shape, path
        assert str(node.dtype).endswith(str(spec.dtype)), path
    wg = params["layers"]["moe"]["wg"]
    assert abs(float(wg.std()) - 0.5 * 0.88) < 0.02   # trunc(±2) std 0.88


def test_entry_points_default_to_cuda():
    for fn in (TLM.init_params, TLM.init_cache, TLM.params_from_jax,
               TL.truncated_normal_init, TL.init_norm, TL.init_dense,
               TL.init_glu_mlp, TT.Model.init):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        cfg = get_smoke_config("llama3-8b")
        with pytest.raises((RuntimeError, AssertionError)):
            TLM.init_cache(cfg, 1, 8)             # no silent CPU fallback
