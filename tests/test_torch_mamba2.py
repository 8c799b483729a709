"""The port's Mamba2 SSD mixer (``repro_torch.models.lm.mamba2``) against
the JAX reference (``repro.models.lm.mamba2``), on the CPU.

The same inputs, made with numpy from a seed, go through both packages:
``ssd_reference``, ``ssd_chunked`` (a ragged tail, an ``init_state``),
``_segsum``, ``_causal_conv``, ``mamba2_forward`` (with and without
``init_state`` and ``return_state``) and ``mamba2_decode``, with the
mixer params of the reference's ``init_mamba2`` (the dt / A / D leaves
set away from their init values so that every term takes part). Within
the port, ``ssd_chunked`` equals ``ssd_reference`` and a chunked
forward equals the same tokens decoded one at a time.

Tolerances, fp32: single ops (a conv, a segment sum, one recurrence
step) rtol / atol 1e-5 x the largest reference value, the same sums in
another order over a few terms of magnitude ~1; the SSD over a sequence,
the whole mixer and the chunked form against the recurrence 1e-4 x the
largest reference value (the state carries sums over S tokens: a
sequence of S fp32 roundings, ~S 6e-8, and the chunked form takes its
exponentials of differences of cumulative sums, whose rounding grows
with the chunk's sum). The bf16 mixer: 2^-6 x the largest reference
value (two bf16 roundings of the output and of the conv's activations,
each 2^-8 relative, through the output projection).
"""
from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.lm import mamba2 as JM

from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import mamba2 as TM
from repro_torch.models.lm.transformer import params_from_jax

OP = 1e-5
SEQ = 1e-4
BF16 = 2.0 ** -6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _n(a):
    return np.asarray(a.detach().float().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a, np.float32), np.float32)


def _close(got, want, rel, what=""):
    got, want = _n(got), _n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=what)


def _ssd_inputs(rng, b, s, h, p, n, with_state):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.2, 2.0, (h,)).astype(np.float32)
    bi = rng.standard_normal((b, s, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_state else None
    return x, dt, a, bi, ci, st


def _mixer(arch="mamba2-1.3b", dtype="float32", seed=0):
    """(jax cfg, port cfg, jax mixer params, port mixer params): the
    reference's init with dt_bias, A_log, D and the gated norm's scale
    drawn away from their constant init."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = JM.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    h, di = cfg.n_ssm_heads, cfg.d_inner
    jp = dict(jp, dt_bias=jnp.asarray(rng.uniform(-2, 0.5, h), jnp.float32),
              A_log=jnp.asarray(rng.uniform(-1, 1, h), jnp.float32),
              D=jnp.asarray(rng.uniform(0.5, 1.5, h), jnp.float32),
              norm_scale=jnp.asarray(rng.uniform(0.5, 1.5, di), jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(cfg.conv_dim) * 0.1,
                                 jcfg.dtype))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jcfg, cfg, jp, tp


# --------------------------------------------------------------------------
# the SSD core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", [(2, 24, 3, 8, 4), (1, 7, 2, 16, 8)])
def test_ssd_reference_matches_reference(b, s, h, p, n, with_state):
    rng = np.random.default_rng(s + h + with_state)
    x, dt, a, bi, ci, st = _ssd_inputs(rng, b, s, h, p, n, with_state)
    jy, jst = JM.ssd_reference(*map(jnp.asarray, (x, dt, a, bi, ci)),
                               init_state=None if st is None
                               else jnp.asarray(st))
    ty, tst = TM.ssd_reference(*map(_t, (x, dt, a, bi, ci)),
                               init_state=None if st is None else _t(st))
    _close(ty, jy, SEQ, "y")
    _close(tst, jst, SEQ, "final state")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 8, 4, 16),      # whole chunks
    (2, 50, 3, 8, 4, 16),      # a ragged tail: dt = 0 padding
    (1, 37, 2, 16, 8, 64),     # one short chunk (Q = S)
    (1, 300, 4, 8, 16, 128)])  # three chunks, the last ragged
def test_ssd_chunked_matches_reference_and_recurrence(b, s, h, p, n, chunk,
                                                      with_state):
    rng = np.random.default_rng(s * 7 + chunk + with_state)
    x, dt, a, bi, ci, st = _ssd_inputs(rng, b, s, h, p, n, with_state)
    init = None if st is None else jnp.asarray(st)
    jy, jst = jax.jit(lambda *a_: JM.ssd_chunked(
        *a_[:5], chunk=chunk, init_state=a_[5]))(
        *map(jnp.asarray, (x, dt, a, bi, ci)), init)
    args = tuple(map(_t, (x, dt, a, bi, ci)))
    tinit = None if st is None else _t(st)
    ty, tst = TM.ssd_chunked(*args, chunk=chunk, init_state=tinit)
    _close(ty, jy, SEQ, "chunked y against the reference's")
    _close(tst, jst, SEQ, "chunked final state against the reference's")
    ry, rst = TM.ssd_reference(*args, init_state=tinit)
    _close(ty, ry, SEQ, "chunked against the port's recurrence")
    _close(tst, rst, SEQ, "chunked final state against the recurrence")


def test_segsum_matches_reference(rng):
    a = (-rng.uniform(0, 1, (2, 3, 16))).astype(np.float32)
    want = np.asarray(JM._segsum(jnp.asarray(a)))
    got = _n(TM._segsum(_t(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=OP, atol=OP)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("s,width", [(10, 4), (3, 4), (9, 2)])
def test_causal_conv_matches_reference(rng, s, width, dtype):
    x = rng.standard_normal((2, s, 12)).astype(np.float32)
    w = rng.standard_normal((width, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = JM._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                           jnp.asarray(b, jdt))
    got = TM._causal_conv(_t(x).to(tdt), _t(w).to(tdt), _t(b).to(tdt))
    assert got.dtype == tdt
    # bf16: the fp32 sums in another order may round to neighbouring bf16
    _close(got, np.asarray(want, np.float32),
           OP if dtype == np.float32 else 2.0 ** -7)


# --------------------------------------------------------------------------
# the whole mixer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
@pytest.mark.parametrize("s", [40, 23])
def test_mamba2_forward_matches_reference(arch, s):
    jcfg, cfg, jp, tp = _mixer(arch)
    u = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    fwd = jax.jit(lambda p_, u_: JM.mamba2_forward(jcfg, p_, u_))
    fwd_state = jax.jit(lambda p_, u_, st=None: JM.mamba2_forward(
        jcfg, p_, u_, init_state=st, return_state=True))
    want = fwd(jp, jnp.asarray(u))
    got = TM.mamba2_forward(cfg, tp, _t(u))
    _close(got, want, SEQ, f"{arch} mixer output")
    # with the final state, then the next tokens from it
    jo, js = fwd_state(jp, jnp.asarray(u))
    to, ts = TM.mamba2_forward(cfg, tp, _t(u), return_state=True)
    assert torch.equal(to, got)
    _close(ts.state, js.state, SEQ, "final SSM state")
    _close(ts.conv_buf, js.conv_buf, OP, "conv tail")
    u2 = np.random.default_rng(s + 1).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    jo2, js2 = fwd_state(jp, jnp.asarray(u2), js)
    to2, ts2 = TM.mamba2_forward(cfg, tp, _t(u2), init_state=ts,
                                 return_state=True)
    _close(to2, jo2, SEQ, "output from an init_state")
    _close(ts2.state, js2.state, SEQ, "state from an init_state")
    _close(ts2.conv_buf, js2.conv_buf, OP, "conv tail from an init_state")
    # the port's chunked forward over both pieces at once
    whole = TM.mamba2_forward(cfg, tp, torch.cat([_t(u), _t(u2)], 1))
    _close(whole[:, s:], to2, SEQ, "a forward split at an init_state")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_mamba2_decode_matches_reference_and_forward(arch):
    """Four one-token steps against the reference's, from a prefilled
    state; and the port's decode steps against its chunked forward over
    the same tokens."""
    jcfg, cfg, jp, tp = _mixer(arch, seed=1)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    nxt = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    _, js = jax.jit(lambda p_, u_: JM.mamba2_forward(
        jcfg, p_, u_, return_state=True))(jp, jnp.asarray(u))
    _, ts = TM.mamba2_forward(cfg, tp, _t(u), return_state=True)
    dec = jax.jit(lambda p_, u_, st: JM.mamba2_decode(jcfg, p_, u_, st))
    outs = []
    for i in range(4):
        jo, js = dec(jp, jnp.asarray(nxt[:, i:i + 1]), js)
        to, ts = TM.mamba2_decode(cfg, tp, _t(nxt[:, i:i + 1]), ts)
        _close(to, jo, SEQ, f"decode {i} output")
        _close(ts.state, js.state, SEQ, f"decode {i} state")
        _close(ts.conv_buf, js.conv_buf, OP, f"decode {i} conv tail")
        outs.append(to)
    whole = TM.mamba2_forward(cfg, tp, torch.cat([_t(u), _t(nxt)], 1))
    _close(torch.cat(outs, 1), whole[:, 20:], SEQ,
           "decode steps against the chunked forward")


def test_mamba2_forward_bf16_matches_reference():
    """The bf16 mixer (the config's dtype on the card) with the
    reference's dtype flow: projections in bf16, the SSD in fp32, the
    output cast back before out_proj."""
    jcfg, cfg, jp, tp = _mixer("hymba-1.5b", dtype="bfloat16", seed=2)
    assert tp["in_proj"].dtype == torch.bfloat16
    assert tp["A_log"].dtype == torch.float32
    u = np.random.default_rng(5).standard_normal(
        (2, 33, cfg.d_model)).astype(np.float32)
    want, js = jax.jit(lambda p_, u_: JM.mamba2_forward(
        jcfg, p_, u_, return_state=True))(jp, jnp.asarray(u, jnp.bfloat16))
    got, ts = TM.mamba2_forward(cfg, tp, _t(u).bfloat16(), return_state=True)
    assert got.dtype == torch.bfloat16 and ts.conv_buf.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16, "bf16 mixer output")
    _close(ts.state, js.state, BF16, "bf16 mixer state")


def test_init_mamba2_shapes_dtypes_and_init_rule():
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke_config("mamba2-1.3b"),
                               dtype="bfloat16")
    assert inspect.signature(TM.init_mamba2).parameters[
        "device"].default == "cuda"
    p = TM.init_mamba2(torch.Generator().manual_seed(0), cfg, device="cpu")
    spec = jax.eval_shape(lambda: JM.init_mamba2(jax.random.PRNGKey(0),
                                                 jcfg))
    assert set(p) == set(spec)
    for key, val in spec.items():
        assert tuple(p[key].shape) == val.shape, key
        assert str(p[key].dtype).endswith(str(val.dtype)), key
    assert torch.equal(p["A_log"], torch.zeros(cfg.n_ssm_heads))
    assert torch.equal(p["D"], torch.ones(cfg.n_ssm_heads))
    std = float(p["in_proj"].float().std())
    assert abs(std - 0.88 / cfg.d_model ** 0.5) < 0.01   # trunc(±2) 0.88
