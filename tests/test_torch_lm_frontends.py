"""The audio (hubert) and vlm (internvl2) front ends and the flash
kernels' non-causal path and head dim 80, on the CPU, against the JAX
reference.

The same inputs, made with numpy from a seed, go through ``repro`` and
``repro_torch``:

- attention at hubert's head dim 80 without the causal mask (and GQA at
  D 32): the port's plain forward against the reference's
  ``flash_attention_pallas(..., causal=False, interpret=True)`` and
  ``chunked_attention``, the plain backward and ``ops.flash_attention``'s
  autograd Function against ``jax.grad`` of ``chunked_attention``; the
  bf16 D 80 forward at its true width emulated in PyTorch (the 16-column
  atoms of shared memory, the two warpgroups' turn schedule, the
  non-causal tile walk) against the plain version and the Pallas kernel
  in interpret mode, and the turn schedule's barriers under random
  interleavings; the head-dim routing (80 built in bf16 only);
- ``hubert-smoke`` (frames, non-causal) and ``internvl2-smoke`` (an image
  prefix of 16 positions, GQA) from the reference's params
  (``params_from_jax``): ``forward_hidden``, ``loss_fn`` (the prefix's
  positions skipped) and every gradient, ``prefill``'s cache fields and
  last logits, and for internvl2 2 ``decode_step`` calls, against the
  reference; internvl2's prefill + 2 decode steps against a longer
  ``forward_hidden`` of the port; two ``make_train_step`` steps against
  the reference's jitted step; a bf16 hubert forward;
- ``train/lm.shaped_batch`` against the reference's keys, shapes and
  dtypes for every config.

Tolerances (fp32 unless said), as the other LM parity files state them:
single attention calls and their gradients 1e-5 x the largest reference
value (the same sums in another order over at most a few hundred terms
of magnitude ~1); whole models: hidden states, prefill / decode fields
rtol 1e-4 with atol 1e-4 x the field's largest reference value, the
loss rtol 1e-5, each gradient within 1e-4 of its largest reference
element, train-step metrics rtol 1e-4 and params as ``_adam_close``
states (``tests/test_torch_lm_train.py``); a prefill + decode against a
longer forward 1e-4 x the largest logit. The bf16 hubert forward within
2^-4 x the largest reference value: bf16 roundings of every activation
through two layers (each 2^-8 relative) in both packages, which round at
different points.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm.transformer as JT
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.lm import attention as JA
from repro.train import lm as JTL

from repro_torch.configs import arch_names, get_config, get_smoke_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, flash_attention_bwd_plain,
    flash_attention_plain, flash_attention_plain_lse, flash_bwd_instance,
    flash_fwd_turns, flash_kv_walk)
from repro_torch.models import lm as TLM
from repro_torch.models.lm import transformer as TT
from repro_torch.optim.optimizer import tree_map
from repro_torch.train import lm as TTL

ARCHS = ("hubert-xlarge", "internvl2-2b")
OP = 1e-5
LOG2E = 1.4426950408889634


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
    return np.asarray(a.detach().float().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a, np.float32), np.float32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rel, what=""):
    got, want = _n(got), _n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=what)


def _field_close(got, want, what):
    """A prefill / decode field: ints bitwise, floats rtol 1e-4 with atol
    1e-4 x the field's largest reference value."""
    want = np.asarray(want)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(_n(got).astype(want.dtype), want, what)
    else:
        _close(got, want, 1e-4, what)


# --------------------------------------------------------------------------
# attention without the causal mask, head dim 80
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,s,t,d", [
    (1, 4, 4, 128, 128, 80),       # hubert's heads of 80, S = T
    (2, 2, 2, 64, 256, 80),        # S < T
    (1, 4, 2, 128, 192, 32),       # GQA, S < T
    (1, 6, 2, 192, 192, 32)])      # GQA, G = 3
def test_noncausal_plain_forward_matches_pallas_and_chunked(b, hq, hkv, s, t,
                                                            d):
    """``flash_attention_plain(_lse)`` and ``ops.flash_attention`` with
    ``causal=False`` against the Pallas kernel in interpret mode and the
    reference's ``chunked_attention``."""
    rng = np.random.default_rng(s + t + d)
    q, k, v = _rand(rng, b, hq, s, d), _rand(rng, b, hkv, t, d), \
        _rand(rng, b, hkv, t, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=False, bq=64, bk=64,
                                    interpret=True)
    chunked = JA.chunked_attention(jq, jk, jv, causal=False, chunk=96)
    tq, tk, tv = map(_t, (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=False)
    o, lse = flash_attention_plain_lse(tq, tk, tv, causal=False)
    _close(got, np.asarray(pallas), OP, "plain against Pallas")
    _close(got, np.asarray(chunked), OP, "plain against chunked")
    assert torch.equal(o, got)
    sc = np.einsum("bhsd,bhtd->bhst", q, np.repeat(k, hq // hkv, 1)) \
        / math.sqrt(d)
    want_lse = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) \
        + sc.max(-1)
    _close(lse, want_lse, OP, "lse")
    _close(tops.flash_attention(tq, tk, tv, causal=False),
           np.asarray(pallas), OP, "ops.flash_attention")


@pytest.mark.parametrize("b,hq,hkv,s,t,d", [
    (1, 4, 4, 130, 130, 80),       # ragged S = T, D 80
    (1, 2, 2, 70, 200, 80),        # S < T
    (1, 4, 2, 100, 150, 32)])      # GQA
def test_noncausal_backward_matches_jax_grad(b, hq, hkv, s, t, d):
    """The plain backward and ``ops.flash_attention``'s autograd Function
    without the causal mask against ``jax.grad`` of the reference's
    ``chunked_attention(causal=False)``."""
    rng = np.random.default_rng(s * t + d)
    q, k, v = _rand(rng, b, hq, s, d), _rand(rng, b, hkv, t, d), \
        _rand(rng, b, hkv, t, d)
    do = _rand(rng, b, hq, s, d)

    def f(q_, k_, v_):
        out = JA.chunked_attention(q_, k_, v_, causal=False)
        return jnp.sum(out * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray,
                                                        (q, k, v)))
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o, lse = flash_attention_plain_lse(tq, tk, tv, causal=False)
    got = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, causal=False,
                                    chunk=64)
    for name, g_, w_ in zip("qkv", got, want):
        _close(g_, np.asarray(w_), OP, f"d{name} plain")
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = tops.flash_attention(*leaves, causal=False)
    for name, g_, w_ in zip("qkv", torch.autograd.grad(out, leaves, tdo),
                            want):
        _close(g_, np.asarray(w_), OP, f"d{name} through ops")


@functools.lru_cache(maxsize=None)
def _atom_index(rows: int, width: int = 80):
    """Element offsets of a (rows, width) bf16 tile in the D 80 kernels'
    shared memory: 16-column atoms, atom a at a * rows * 16 elements, a
    row 16 elements (32 bytes), the 16-byte halves of rows 4..7 of each
    8-row group swapped (the 32-byte swizzle TMA writes and the wgmma
    descriptors read)."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(width)[None, :]
    half = (c % 16) // 8 ^ ((r >> 2) & 1)
    return (c // 16) * rows * 16 + r * 16 + half * 8 + c % 8


def _d80_forward(q, k, v, *, causal):
    """The bf16 D 80 forward kernel's arithmetic in fp32 PyTorch at its
    true width: Q, K and V tiles stored through ``_atom_index`` and read
    back an atom at a time, 128-query CTAs walking ``flash_kv_walk``'s
    128-key tiles, each 64-query warpgroup following its
    ``flash_fwd_turns``: S over the five 16-column atoms, the online
    softmax (P V of a tile issued in the next turn, after O is rescaled
    by that tile's max), O += P V over the 80 columns in k16 steps, only
    rows below S written."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g, q_offset = hq // hkv, t - s
    scale_log2 = LOG2E / math.sqrt(d)
    bq = 128

    def tile(x, r0, rows):
        """x's rows r0 .. r0 + rows - 1 (zeros past the end) through
        shared memory: (5 atoms, rows, 16 columns)."""
        idx = _atom_index(rows)
        part = x[r0:r0 + rows]
        flat = torch.zeros(rows * d)
        flat[idx[:part.shape[0]].reshape(-1)] = part.reshape(-1)
        return flat[idx].reshape(rows, 5, 16).permute(1, 0, 2)

    out = torch.empty_like(q)
    for bb in range(b):
        for h in range(hq):
            for i0 in range(0, s, bq):
                qlo, qhi = q_offset + i0, q_offset + min(i0 + bq, s) - 1
                walk = flash_kv_walk(qlo, qhi, t, causal, None, 128)
                qt = tile(q[bb, h], i0, bq)
                for wg in range(2):
                    qw = qt[:, 64 * wg:64 * wg + 64]
                    qpos = torch.arange(qlo + 64 * wg,
                                        qlo + 64 * wg + 64)[:, None]
                    acc = torch.zeros((64, d))
                    m = torch.full((64, 1), -math.inf)
                    z = torch.zeros((64, 1))
                    sc, p = {}, {}
                    for op, i in flash_fwd_turns(len(walk), wg):
                        if op in ("sync", "arrive"):
                            continue
                        kt = walk[i]
                        if op == "s":
                            kk = tile(k[bb, h // g], kt * 128, 128)
                            sc[i] = sum(qw[a] @ kk[a].T for a in range(5))
                        elif op == "pv":
                            vv = tile(v[bb, h // g], kt * 128, 128)
                            vrow = vv.permute(1, 0, 2).reshape(128, d)
                            for st in range(0, 128, 16):
                                acc = acc + p[i][:, st:st + 16] @ \
                                    vrow[st:st + 16]
                        else:
                            x = sc.pop(i) * scale_log2
                            kpos = torch.arange(kt * 128,
                                                (kt + 1) * 128)[None, :]
                            ok = kpos < t
                            if causal:
                                ok = ok & (kpos <= qpos)
                            x = torch.where(ok, x, -math.inf)
                            m_new = torch.maximum(
                                m, x.max(1, keepdim=True).values)
                            m_use = torch.where(m_new == -math.inf, 0.0,
                                                m_new)
                            alpha = torch.exp2(m - m_use)
                            p[i] = torch.exp2(x - m_use)
                            z = z * alpha + p[i].sum(1, keepdim=True)
                            acc = acc * alpha
                            m = m_new
                    lo = i0 + 64 * wg
                    rows = max(0, min(64, s - lo))
                    o = acc / z.clamp(min=1e-30)
                    out[bb, h, lo:lo + rows] = o[:rows]
    return out


def _turn_schedule(n_tiles, seed):
    """Both warpgroups' ``flash_fwd_turns`` run one op at a time, the
    runnable one picked at random; a sync passes once the other
    warpgroup has arrived on its barrier. Returns the product issues in
    order as (warpgroup, op, tile); raises on a deadlock, on both
    warpgroups inside a turn at once, or on an arrival left over."""
    rng = np.random.default_rng(seed)
    groups = range(2)
    ops = [flash_fwd_turns(n_tiles, wg) for wg in groups]
    at, in_turn, issued = [0, 0], [False, False], []
    pending = {1: 0, 2: 0}
    while any(at[wg] < len(ops[wg]) for wg in groups):
        runnable = [wg for wg in groups if at[wg] < len(ops[wg]) and not (
            ops[wg][at[wg]][0] == "sync" and pending[ops[wg][at[wg]][1]] == 0)]
        if not runnable:
            raise AssertionError(f"deadlock at {at} ({n_tiles} tiles)")
        wg = int(rng.choice(runnable))
        op, arg = ops[wg][at[wg]]
        at[wg] += 1
        if op == "sync":
            pending[arg] -= 1
            assert not any(in_turn), "both warpgroups in a turn"
            in_turn[wg] = True
        elif op == "arrive":
            pending[arg] += 1
            in_turn[wg] = False
        elif op in ("s", "pv"):
            assert in_turn[wg], "a product issued outside a turn"
            issued.append((wg, op, arg))
        if at[wg] == len(ops[wg]):
            in_turn[wg] = False
    assert not any(pending.values()), pending
    return issued


@pytest.mark.parametrize("n_tiles", [0, 1, 2, 3, 32])
def test_d80_forward_turns_alternate_and_balance(n_tiles):
    """The D 80 forward's ping-pong (``flash_fwd_turns``) under any
    interleaving of its two warpgroups: no deadlock, never both inside a
    turn, every arrival consumed by a sync (no barrier left half-filled
    when the CTA exits), and the tensor cores fed turn by turn,
    warpgroup 0 first: S of tile i and P V of tile i - 1, each tile's S
    before its softmax before its P V."""
    for seed in range(20):
        issued = _turn_schedule(n_tiles, seed)
        want = []
        for i in range(n_tiles + 1 if n_tiles else 0):
            for wg in (0, 1):
                if i < n_tiles:
                    want.append((wg, "s", i))
                if i > 0:
                    want.append((wg, "pv", i - 1))
        assert issued == want, (n_tiles, seed)
    for wg in (0, 1):
        ops = flash_fwd_turns(n_tiles, wg)
        for i in range(n_tiles):
            assert ops.index(("s", i)) < ops.index(("softmax", i)) < \
                ops.index(("pv", i))


@pytest.mark.parametrize("s,t,causal", [
    (300, 300, False), (100, 333, False), (200, 200, True),
    (4000, 4000, False), (4000, 4000, True)])
def test_d80_on_chip_padding_matches_plain(s, t, causal):
    """D 80 at its true width, as both bf16 kernels run it now (the name
    is from when they padded it to D 128's tiles): the shared-memory
    layout of 16-column atoms holds each tile's 160-byte rows once (so a
    box's bytes are its rows' true bytes, the barriers' transaction
    counts), and the forward's turn schedule over it gives the plain
    version (fp32) and the Pallas kernel in interpret mode; the
    non-causal walk reaches every key tile once."""
    for rows in (64, 128):
        idx = _atom_index(rows)
        assert sorted(idx.reshape(-1).tolist()) == list(range(rows * 80))
    hq, hkv = (2, 1) if s > 1000 else (4, 2)     # S = 4,000: 2 / 1 heads
    rng = np.random.default_rng(s + t)
    q, k, v = _rand(rng, 1, hq, s, 80), _rand(rng, 1, hkv, t, 80), \
        _rand(rng, 1, hkv, t, 80)
    got = _d80_forward(_t(q), _t(k), _t(v), causal=causal)
    _close(got, flash_attention_plain(_t(q), _t(k), _t(v), causal=causal),
           OP, "true width against plain")
    blk = lambda n: n if n <= 512 else 500     # noqa: E731 (divides n)
    pallas = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=blk(s), bk=blk(t), interpret=True)
    _close(got, np.asarray(pallas), OP, "true width against Pallas")
    if not causal:
        for i0 in range(0, s, 128):
            qlo = t - s + i0
            assert flash_kv_walk(qlo, qlo + 127, t, False, None, 128) == \
                list(range(-(-t // 128)))


def test_head_dim_80_is_built_in_bf16_only():
    """D 80 is built (hubert-xlarge's head dim) on the ``wgmma`` backward;
    fp32 at D 80 raises a ValueError that names it (the card tests hold
    both wrappers to it on CUDA tensors)."""
    assert 80 in HEAD_DIMS
    assert get_config("hubert-xlarge").head_dim == 80
    assert flash_bwd_instance(torch.bfloat16, 80) == "wgmma"
    with pytest.raises(ValueError, match="fp32 at head dim 80"):
        flash_bwd_instance(torch.float32, 80)
    with pytest.raises(ValueError, match="not built"):
        flash_bwd_instance(torch.bfloat16, 96)


# --------------------------------------------------------------------------
# the two front ends, whole models
# --------------------------------------------------------------------------

def _models(arch, dtype="float32", **kw):
    """(jax cfg, port cfg, jax params, port params): the reference's
    random init handed over by ``params_from_jax``."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype, **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    assert jcfg.__dict__ == cfg.__dict__
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TLM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    return jcfg, cfg, jp, tp


def _batch(cfg, b, s, step, targets=True):
    """(numpy batch) with the family's keys: hubert ``frames`` (B, S,
    d_model) drawn normal, internvl2 ``tokens`` of S - n_prefix and an
    ``image_emb`` prefix (B, n_prefix, d_model); ``targets`` over the
    positions the loss reads."""
    rng = np.random.default_rng(100 + step)
    if cfg.family == "audio":
        out = {"frames": _rand(rng, b, s, cfg.d_model)}
        text = s
    else:
        text = s - cfg.n_prefix_tokens
        toks, _ = synthetic_lm_batch(b, text, cfg.vocab, step=step)
        out = {"tokens": toks,
               "image_emb": _rand(rng, b, cfg.n_prefix_tokens, cfg.d_model)}
    if targets:
        out["targets"] = rng.integers(0, cfg.vocab, (b, text)).astype(
            np.int32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch):
    """The assembled sequence ([image prefix | tokens] or frames) through
    every layer: hubert without the causal mask, internvl2 causal over
    the prefix too (RoPE positions 0 .. S - 1 over the whole sequence)."""
    jcfg, cfg, jp, tp = _models(arch)
    jb, tb = _both(_batch(cfg, 2, 80, 1, targets=False))
    jh, jaux = jax.jit(lambda p, bt: JT.forward_hidden(jcfg, p, bt))(jp, jb)
    h, aux = TLM.forward_hidden(cfg, tp, tb)
    assert h.shape == (2, 80, cfg.d_model)
    _field_close(h, jh, f"{arch} hidden")
    assert float(aux) == float(jaux) == 0.0
    # the encoder sees the future: the last frame changes the first output
    if cfg.family == "audio":
        tb2 = dict(tb, frames=tb["frames"].clone())
        tb2["frames"][:, -1] += torch.from_numpy(
            _rand(np.random.default_rng(9), 2, cfg.d_model))
        h2, _ = TLM.forward_hidden(cfg, tp, tb2)
        assert float((h2[:, 0] - h[:, 0]).abs().max()) > 1e-3
    else:           # without an image the sequence is the tokens alone
        jh0, _ = JT.forward_hidden(jcfg, jp, {"tokens": jb["tokens"]})
        h0, _ = TLM.forward_hidden(cfg, tp, {"tokens": tb["tokens"]})
        assert h0.shape[1] == 80 - cfg.n_prefix_tokens
        _field_close(h0, jh0, f"{arch} text-only hidden")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    """``loss_fn`` (internvl2's image prefix skipped: targets cover the
    text) and every parameter's gradient against ``jax.grad``; a
    ``logit_chunk`` of 16 leaves a remainder. hubert's embedding table
    takes no gradient (frames are no lookup)."""
    jcfg, cfg, jp, tp = _models(arch, logit_chunk=16)
    jb, tb = _both(_batch(cfg, 2, 72, 4))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: JT.loss_fn(jcfg, p, bt), has_aux=True))(jp, jb)
    loss, metrics, grads = TTL.loss_and_grads(cfg, tp, tb)
    _close(loss, np.asarray(jl), 1e-5, "loss")
    _close(metrics["xent"], np.asarray(jm["xent"]), 1e-5, "xent")
    jg = jax.tree_util.tree_map(np.asarray, jg)

    def walk(got, want, path):
        assert set(got) == set(want), path
        for key in want:
            if isinstance(want[key], dict):
                walk(got[key], want[key], f"{path}/{key}")
            elif np.abs(want[key]).max() == 0:
                assert float(got[key].abs().max()) == 0.0, (path, key)
            else:
                _close(got[key], want[key], 1e-4, f"{path}/{key}")
    walk(grads, jg, arch)
    assert (float(grads["embed"].abs().max()) == 0.0) == \
        (cfg.family == "audio")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """``prefill``'s last logits and every cache field; internvl2's image
    prefix takes cache slots 0 .. n_prefix - 1 and ``pos`` counts it."""
    jcfg, cfg, jp, tp = _models(arch)
    b, s = 2, 80
    cap = s + 8
    jb, tb = _both(_batch(cfg, b, s, 3, targets=False))
    jcache, jlogits = jax.jit(lambda p, bt: JT.prefill(jcfg, p, bt, cap))(
        jp, jb)
    cache, logits = TTL.make_prefill_step(cfg, cap)(tp, tb)
    assert logits.shape == (b, 1, cfg.vocab_padded)
    _field_close(logits, jlogits, f"{arch} prefill logits")
    assert set(cache) == set(jcache)
    for key in jcache:
        _field_close(cache[key], jcache[key], f"{arch} prefill {key}")
    assert cache["pos"].tolist() == [s] * b
    assert cache["slot_pos"][0, :s + 1].tolist() == list(range(s)) + [-1]


def test_internvl2_decode_matches_reference_and_a_longer_forward():
    """internvl2: prefill of a 16-position image prefix and 64 tokens,
    then 2 ``decode_step`` calls, against the reference (logits and every
    cache field), and the port's decoded logits against its own
    ``forward_hidden`` over the prefix and all 66 tokens."""
    jcfg, cfg, jp, tp = _models("internvl2-2b")
    b, s = 2, 80
    cap = s + 4
    full = _batch(cfg, b, s + 2, 5, targets=False)
    prompt = dict(full, tokens=full["tokens"][:, :-2])
    jb, tb = _both(prompt)
    jcache, _ = jax.jit(lambda p, bt: JT.prefill(jcfg, p, bt, cap))(jp, jb)
    cache, _ = TLM.prefill(cfg, tp, tb, cap)
    jdec = jax.jit(lambda p, c, t: JT.decode_step(jcfg, p, c, t))
    for i in (2, 1):
        nxt = full["tokens"][:, -i:][:, :1]
        jlogits, jcache = jdec(jp, jcache, jnp.asarray(nxt))
        logits, cache = TLM.decode_step(cfg, tp, cache, _t(nxt))
        _field_close(logits, jlogits, f"decode {i} logits")
        assert set(cache) == set(jcache)
        for key in jcache:
            _field_close(cache[key], jcache[key], f"decode {i} {key}")
    assert cache["pos"].tolist() == [s + 2] * b
    h, _ = TLM.forward_hidden(cfg, tp, {k: _t(v) for k, v in full.items()})
    want = TT._unembed(cfg, tp, h[:, -1:])
    _close(logits, want, 1e-4, "decoded against a longer forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Two ``make_train_step`` steps against the reference's jitted step
    from the same params (the port's init, copied) and batches of the
    family's keys: the four metrics and the params after each step."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jstep, jopt = JTL.make_train_step(jcfg, lr=3e-3)
    step, opt = TTL.make_train_step(cfg, lr=3e-3)
    tp = TLM.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    jp = tree_map(lambda x: jnp.array(x.numpy(), copy=True), tp)
    jstate = JTL.TrainState(jp, jopt.init(jp), None)
    state = TTL.TrainState(tp, opt.init(tp), None)
    jit_step = jax.jit(jstep)
    for i in range(2):
        jb, tb = _both(_batch(cfg, 2, 48, i))
        jstate, jm = jit_step(jstate, jb)
        state, m = step(state, tb)
        for key in jm:
            _close(m[key], np.asarray(jm[key]), 1e-4, f"step {i} {key}")
        _adam_close(state.params, jstate.params, 3e-3 * 3 * (i + 1),
                    f"{arch} step {i} params")


def _adam_close(got: dict, want: dict, bound, what):
    """The train steps' param check of ``tests/test_torch_lm_train.py``:
    all but 0.1 % of the elements within 1e-4 relative (of the element
    and of its leaf's largest), every element within ``bound``."""
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


def test_hubert_bf16_forward_matches_reference():
    """hubert-smoke in bf16 (the config's dtype at full size): frames
    cast to bf16 by the front end, every layer non-causal."""
    jcfg, cfg, jp, tp = _models("hubert-xlarge", dtype="bfloat16")
    jb, tb = _both(_batch(cfg, 2, 70, 2, targets=False))
    jh, _ = jax.jit(lambda p, bt: JT.forward_hidden(jcfg, p, bt))(jp, jb)
    h, _ = TLM.forward_hidden(cfg, tp, tb)
    assert h.dtype == torch.bfloat16
    _close(h, np.asarray(jh, np.float32), 2.0 ** -4, "bf16 hidden")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_reference_structure(arch):
    """The port's init of both smoke configs has the reference's leaves,
    shapes and dtypes (layer norms with a bias for hubert, the padded
    vocab of its cluster targets), and ``init_cache`` runs for both."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    params = TLM.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    spec = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(spec)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).endswith(str(leaf.dtype)), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(params))
    assert cfg.family in TT.PORTED_FAMILIES
    assert ("bias" in params["out_norm"]) == (cfg.norm == "layer")
    cache = TLM.init_cache(cfg, 2, 16, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, 16,
                                cfg.head_dim)
    assert get_config("hubert-xlarge").vocab_padded == 512


def test_full_configs_are_the_published_widths():
    """hubert-xlarge and internvl2-2b at full size: the widths the card
    phase runs, and the head dims the kernels take."""
    hub, vl = get_config("hubert-xlarge"), get_config("internvl2-2b")
    assert (hub.n_layers, hub.d_model, hub.n_heads, hub.head_dim, hub.d_ff,
            hub.causal, hub.norm, hub.act) == (48, 1280, 16, 80, 5120,
                                               False, "layer", "gelu")
    assert (vl.n_layers, vl.d_model, vl.n_heads, vl.n_kv_heads, vl.head_dim,
            vl.n_prefix_tokens, vl.rope_theta) == (24, 2048, 16, 8, 128,
                                                   1024, 1e6)
    for cfg in (hub, vl):
        assert cfg.__dict__ == jax_config(cfg.name).__dict__
        assert cfg.head_dim in HEAD_DIMS


@pytest.mark.parametrize("arch", arch_names())
def test_shaped_batch_matches_reference(arch):
    """``train/lm.shaped_batch``: the reference's keys, shapes and dtypes
    for every config (smoke and full), as ``meta`` tensors; with the
    production mesh each is this rank's block, by the reference's rules
    (its ``resolve_spec`` of ``("batch", "seq")``), carrying its
    sharding."""
    for cfg, jcfg in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        got = TTL.shaped_batch(cfg, 3, 2048)
        want = JTL.shaped_batch(jcfg, 3, 2048)
        assert set(got) == set(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == spec.shape, key
            assert str(got[key].dtype).endswith(str(spec.dtype)), key
    from repro.dist.partition import LM_RULES as JRULES
    from repro.dist.sharding import resolve_spec as jresolve
    from repro_torch.dist import make_production_mesh
    mesh = make_production_mesh()
    cfg = get_config(arch)
    for b in (3, 32):
        got = TTL.shaped_batch(cfg, b, 2048, mesh=mesh)
        want = JTL.shaped_batch(jax_config(arch), b, 2048)
        for key, spec in want.items():
            axes = ("batch", "seq") + (None,) * (len(spec.shape) - 2)
            jspec = tuple(jresolve(axes, mesh, spec.shape, JRULES))
            assert got[key].sharding.spec == jspec, (key, jspec)
            n = 16 if jspec and jspec[0] == "data" else 1
            assert tuple(got[key].shape) == (b // n,) + spec.shape[1:]


@pytest.mark.parametrize("arch", ARCHS)
def test_shaped_batch_drives_a_train_step(arch):
    """A batch made to ``shaped_batch``'s shapes and dtypes runs the
    port's train step (the keys are the ones ``loss_fn`` reads)."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(2)
    batch = {}
    for key, spec in TTL.shaped_batch(cfg, 2, 40).items():
        if spec.dtype == torch.int32:
            batch[key] = torch.from_numpy(rng.integers(
                0, cfg.vocab, tuple(spec.shape)).astype(np.int32))
        else:
            batch[key] = torch.from_numpy(_rand(rng, *spec.shape)).to(
                spec.dtype)
    step, opt = TTL.make_train_step(cfg)
    state = TTL.make_train_state(cfg, torch.Generator().manual_seed(0), opt,
                                 device="cpu")
    state, m = step(state, batch)
    assert all(math.isfinite(float(v)) for v in m.values())
