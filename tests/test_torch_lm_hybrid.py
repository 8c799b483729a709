"""The ssm (mamba2) and hybrid (hymba) LM families and the flash kernels'
attention sinks, on the CPU, against the JAX reference.

The same inputs, made with numpy from a seed, go through ``repro`` and
``repro_torch``:

- attention with sinks (``meta_len``, hymba's meta tokens): the port's
  ``chunked_attention`` / ``flash_attention_plain(_lse)`` /
  ``ops.flash_attention`` against the reference's ``chunked_attention``
  and ``banded_attention``, ``decode_attention`` with sink slots, and the
  plain backward and the autograd Function against ``jax.grad``;
- the kernels' tile walks with sinks (``flash_kv_walk``,
  ``flash_bwd_dkdv_tiles``, ``flash_bwd_dq_tiles``,
  ``flash_bwd_tile_test``): every kept pair lies in a walked tile, no
  tile is walked twice, the tests skip exactly the tiles with no kept
  pair; the backward's tile walk emulated in PyTorch against the plain
  version; and ``csrc/flash_mask.cuh`` compiled for the host (where a
  C++ compiler exists) walking the same tiles as its Python mirror;
- ``mamba2-smoke`` and ``hymba-smoke`` from the reference's params
  (``params_from_jax``): ``forward_hidden``, ``loss_fn`` and every
  gradient, ``prefill`` (every cache field) and 4 ``decode_step`` calls
  (hymba's cache small enough to wrap past its pinned meta slots), two
  ``make_train_step`` steps against the reference's jitted step, and a
  bf16 prefill.

Tolerances (fp32 unless said): single attention calls and their
gradients 1e-5 x the largest reference value (the same sums in another
order over at most a few hundred terms of magnitude ~1); whole models
as ``tests/test_torch_lm.py`` and ``tests/test_torch_lm_train.py`` hold
the other families: prefill / decode fields rtol 1e-4 with atol 1e-4 x
the field's largest reference value, the loss rtol 1e-5, each gradient
within 1e-4 of its largest reference element, train-step metrics rtol
1e-4 and params as ``_adam_close`` states; a prefill against the same
tokens decoded one by one 1e-4 x the largest logit (the recurrence sums
in another order than the chunked SSD). bf16 hymba prefill logits within
2^-4 x the largest reference logit: bf16 roundings of every activation
through two layers (each 2^-8 relative) in both packages, which round at
different points.
"""
from __future__ import annotations

import dataclasses
import math
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm.transformer as JT
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.lm import attention as JA
from repro.train import lm as JTL

from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_plain, flash_attention_plain,
    flash_attention_plain_lse, flash_bwd_dkdv_tiles, flash_bwd_dq_tiles,
    flash_bwd_tile_test, flash_bwd_tiles, flash_kv_walk)
from repro_torch.models import lm as TLM
from repro_torch.models.lm import attention as TA
from repro_torch.models.lm import transformer as TT
from repro_torch.optim.optimizer import tree_map
from repro_torch.train import lm as TTL

ARCHS = ("mamba2-1.3b", "hymba-1.5b")
OP = 1e-5
LOG2E = 1.4426950408889634
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


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


def _kept(kpos, qpos, t, causal, window, meta_len):
    ok = kpos < t
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & ((kpos > qpos - window) | (kpos < meta_len))
    return ok


# --------------------------------------------------------------------------
# attention with sinks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("meta_len", [8, 100, 128])
@pytest.mark.parametrize("s,t,window,hq,hkv", [
    (300, 300, 64, 4, 2), (200, 333, 96, 5, 1), (150, 150, 40, 2, 2)])
def test_sink_attention_matches_reference_chunked_and_banded(
        s, t, window, hq, hkv, meta_len):
    """``meta_len`` 8 and 100 are not multiples of a tile; 128 is
    hymba's."""
    rng = np.random.default_rng(s + window + meta_len)
    q, k, v = _rand(rng, 2, hq, s, 32), _rand(rng, 2, hkv, t, 32), \
        _rand(rng, 2, hkv, t, 32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = JA.chunked_attention(jq, jk, jv, window=window, chunk=64,
                                meta_len=meta_len)
    got = TA.chunked_attention(_t(q), _t(k), _t(v), window=window, chunk=64,
                               meta_len=meta_len)
    _close(got, want, OP, "chunked_attention with sinks")
    plain = flash_attention_plain(_t(q), _t(k), _t(v), window=window,
                                  meta_len=meta_len)
    _close(plain, want, OP, "flash_attention_plain with sinks")
    out, lse = flash_attention_plain_lse(_t(q), _t(k), _t(v), window=window,
                                         meta_len=meta_len)
    assert torch.equal(out, plain)
    # the LSE: the log of the masked softmax's denominator
    qpos = (t - s) + np.arange(s)[:, None]
    kept = _kept(np.arange(t)[None, :], qpos, t, True, window, meta_len)
    sc = np.einsum("bgsd,bgtd->bgst",
                   q.reshape(2, hkv, -1, s, 32).reshape(2, hq, s, 32),
                   np.repeat(k, hq // hkv, 1)) / math.sqrt(32)
    want_lse = np.log(np.where(kept, np.exp(sc - sc.max(-1, keepdims=True)),
                               0).sum(-1)) + sc.max(-1)
    np.testing.assert_allclose(_n(lse), want_lse, rtol=OP, atol=OP)
    tops.reset_kernel_launches()
    via_ops = tops.flash_attention(_t(q), _t(k), _t(v), window=window,
                                   meta_len=meta_len)
    assert torch.equal(via_ops, plain)
    assert not any(tops.kernel_launches().values())
    if s == t:          # the reference's route for hymba's SWA layers
        banded = JA.banded_attention(jq, jk, jv, window=window, chunk=64,
                                     meta_len=meta_len)
        _close(got, banded, OP, "against banded_attention")


@pytest.mark.parametrize("meta_len", [0, 3, 8])
def test_decode_attention_with_sinks_matches_reference(rng, meta_len):
    b, hq, hkv, c, d = 3, 4, 2, 16, 32
    q, k, v = _rand(rng, b, hq, 1, d), _rand(rng, b, hkv, c, d), \
        _rand(rng, b, hkv, c, d)
    slot_pos = rng.integers(-1, 40, (b, c)).astype(np.int32)
    slot_pos[:, :meta_len] = np.arange(meta_len)      # pinned meta slots
    pos = np.asarray([25, 33, 39], np.int32)
    for window in (1 << 30, 6):
        want = JA.decode_attention(
            jnp.asarray(q), JA.KVSlice(jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(slot_pos)),
            jnp.asarray(pos), window=window, meta_len=meta_len)
        got = TA.decode_attention(
            _t(q), TA.KVSlice(_t(k), _t(v), _t(slot_pos)), _t(pos),
            window=window, meta_len=meta_len)
        _close(got, want, OP, f"decode window {window}")


@pytest.mark.parametrize("s,t,window,meta_len", [
    (200, 200, 48, 8), (130, 257, 64, 100), (150, 150, 70, 128)])
def test_sink_backward_matches_jax_grad(rng, s, t, window, meta_len):
    """The plain backward with sinks and ``ops.flash_attention``'s
    autograd Function against ``jax.grad`` of the reference's
    ``chunked_attention(meta_len=)``."""
    hq, hkv, d = 4, 2, 32
    q, k, v = _rand(rng, 1, hq, s, d), _rand(rng, 1, hkv, t, d), \
        _rand(rng, 1, hkv, t, d)
    do = _rand(rng, 1, hq, s, d)

    def f(q_, k_, v_):
        out = JA.chunked_attention(q_, k_, v_, window=window,
                                   meta_len=meta_len)
        return jnp.sum(out * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray,
                                                        (q, k, v)))
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o, lse = flash_attention_plain_lse(tq, tk, tv, window=window,
                                       meta_len=meta_len)
    got = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, window=window,
                                    meta_len=meta_len)
    for name, g_, w_ in zip("qkv", got, want):
        _close(g_, np.asarray(w_), OP, f"d{name} plain")
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = tops.flash_attention(*leaves, window=window, meta_len=meta_len)
    grads = torch.autograd.grad(out, leaves, tdo)
    for name, g_, w_ in zip("qkv", grads, want):
        _close(g_, np.asarray(w_), OP, f"d{name} through ops")


# --------------------------------------------------------------------------
# the kernels' tile walks with sinks
# --------------------------------------------------------------------------

WALK_CASES = [
    (2176, 2176, True, 1024, 128),     # hymba's SWA layer: S = T = 2,176
    (300, 300, True, 64, 8),           # sinks inside the first tile
    (333, 333, True, 96, 100),         # a ragged sink prefix
    (200, 450, True, 70, 130),         # S < T, sinks past a tile
    (260, 260, False, 50, 64),         # not causal
    (150, 150, True, 40, 0),           # no sinks: the old walk
    (256, 256, True, None, 128),       # no window: sinks change nothing
    (1000, 1000, False, None, 0),      # an encoder: S % 64 != 0
    (200, 450, False, None, 0),        # an encoder, S < T
    (77, 300, False, None, 0)]         # S < T, one ragged query tile


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("s,t,causal,window,meta_len", WALK_CASES)
def test_forward_walk_covers_every_kept_pair_once(s, t, causal, window,
                                                  meta_len, bk):
    """The forward's walk (128-query tiles over bk-key tiles; the dQ
    kernel's is the same function): each kept pair in a walked tile,
    no tile twice, sink tiles first; without sinks the old band."""
    q_offset = t - s
    kpos = np.arange(t)[None, :]
    for i0 in range(0, s, 128):
        qlo, qhi = q_offset + i0, q_offset + min(i0 + 128, s) - 1
        tiles = flash_kv_walk(qlo, qhi, t, causal, window, bk, meta_len)
        assert len(tiles) == len(set(tiles)), (i0, tiles)
        assert tiles == sorted(tiles)
        qpos = np.arange(qlo, qhi + 1)[:, None]
        kept = _kept(kpos, qpos, t, causal, window, meta_len)
        cols = np.flatnonzero(kept.any(0))
        assert set(cols // bk) <= set(tiles), i0
        band = flash_kv_walk(qlo, qhi, t, causal, window, bk, 0)
        assert tiles[len(tiles) - len(band):] == band
        if not meta_len or window is None:
            assert tiles == band


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("s,t,causal,window,meta_len", WALK_CASES[1:])
def test_backward_walks_and_tile_tests_with_sinks(s, t, causal, window,
                                                  meta_len, d):
    """Both backward walks at head dim ``d``'s tiles: every kept pair
    reached once per walk, ``skip`` exactly where no pair is kept (never
    at D 256, which has no skip branch), ``full`` only where every pair
    is kept."""
    kv_tile, q_step, q_tile, kv_step = flash_bwd_tiles(d)
    q_offset = t - s
    seen = np.zeros((s, t), np.int32)
    for k0 in range(0, t, kv_tile):
        tiles = list(flash_bwd_dkdv_tiles(s, t, k0, causal, window, d,
                                          meta_len))
        assert len(tiles) == len(set(tiles))
        for qt in tiles:
            i0 = qt * q_step
            for kw0 in range(k0, k0 + kv_tile, 64):
                qpos = q_offset + np.arange(i0, min(i0 + 64, s))[:, None]
                kp = np.arange(kw0, kw0 + 64)[None, :]
                kept = _kept(kp, qpos, t, causal, window, meta_len)
                test = flash_bwd_tile_test(kw0, int(qpos[0, 0]),
                                           int(qpos[-1, 0]), t, causal,
                                           window, meta_len)
                assert (test == "skip") == (not kept.any())
                assert test != "skip" or d != 256
                assert test != "full" or kept.all()
                cols = kp[0][kp[0] < t]
                seen[i0:i0 + len(qpos), cols] += kept[:, :len(cols)]
    all_kept = _kept(np.arange(t)[None, :], q_offset + np.arange(s)[:, None],
                     t, causal, window, meta_len)
    assert (seen == all_kept).all()
    seen[:] = 0
    for i0 in range(0, s, q_tile):
        tiles = flash_bwd_dq_tiles(s, t, i0, causal, window, d, meta_len)
        assert len(tiles) == len(set(tiles))
        for kt in tiles:
            for w0 in range(i0, min(i0 + q_tile, s), 64):
                qpos = q_offset + np.arange(w0, min(w0 + 64, s))[:, None]
                kp = np.arange(kt * kv_step, kt * kv_step + 64)[None, :]
                kept = _kept(kp, qpos, t, causal, window, meta_len)
                test = flash_bwd_tile_test(kt * kv_step, int(qpos[0, 0]),
                                           int(qpos[-1, 0]), t, causal,
                                           window, meta_len)
                assert (test == "skip") == (not kept.any())
                assert test != "skip" or d != 256
                assert test != "full" or kept.all()
                cols = kp[0][kp[0] < t]
                seen[w0:w0 + len(qpos), cols] += kept[:, :len(cols)]
    assert (seen == all_kept).all()


def _tiled_bwd(q, k, v, o, do, lse, *, causal, window, meta_len):
    """The wgmma backward's two walks with sinks at D = 64's tiles, in
    fp32 PyTorch, each group of 64 rows skipped or masked as
    ``flash_bwd_tile_test`` says: (dq, dk, dv)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g, q_offset = hq // hkv, t - s
    scale = 1.0 / math.sqrt(d)
    kv_tile, q_step, q_tile, kv_step = flash_bwd_tiles(d)
    delta = (do * o).sum(-1)
    pad = max(s, t) + 2 * kv_tile

    def padded(x, fill=0.0):
        out = torch.full(x.shape[:2] + (pad,) + x.shape[3:], fill)
        out[:, :, :x.shape[2]] = x
        return out
    qp, dop, kp, vp = padded(q), padded(do), padded(k), padded(v)
    l2 = padded((lse * LOG2E)[..., None], math.inf)[..., 0]
    dlp = padded(delta[..., None])[..., 0]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def p_ds(sc, dp, rl2, rdl, kpos, qpos, test):
        p = torch.exp2(sc * scale * LOG2E - rl2)
        if test == "mask":
            p = torch.where(_kept(kpos, qpos, t, causal, window, meta_len),
                            p, 0.0)
        return p, p * (dp - rdl)

    for bb in range(b):
        for kvh in range(hkv):
            for kw0 in range(0, t, 64):
                k0 = kw0 // kv_tile * kv_tile
                acc_k, acc_v = torch.zeros((64, d)), torch.zeros((64, d))
                for h in range(kvh * g, kvh * g + g):
                    for qt in flash_bwd_dkdv_tiles(s, t, k0, causal, window,
                                                   d, meta_len):
                        i0 = qt * q_step
                        qlo = q_offset + i0
                        test = flash_bwd_tile_test(
                            kw0, qlo, q_offset + min(i0 + 63, s - 1), t,
                            causal, window, meta_len)
                        if test == "skip":
                            continue
                        qs, dos = qp[bb, h, i0:i0 + 64], dop[bb, h, i0:i0 + 64]
                        pt, dst = p_ds(
                            kp[bb, kvh, kw0:kw0 + 64] @ qs.T,
                            vp[bb, kvh, kw0:kw0 + 64] @ dos.T,
                            l2[bb, h, i0:i0 + 64][None],
                            dlp[bb, h, i0:i0 + 64][None],
                            torch.arange(kw0, kw0 + 64)[:, None],
                            torch.arange(qlo, qlo + 64)[None, :], test)
                        acc_v += pt @ dos
                        acc_k += dst @ qs
                n = min(64, t - kw0)
                dk[bb, kvh, kw0:kw0 + n] = acc_k[:n] * scale
                dv[bb, kvh, kw0:kw0 + n] = acc_v[:n]
            for h in range(kvh * g, kvh * g + g):
                for w0 in range(0, s, 64):
                    i0 = w0 // q_tile * q_tile
                    wq_lo = q_offset + w0
                    acc = torch.zeros((64, d))
                    for kt in flash_bwd_dq_tiles(s, t, i0, causal, window, d,
                                                 meta_len):
                        kpos0 = kt * kv_step
                        test = flash_bwd_tile_test(
                            kpos0, wq_lo, q_offset + min(w0 + 63, s - 1), t,
                            causal, window, meta_len)
                        if test == "skip":
                            continue
                        ks = kp[bb, kvh, kpos0:kpos0 + 64]
                        _, ds = p_ds(
                            qp[bb, h, w0:w0 + 64] @ ks.T,
                            dop[bb, h, w0:w0 + 64] @ vp[
                                bb, kvh, kpos0:kpos0 + 64].T,
                            l2[bb, h, w0:w0 + 64][:, None],
                            dlp[bb, h, w0:w0 + 64][:, None],
                            torch.arange(kpos0, kpos0 + 64)[None, :],
                            torch.arange(wq_lo, wq_lo + 64)[:, None], test)
                        acc += ds @ ks
                    n = min(64, s - w0)
                    dq[bb, h, w0:w0 + n] = acc[:n] * scale
    return dq, dk, dv


@pytest.mark.parametrize("s,t,meta_len", [(330, 330, 128), (190, 260, 8)])
def test_emulated_sink_walk_matches_plain(rng, s, t, meta_len):
    """hymba's group of 5 query heads a KV head at D 64: the emulated
    tile walk gives the plain backward's (dq, dk, dv)."""
    q, k, v = _t(_rand(rng, 1, 5, s, 64)), _t(_rand(rng, 1, 1, t, 64)), \
        _t(_rand(rng, 1, 1, t, 64))
    do = _t(_rand(rng, 1, 5, s, 64))
    kw = dict(causal=True, window=96, meta_len=meta_len)
    o, lse = flash_attention_plain_lse(q, k, v, **kw)
    got = _tiled_bwd(q, k, v, o, do, lse, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    for name, g_, w_ in zip("qkv", got, want):
        _close(g_, w_, OP, f"d{name}")


_HOST_DRIVER = r"""
#define __host__
#define __device__
#include <cstdio>
#include "flash_mask.cuh"
int main() {
  long long t, window, meta, qlo, qhi, k0, kmax;
  int causal, has_window, bk, s;
  while (scanf("%lld %d %d %lld %lld %lld %lld %d %lld %lld %d", &t, &causal,
               &has_window, &window, &meta, &qlo, &qhi, &bk, &k0, &kmax,
               &s) == 11) {
    const FlashMask mk{t, causal, has_window, window, meta};
    const FlashMask::KvWalk w = mk.kv_walk(qlo, qhi, bk);
    for (int i = 0; i < w.n_tiles; ++i) printf("%d ", w.tile(i));
    int qt0, n_qt;
    mk.q_walk(k0, kmax, s, 64, &qt0, &n_qt);
    printf("| %d %d | %d %d\n", n_qt ? qt0 : -1, n_qt,
           (int)mk.skip(k0, kmax, qlo, qhi),
           (int)mk.need_mask(k0, 64, qlo, qhi));
  }
  return 0;
}
"""


def test_flash_mask_header_walks_like_its_python_mirror(tmp_path):
    """``csrc/flash_mask.cuh`` (the walks and tile tests every instance of
    both kernels calls) compiled for the host, against the Python mirrors
    the tests above hold to the mask, over hymba's shapes and edge
    cases."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build flash_mask.cuh with")
    src = tmp_path / "walk.cc"
    src.write_text(_HOST_DRIVER)
    exe = tmp_path / "walk"
    subprocess.run([cxx, "-std=c++17", "-O1", "-x", "c++", f"-I{CSRC}",
                    str(src), "-o", str(exe)], check=True)
    rng = np.random.default_rng(0)
    cases, want = [], []
    for s, t, causal, window, meta in WALK_CASES:
        for _ in range(12):
            i0 = int(rng.integers(0, s)) // 64 * 64
            qlo, qhi = t - s + i0, t - s + min(i0 + 128, s) - 1
            bk = int(rng.choice([64, 128]))
            k0 = int(rng.integers(0, t)) // 64 * 64
            kmax = min(k0 + 64, t) - 1
            cases.append(f"{t} {int(causal)} {int(window is not None)} "
                         f"{window or 0} {meta} {qlo} {qhi} {bk} {k0} {kmax} "
                         f"{s}")
            tiles = flash_kv_walk(qlo, qhi, t, causal, window, bk, meta)
            qts = flash_bwd_dkdv_tiles(s, t, k0, causal, window, 256, meta)
            test = flash_bwd_tile_test(k0, qlo, qhi, t, causal, window, meta)
            # mask: need_mask's answer ("skip" tiles never reach it)
            mask = test == "mask" or (test == "skip" and (
                k0 + 64 > t or (causal and k0 + 63 > qlo) or
                (window is not None and max(k0, meta) <= min(
                    k0 + 63, qhi - window))))
            want.append(f"{' '.join(map(str, tiles))} | "
                        f"{qts.start if len(qts) else -1} {len(qts)} | "
                        f"{int(test == 'skip')} {int(mask)}")
    out = subprocess.run([str(exe)], input="\n".join(cases) + "\n",
                         capture_output=True, text=True, check=True).stdout
    got = [" ".join(line.split()) for line in out.strip().split("\n")]
    assert len(got) == len(want)
    for c, g_, w_ in zip(cases, got, want):
        assert g_ == " ".join(w_.split()), c


# --------------------------------------------------------------------------
# the two families, whole models
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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch):
    jcfg, cfg, jp, tp = _models(arch)
    toks, _ = synthetic_lm_batch(2, 80, cfg.vocab, step=1)
    jh, jaux = jax.jit(lambda p, t: JT.forward_hidden(jcfg, p, {"tokens": t})
                       )(jp, jnp.asarray(toks))
    h, aux = TLM.forward_hidden(cfg, tp, {"tokens": _t(toks)})
    assert h.shape[1] == 80 + cfg.n_meta_tokens
    _field_close(h, jh, f"{arch} hidden")
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """prefill of 80 tokens (88 with hymba's 8 meta tokens: past its
    64-token window) and 4 greedy-free decode steps; hymba's 90-slot cache
    wraps at step 3 into slot 8, the first slot past the pinned meta
    tokens."""
    jcfg, cfg, jp, tp = _models(arch)
    b, s = 2, 80
    cap = s + cfg.n_meta_tokens + 2
    toks, _ = synthetic_lm_batch(b, s, cfg.vocab, step=3)
    jcache, jlogits = jax.jit(lambda p, bt: JT.prefill(jcfg, p, bt, cap))(
        jp, {"tokens": jnp.asarray(toks)})
    cache, logits = TTL.make_prefill_step(cfg, cap)(tp, {"tokens": _t(toks)})
    _field_close(logits, jlogits, f"{arch} prefill logits")
    assert set(cache) == set(jcache)
    for key in jcache:
        _field_close(cache[key], jcache[key], f"{arch} prefill {key}")
    jdec = jax.jit(lambda p, c, t: JT.decode_step(jcfg, p, c, t))
    dec = TTL.make_decode_step(cfg)
    nxt = np.random.default_rng(7).integers(0, cfg.vocab, (b, 4)
                                            ).astype(np.int32)
    for i in range(4):
        jlogits, jcache = jdec(jp, jcache, jnp.asarray(nxt[:, i:i + 1]))
        logits, cache = dec(tp, cache, _t(nxt[:, i:i + 1]))
        _field_close(logits, jlogits, f"{arch} decode {i} logits")
        assert set(cache) == set(jcache)
        for key in jcache:
            _field_close(cache[key], jcache[key], f"{arch} decode {i} {key}")
    if cfg.has_attention:
        m = cfg.n_meta_tokens
        slots = cache["slot_pos"][0]
        assert slots[:m].tolist() == list(range(m))     # meta pinned
        assert slots[m:m + 2].tolist() == [cap, cap + 1]  # wrapped


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """The port alone: a prefill of S tokens and 8 decode steps of the
    prompt's next tokens give the last logits of a prefill of S + 8 (the
    SSM recurrence against the chunked SSD, decode attention with sinks
    against the flash path)."""
    cfg = get_smoke_config(arch)
    params = TLM.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    toks, _ = synthetic_lm_batch(2, 78, cfg.vocab, step=5)
    cap = 78 + cfg.n_meta_tokens
    cache, _ = TLM.prefill(cfg, params, {"tokens": _t(toks[:, :70])}, cap)
    for i in range(70, 78):
        logits, cache = TLM.decode_step(cfg, params, cache,
                                        _t(toks[:, i:i + 1]))
    _, want = TLM.prefill(cfg, params, {"tokens": _t(toks)}, cap)
    _close(logits, want, 1e-4, f"{arch} decoded against prefilled")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    """``loss_fn`` (the meta tokens' positions skipped) and every
    parameter's gradient (the mixers', the meta tokens', the mix gains)
    against ``jax.grad``; a ``logit_chunk`` of 16 leaves a remainder."""
    jcfg, cfg, jp, tp = _models(arch, logit_chunk=16)
    toks, tgts = synthetic_lm_batch(2, 72, cfg.vocab, step=4)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    tb = {"tokens": _t(toks), "targets": _t(tgts)}
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
            else:
                _close(got[key], want[key], 1e-4, f"{path}/{key}")
    walk(grads, jg, arch)
    if cfg.n_meta_tokens:
        assert float(grads["meta"].abs().max()) > 0


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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Two ``make_train_step`` steps against the reference's jitted step
    from the same params (the port's init, copied) and batches: the four
    metrics and the params after each step."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jstep, jopt = JTL.make_train_step(jcfg, lr=3e-3)
    step, opt = TTL.make_train_step(cfg, lr=3e-3)
    tp = TLM.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    jp = tree_map(lambda x: jnp.array(x.numpy(), copy=True), tp)
    jstate = JTL.TrainState(jp, jopt.init(jp), None)
    state = TTL.TrainState(tp, opt.init(tp), None)
    jit_step = jax.jit(jstep)
    for i in range(2):
        toks, tgts = synthetic_lm_batch(2, 48, cfg.vocab, step=i)
        jstate, jm = jit_step(jstate, {"tokens": jnp.asarray(toks),
                                       "targets": jnp.asarray(tgts)})
        state, m = step(state, {"tokens": _t(toks), "targets": _t(tgts)})
        for key in jm:
            _close(m[key], np.asarray(jm[key]), 1e-4, f"step {i} {key}")
        _adam_close(state.params, jstate.params, 3e-3 * 3 * (i + 1),
                    f"{arch} step {i} params")


def test_hymba_bf16_prefill_matches_reference():
    """hymba-smoke in bf16 (the config's dtype at full size)."""
    jcfg, cfg, jp, tp = _models("hymba-1.5b", dtype="bfloat16")
    assert tp["layers"]["ssm"]["in_proj"].dtype == torch.bfloat16
    assert tp["layers"]["ssm"]["A_log"].dtype == torch.float32
    toks, _ = synthetic_lm_batch(2, 70, cfg.vocab, step=2)
    jcache, jlogits = jax.jit(lambda p, bt: JT.prefill(jcfg, p, bt, 80))(
        jp, {"tokens": jnp.asarray(toks)})
    cache, logits = TLM.prefill(cfg, tp, {"tokens": _t(toks)}, 80)
    assert logits.dtype == torch.bfloat16
    _close(logits, np.asarray(jlogits, np.float32), 2.0 ** -4,
           "bf16 prefill logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_params_from_jax_structure(arch):
    """The port's init has the reference's leaves, shapes and dtypes (the
    mixers', the mix gains, the meta tokens); ``params_from_jax`` keeps
    bf16 and fp32 leaves as they are."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    params = TLM.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    spec = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(spec)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).endswith(str(leaf.dtype)), path
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TLM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    mix = tp["layers"]["mixer" if cfg.ssm else "ssm"]
    assert mix["in_proj"].dtype == torch.bfloat16
    assert mix["D"].dtype == torch.float32
    np.testing.assert_array_equal(
        mix["conv_w"].float().numpy(),
        np.asarray(jp["layers"]["mixer" if cfg.ssm else "ssm"]["conv_w"]
                   ).astype(np.float32))
    if cfg.n_meta_tokens:
        assert tp["meta"].shape == (cfg.n_meta_tokens, cfg.d_model)
        assert tp["meta"].dtype == torch.bfloat16
    cache = TLM.init_cache(cfg, 2, 16, device="cpu")
    assert ("k" in cache) == cfg.has_attention
    assert cache["ssm_state"].dtype == torch.float32
    assert cache["conv_buf"].dtype == torch.bfloat16
    assert cfg.family in TT.PORTED_FAMILIES


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_smoke_config_on_cpu(capsys, arch):
    """``launch/train.py --mode lm`` takes both families as it takes the
    others (a few steps on the CPU, the reference's step lines)."""
    from repro_torch.launch import train as launch_train
    rc = launch_train.main(["--mode", "lm", "--arch", arch, "--smoke",
                            "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "step     0 loss" in out and "last step 3" in out
