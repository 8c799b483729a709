"""The flash-attention backward's Hopper design and the ragged GEMM's
copy-free dX, on the CPU, against the JAX reference.

The card's ``wgmma`` backward (``csrc/flash_attention_bwd.cu``) cannot
run here, so its tile walk is emulated in PyTorch at the tiles
``flash_bwd_tiles`` names for the head dim: at D 64 and 128 the dK / dV
kernel's 128-key CTAs of two 64-key warpgroups over 64-query ring stages
and the dQ kernel's 128-query CTAs of two 64-query warpgroups over 64-key
stages (D 80 on these tiles too: its on-chip zero columns past 80 leave
every sum as it is); at D 256 64-key and 64-query CTAs whose two warpgroups split the
head dim (which leaves every output element's sum as it is). Each walks
the tiles that ``flash_bwd_dkdv_tiles`` / ``flash_bwd_dq_tiles`` name,
skipping or masking each group of 64 rows as ``flash_bwd_tile_test``
says (a "full" tile gets no mask), rows past S carrying an LSE of +inf
and K / V rows past T read as zero, as TMA's fill gives them. The emulation is held against
``flash_attention_bwd_plain`` and against ``jax.grad`` of the reference's
``chunked_attention``: fp32 within 1e-5 relative and 1e-5 of the largest
reference value (the same sums in another order over at most a few
hundred terms). Also: the instance routing, ``ragged_gemm_plain`` with
``transpose_w`` bitwise against the plain version on a copied Wᵀ, and
every full-width config of a ported family at a head dim the kernels
take, and ``flash_bwd_row_floors``: the plain version's bf16 rows within
the card's row check of the fp32 oracle, dropped keys outside it.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import attention as JA

from repro_torch.configs import arch_names, get_config
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, flash_attention_bwd_plain, flash_attention_plain_lse,
    flash_bwd_dkdv_tiles, flash_bwd_dq_tiles, flash_bwd_instance,
    flash_bwd_row_floors, flash_bwd_tile_test, flash_bwd_tiles)
from repro_torch.kernels.ragged_gemm import ragged_gemm_plain
from repro_torch.models.lm import PORTED_FAMILIES

TOL = 1e-5
LOG2E = 1.4426950408889634


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _kept(kpos, qpos, t, causal, window):
    """The forward's mask on (key, query) position grids."""
    ok = kpos < t
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return ok


def _tiled_bwd(q, k, v, o, do, lse, *, causal, window):
    """The wgmma backward's tile walk in fp32 PyTorch: (dq, dk, dv)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    q_offset = t - s
    scale = 1.0 / math.sqrt(d)
    scale_log2 = scale * LOG2E
    kv_tile, q_step, q_tile, kv_step = flash_bwd_tiles(d)
    delta = (do * o).sum(-1)
    # rows past S read zero (Q, dO) with an LSE of +inf; K and V past T zero
    pad_s = -(-s // q_tile) * q_tile + q_step
    pad_t = -(-t // kv_tile) * kv_tile + kv_step

    def padded(x, rows, fill=0.0):
        out = torch.full(x.shape[:2] + (rows,) + x.shape[3:], fill)
        out[:, :, :x.shape[2]] = x
        return out

    qp, dop = padded(q, pad_s), padded(do, pad_s)
    lse2 = padded((lse * LOG2E)[..., None], pad_s, math.inf)[..., 0]
    dlp = padded(delta[..., None], pad_s)[..., 0]
    kp, vp = padded(k, pad_t), padded(v, pad_t)
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)

    def p_ds(sc, dp, rows_l2, rows_dl, kpos, qpos, test):
        p = torch.exp2(sc * scale_log2 - rows_l2)
        if test == "mask":
            p = torch.where(_kept(kpos, qpos, t, causal, window), p, 0.0)
        return p, p * (dp - rows_dl)

    for bb in range(b):
        for kvh in range(hkv):
            for k0 in range(0, t, kv_tile):
                for wg in range(kv_tile // 64):
                    kw0 = k0 + 64 * wg
                    kw = kp[bb, kvh, kw0:kw0 + 64]
                    vw = vp[bb, kvh, kw0:kw0 + 64]
                    acc_k = torch.zeros((64, d))
                    acc_v = torch.zeros((64, d))
                    for gg in range(g):
                        h = kvh * g + gg
                        for qt in flash_bwd_dkdv_tiles(s, t, k0, causal,
                                                       window, d):
                            i0 = qt * q_step
                            qlo = q_offset + i0
                            qhi = q_offset + min(i0 + 63, s - 1)
                            test = flash_bwd_tile_test(kw0, qlo, qhi, t,
                                                       causal, window)
                            if test == "skip":
                                continue
                            qs = qp[bb, h, i0:i0 + 64]
                            dos = dop[bb, h, i0:i0 + 64]
                            kpos = torch.arange(kw0, kw0 + 64)[:, None]
                            qpos = torch.arange(qlo, qlo + 64)[None, :]
                            pt, dst = p_ds(kw @ qs.T, vw @ dos.T,
                                           lse2[bb, h, i0:i0 + 64][None],
                                           dlp[bb, h, i0:i0 + 64][None],
                                           kpos, qpos, test)
                            acc_v += pt @ dos
                            acc_k += dst @ qs
                    n = max(0, min(64, t - kw0))
                    dk[bb, kvh, kw0:kw0 + n] = acc_k[:n] * scale
                    dv[bb, kvh, kw0:kw0 + n] = acc_v[:n]
            for gg in range(g):
                h = kvh * g + gg
                for i0 in range(0, s, q_tile):
                    tiles = flash_bwd_dq_tiles(s, t, i0, causal, window, d)
                    for wg in range(q_tile // 64):
                        w0 = i0 + 64 * wg
                        if w0 >= s:
                            continue
                        wq_lo = q_offset + w0
                        wq_hi = q_offset + min(w0 + 63, s - 1)
                        qs = qp[bb, h, w0:w0 + 64]
                        dos = dop[bb, h, w0:w0 + 64]
                        acc = torch.zeros((64, d))
                        for kt in tiles:
                            kpos0 = kt * kv_step
                            test = flash_bwd_tile_test(kpos0, wq_lo, wq_hi,
                                                       t, causal, window)
                            if test == "skip":
                                continue
                            ks = kp[bb, kvh, kpos0:kpos0 + 64]
                            vs = vp[bb, kvh, kpos0:kpos0 + 64]
                            qpos = torch.arange(wq_lo, wq_lo + 64)[:, None]
                            kpos = torch.arange(kpos0, kpos0 + 64)[None, :]
                            _, ds = p_ds(qs @ ks.T, dos @ vs.T,
                                         lse2[bb, h, w0:w0 + 64][:, None],
                                         dlp[bb, h, w0:w0 + 64][:, None],
                                         kpos, qpos, test)
                            acc += ds @ ks
                        n = min(64, s - w0)
                        dq[bb, h, w0:w0 + n] = acc[:n] * scale
    return dq, dk, dv


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,s,t,causal,window", [
    (1, 4, 1, 200, 333, True, None),      # S < T, G = 4, ragged tiles
    (1, 2, 2, 130, 130, False, None),     # not causal, G = 1
    (1, 4, 1, 150, 150, True, 70),        # sliding window, G = 4
    (2, 2, 2, 77, 300, True, 90),         # S < T, window, G = 1
    (1, 4, 1, 100, 190, False, 40),       # window, not causal
    (1, 6, 2, 190, 257, True, 100),       # G = 3, causal window, S < T
    (1, 2, 1, 128, 128, True, None)])     # whole tiles, G = 2
def test_tile_walk_matches_plain_and_jax_grad(b, hq, hkv, s, t, causal,
                                              window, d):
    """The emulated wgmma tile walk gives the plain version's and
    ``jax.grad``'s (dq, dk, dv)."""
    rng = np.random.default_rng(s + t + d)
    q, k, v = _rand(rng, b, hq, s, d), _rand(rng, b, hkv, t, d), \
        _rand(rng, b, hkv, t, d)
    do = _rand(rng, b, hq, s, d)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain_lse(tq, tk, tv, causal=causal,
                                       window=window)
    got = _tiled_bwd(tq, tk, tv, o, tdo, lse, causal=causal, window=window)
    plain = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, causal=causal,
                                      window=window)

    def f(q_, k_, v_):
        out = JA.chunked_attention(q_, k_, v_, causal=causal, window=window)
        return jnp.sum(out * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    for name, g_, p_, w_ in zip("qkv", got, plain, want):
        _close(g_, p_.numpy(), f"d{name} against the plain version")
        _close(g_, np.asarray(w_), f"d{name} against jax.grad")


@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("s,t,causal,window", [
    (2048, 2048, True, None), (200, 333, True, None), (150, 150, True, 70),
    (100, 190, False, 40), (77, 300, False, None)])
def test_tile_tests_agree_with_the_mask(s, t, causal, window, d):
    """Over every tile of both walks at head dim ``d``'s tiles: ``skip``
    exactly where no pair is kept (never at D 256, whose kernels have no
    skip branch: each tile there is a whole CTA's), ``full`` only where
    every pair is kept and every key lies below T; and the walks reach
    every kept pair."""
    kv_tile, q_step, q_tile, kv_step = flash_bwd_tiles(d)
    q_offset = t - s
    seen = np.zeros((s, t), bool)
    for k0 in range(0, t, kv_tile):
        for qt in flash_bwd_dkdv_tiles(s, t, k0, causal, window, d):
            i0 = qt * q_step
            for kw0 in range(k0, k0 + kv_tile, 64):
                qpos = q_offset + np.arange(i0, min(i0 + 64, s))[:, None]
                kpos = np.arange(kw0, kw0 + 64)[None, :]
                kept = _kept(kpos, qpos, t, causal, window)
                test = flash_bwd_tile_test(kw0, int(qpos[0, 0]),
                                           int(qpos[-1, 0]), t, causal,
                                           window)
                assert (test == "skip") == (not kept.any())
                assert test != "skip" or d != 256
                if test == "full":
                    assert kept.all()
                cols = kpos[0][kpos[0] < t]
                seen[i0:i0 + len(qpos), cols] |= kept[:, :len(cols)]
    qpos = q_offset + np.arange(s)[:, None]
    all_kept = _kept(np.arange(t)[None, :], qpos, t, causal, window)
    assert (seen == all_kept).all()
    seen[:] = False
    for i0 in range(0, s, q_tile):
        for kt in flash_bwd_dq_tiles(s, t, i0, causal, window, d):
            for w0 in range(i0, i0 + q_tile, 64):
                if w0 >= s:
                    continue
                qpos = q_offset + np.arange(w0, min(w0 + 64, s))[:, None]
                kpos = np.arange(kt * kv_step, kt * kv_step + 64)[None, :]
                kept = _kept(kpos, qpos, t, causal, window)
                test = flash_bwd_tile_test(kt * kv_step, int(qpos[0, 0]),
                                           int(qpos[-1, 0]), t, causal,
                                           window)
                assert (test == "skip") == (not kept.any())
                assert test != "skip" or d != 256
                if test == "full":
                    assert kept.all()
                cols = kpos[0][kpos[0] < t]
                seen[w0:w0 + len(qpos), cols] |= kept[:, :len(cols)]
    assert (seen == all_kept).all()


def test_backward_instances_route_by_dtype_and_head_dim():
    assert flash_bwd_instance(torch.bfloat16, 128) == "wgmma"
    assert flash_bwd_instance(torch.bfloat16, 64) == "wgmma"
    assert flash_bwd_instance(torch.bfloat16, 80) == "wgmma"
    assert flash_bwd_instance(torch.bfloat16, 32) == "wmma"
    assert flash_bwd_instance(torch.bfloat16, 256) == "wgmma"
    assert flash_bwd_instance(torch.float32, 128) == "f32"
    with pytest.raises(ValueError, match="227 KB"):
        flash_bwd_instance(torch.float32, 256)
    with pytest.raises(ValueError, match="fp32 at head dim 80"):
        flash_bwd_instance(torch.float32, 80)
    with pytest.raises(ValueError, match="not built"):
        flash_bwd_instance(torch.bfloat16, 96)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(3, 256, 16, 24), (4, 128, 100, 72),
                                     (2, 256, 512, 384)])
def test_ragged_plain_transpose_w_is_bitwise(dtype, e, c, d, f):
    """dY @ W[e]ᵀ read in place equals the plain version on a copied Wᵀ
    bit for bit, and a dY of the forward's width raises."""
    rng = np.random.default_rng(e + c + d + f)
    dy = torch.from_numpy(_rand(rng, e * c, f)).to(dtype)
    w = torch.from_numpy(_rand(rng, e, d, f)).to(dtype)
    te = torch.from_numpy(rng.permutation(
        np.arange(e * c // 128) % e).astype(np.int32))
    got = ragged_gemm_plain(dy, w, te, transpose_w=True)
    want = ragged_gemm_plain(dy, w.transpose(1, 2).contiguous(), te)
    assert got.shape == (e * c, d) and torch.equal(got, want)
    with pytest.raises(ValueError, match=r"\(T, F\)"):
        ragged_gemm_plain(dy[:, :f - 1], w, te, transpose_w=True)


def test_every_ported_config_has_a_built_head_dim():
    """Every full-width config of a ported family runs its attention
    through the flash kernels on the card, so its head dim must be one
    they are built for (gemma-7b's is 256, hubert-xlarge's 80); every
    config's family is ported."""
    dims = {a: get_config(a).head_dim for a in arch_names()
            if get_config(a).family in PORTED_FAMILIES}
    assert set(dims) == set(arch_names())
    assert dims["gemma-7b"] == 256 and dims["hubert-xlarge"] == 80
    missing = {a: d for a, d in dims.items() if d not in HEAD_DIMS}
    assert not missing, missing


def _row_check_ratio(out, oracle, floor):
    """``chip_smoke.check_lm_launch``'s row measure: each row's max |out
    - oracle| less its floor, over the row's max |oracle| (at least 2^-24
    x the largest); the worst row."""
    width = out.shape[-1]
    err = (out.float() - oracle).abs().reshape(-1, width).amax(-1)
    err = (err - floor).clamp(min=0.0)
    row_max = oracle.abs().reshape(-1, width).amax(-1)
    low = max(2.0 ** -24 * float(row_max.max()), 1e-30)
    return float((err / row_max.clamp(min=low)).max())


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("common,causal,d,t", [
    (0.0, False, 64, 256), (8.0, False, 64, 256), (8.0, True, 80, 384),
    (50.0, False, 128, 256)])
def test_row_floors_cover_bf16_operands_and_catch_dropped_keys(
        common, causal, d, t):
    """``flash_bwd_row_floors`` for bf16 inputs: the plain version (P and
    dS rounded to bf16 as operands, the kernel's arithmetic) passes the
    card's row check against the fp32 oracle (2^-7 of each row past its
    floor), also where the keys share a common part, so that dQ's rows
    cancel (dS sums to zero over a row) and a floor of fp32 reordering
    alone does not cover dS's rounding; dK's and dV's floors are that
    reordering floor alone. Each fault that ``chip_smoke.check_flash_bwd``
    plants (two keys or one 64 x 64 tile missing from dQ, one tile or two
    queries missing from dK or dV) fails it."""
    tol = 2.0 ** -7
    smoke = _chip_smoke()
    rng = np.random.default_rng(int(common) + t + d)
    b, hq, hkv, s = 1, 4, 2, t

    def randn(*shape):
        return torch.from_numpy(_rand(rng, *shape))
    q = randn(b, hq, s, d).bfloat16()
    k = (0.3 * randn(b, hkv, t, d) + common * randn(1, 1, 1, d)).bfloat16()
    v, do = randn(b, hkv, t, d).bfloat16(), randn(b, hq, s, d).bfloat16()
    kw = dict(causal=causal, window=None, meta_len=0)
    o, lse = flash_attention_plain_lse(q.float(), k.float(), v.float(), **kw)
    o = o.bfloat16()
    args32 = [x.float() for x in (q, k, v, o, do)] + [lse]
    oracle = flash_attention_bwd_plain(*args32, **kw)
    got = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    floors = flash_bwd_row_floors(q, k, v, o, do, lse, **kw)
    reorder_only = flash_bwd_row_floors(*args32, **kw)
    assert torch.equal(floors[1], reorder_only[1])
    assert torch.equal(floors[2], reorder_only[2])
    if common:
        assert _row_check_ratio(got[0], oracle[0], reorder_only[0]) > tol
    out = smoke.check_flash_bwd(q, k, v, o, do, lse, got, kw, "cpu")
    assert out["row_err_over_row_max"] <= tol
    assert len(out["planted_faults"]) == 6
    assert all(f["row"] > tol for f in out["planted_faults"].values())
