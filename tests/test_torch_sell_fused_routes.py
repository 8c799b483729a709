"""What the hand kernels of SELL SpMM and FusedMM decide and compute,
checked on the CPU.

- SELL (``csrc/sell_spmm.cu``): the chunk schedule the kernel derives
  from the slice pointers (``kernels.sell_spmm.sell_schedule``) covers
  every packed step of every slice exactly once, in order, in pieces of
  at most S steps, and gives every partial row its own workspace slot and
  every long slice one reducer; the route is a function of the step
  count alone. The kernel's sums are emulated in plain torch (a piece's
  slots in order with fma, then the pieces' partial rows in chunk order)
  on a reddit-shaped degree sequence at small size and held against the
  plain version and the reference's Pallas kernel (interpret mode) within
  2 d eps sum|terms|, d the row's real slots: the per-row bound
  ``chip_smoke.py`` holds the kernel to on the card. fma is emulated as an
  fp64 product and sum rounded once to fp32.
- FusedMM (``csrc/fusedmm.cu``): the per-tile route is a function of a
  32-row slice's nonzero count; the kernel's walk is emulated (a warp's
  four rows, its nonzeros in (row, vector, component, lane) order, taken
  ``fused_batch`` at a time across tiles, online softmax with one rescale
  a batch, dense slices through the tile products) and held against the
  plain version and the reference's Pallas kernel in interpret mode
  within atol 1e-4 x max|h| (softmax) or 1e-4 x max|plain| (sigmoid,
  none): ``chip_smoke.py``'s ``check_fused``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
from repro.kernels import ops as jops

from repro_torch.core import sparse as tsp
from repro_torch.kernels.fusedmm import (FUSED_DENSE_DIV, K_CHUNK,
                                         fused_batch, fused_tile_route,
                                         fusedmm_bsr_plain)
from repro_torch.kernels.sddmm import SLICE_ROWS
from repro_torch.kernels.sell_spmm import (CHUNK_STEPS, sell_route,
                                           sell_schedule, sell_spmm_plain,
                                           sell_windows,
                                           sell_workspace_bytes,
                                           slice_pointers)
from repro_torch.sampling.blocks import _pad_sell_steps

EPS32 = 2.0 ** -24


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


# --------------------------------------------------------------------------
# SELL: the chunk schedule
# --------------------------------------------------------------------------

def reddit_degrees(n: int, rng) -> np.ndarray:
    """reddit's shape at small size: one hub row, seven rows at about
    half of it, a power-law tail, some rows empty."""
    deg = (3 * np.sqrt(n / np.arange(1, n + 1))).astype(np.int64)
    deg[0], deg[1:8] = n, n // 2
    deg[-n // 20:] = 0
    return rng.permutation(deg)


def degree_coo(deg: np.ndarray, m: int, rng):
    """(reference COO, port COO, dense) with the given row degrees."""
    rows = np.repeat(np.arange(deg.size), deg)
    cols = np.concatenate([rng.choice(m, d, replace=False) for d in deg])
    val = rng.standard_normal(rows.size).astype(np.float32)
    dense = np.zeros((deg.size, m), np.float32)
    dense[rows, cols] = val
    return (C.coo_from_edges(cols, rows, val, deg.size, m),
            tsp.coo_from_edges(cols, rows, val, deg.size, m), dense)


def reducers(pieces, ptr, chunk: int, nwin: int) -> dict:
    """{slice: the workspace slots its reducer sums, in order}, found as
    ``sell_spmm_kernel_reduce`` finds them: the window item whose piece
    ends its slice sums the first chunk's slot, then every later chunk's
    window slot."""
    out: dict = {}
    for item, s, t0, t1, _ in pieces:
        if item >= nwin or t1 < ptr[s + 1]:
            continue
        assert s not in out
        p0 = ptr[s]
        out[s] = [2 * (p0 // chunk) + 1] + [
            2 * (t // chunk) for t in range(p0 + chunk, t0 + 1, chunk)]
    return out


@pytest.mark.parametrize("chunk", [1, 7, 64, 100, CHUNK_STEPS])
@pytest.mark.parametrize("c", [8, 16, 32])
def test_sell_schedule_covers_every_step_once_in_order(chunk, c):
    """Reddit-shaped degrees, slices of exactly 2 S and S + 1 steps, and
    sentinel steps padded onto the last slice."""
    rng = np.random.default_rng(chunk + c)
    deg = reddit_degrees(400, rng)
    deg[10:10 + c] = 2 * chunk if chunk < 200 else 3
    deg[40:40 + c] = chunk + 1 if chunk < 200 else 2
    _, coo, _ = degree_coo(deg, 512, rng)
    a = tsp.sell_from_coo(coo, c=c)
    a = _pad_sell_steps(a, a.n_steps + 29)
    ptr = [int(v) for v in slice_pointers(a)]
    pieces = sell_schedule(slice_pointers(a), a.slice_of, chunk)
    assert sell_route(a.n_steps, chunk) == (
        "row" if a.n_steps <= chunk else "split")
    nwin = sell_windows(a.n_steps, chunk)
    assert sell_workspace_bytes(a.n_steps, c, 10, chunk) == 2 * nwin * c * 40
    assert sorted(p[0] for p in pieces) == [p[0] for p in pieces]
    by_slice: dict = {}
    for item, s, t0, t1, slot in pieces:
        assert 0 < t1 - t0 <= chunk or ptr[s] == ptr[s + 1]
        by_slice.setdefault(s, []).append((t0, t1, slot))
    slots = []
    for s in range(a.nslices):
        got = sorted(by_slice[s])
        # every step once, in order, pieces of at most S steps
        assert got[0][0] == ptr[s] and got[-1][1] == ptr[s + 1]
        assert all(x[1] == y[0] for x, y in zip(got, got[1:]))
        long_ = ptr[s + 1] - ptr[s] > chunk
        assert len(got) == (-(-(ptr[s + 1] - ptr[s]) // chunk) if long_
                            else 1)
        # a short slice stores straight to its rows, a long one's pieces
        # each own a workspace slot
        assert all((slot >= 0) == long_ for _, _, slot in got)
        slots += [slot for _, _, slot in got if slot >= 0]
    assert len(slots) == len(set(slots)) and all(
        0 <= v < 2 * nwin for v in slots)
    # one reducer per long slice, summing exactly its pieces' slots in
    # chunk order
    red = reducers(pieces, ptr, chunk, nwin)
    long_slices = [s for s in range(a.nslices)
                   if ptr[s + 1] - ptr[s] > chunk]
    assert sorted(red) == long_slices
    for s in long_slices:
        assert red[s] == [slot for _, _, slot in sorted(by_slice[s])]
    if chunk < 200:
        assert long_slices


def emulate_sell(a: tsp.SELL, h: torch.Tensor, chunk: int) -> torch.Tensor:
    """``sell_spmm_kernel`` and ``sell_spmm_kernel_reduce``: each piece's
    slots in order with fma from zero, then a long slice's partial rows
    summed in chunk order; rows stored at ``perm``."""
    ptr = slice_pointers(a)
    ws: dict = {}
    out = torch.zeros((a.nrows, h.shape[1]))
    idx, val = a.idx.long(), a.val.float()
    for _, s, t0, t1, slot in sell_schedule(ptr, a.slice_of, chunk):
        part = torch.zeros((a.c, h.shape[1]))
        for t in range(t0, t1):
            real = idx[t] < a.ncols
            if bool(real.any()):
                rows = torch.nonzero(real).flatten()
                part[rows] = fma(val[t, rows, None], h[idx[t, rows]],
                                 part[rows])
        if slot < 0:
            ws[(s, 0)] = part
        else:
            ws[(s, t0)] = part
    for s in range(a.nslices):
        starts = sorted(t for (q, t) in ws if q == s)
        acc = ws[(s, starts[0])]
        for t in starts[1:]:
            acc = acc + ws[(s, t)]
        dst = a.perm[s * a.c:(s + 1) * a.c].long()
        keep = dst < a.nrows
        out[dst[keep]] = acc[keep]
    return out


def sell_bound(a: tsp.SELL, h: torch.Tensor) -> torch.Tensor:
    """2 d eps sum|terms| per element, d the row's real slots."""
    import dataclasses
    mag = sell_spmm_plain(dataclasses.replace(a, val=a.val.abs()), h.abs())
    real = (a.idx < a.ncols).to(torch.int32)
    per = torch.zeros((a.nslices, a.c), dtype=torch.int32)
    per.index_add_(0, a.slice_of.long(), real)
    d = per.reshape(-1)[a.inv_perm.long()].float()[:, None]
    return 2 * EPS32 * d * mag + 1e-30


@pytest.mark.parametrize("c,chunk", [(8, 16), (16, 40), (32, 7)])
def test_sell_emulated_sum_order_within_the_row_bound(c, chunk):
    """The split route's sum order on reddit-shaped rows, against the
    plain version, and, with padding steps, with K = 602."""
    rng = np.random.default_rng(c)
    _, coo, _ = degree_coo(reddit_degrees(160, rng), 300, rng)
    a = tsp.sell_from_coo(coo, c=c)
    a = _pad_sell_steps(a, a.n_steps + 2 * chunk + 3)
    assert sell_route(a.n_steps, chunk) == "split"
    for k in (24, 602):
        h = torch.from_numpy(rng.standard_normal((300, k))
                             .astype(np.float32))
        got = emulate_sell(a, h, chunk)
        bound = sell_bound(a, h)
        assert bool(((got - sell_spmm_plain(a, h)).abs() <= bound).all())


def test_sell_emulation_matches_pallas_interpret():
    """The emulated split route against the reference's Pallas SELL
    kernel in interpret mode, on the same reddit-shaped graph, C = 8."""
    rng = np.random.default_rng(5)
    ref, coo, dense = degree_coo(reddit_degrees(96, rng), 128, rng)
    a = tsp.sell_from_coo(coo, c=8)
    h = rng.standard_normal((128, 16)).astype(np.float32)
    got = emulate_sell(a, torch.from_numpy(h), chunk=12)
    want = np.asarray(jops.sell_spmm(C.sell_from_coo(ref, c=8), h,
                                     interpret=True))
    bound = sell_bound(a, torch.from_numpy(h)).numpy()
    assert float((np.abs(got.numpy() - want) / bound).max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), dense @ h, atol=1e-4, rtol=1e-5)


# --------------------------------------------------------------------------
# FusedMM: the route and the per-edge walk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nnz,bc,want", [
    (0, 128, "edge"), (28, 128, "edge"),            # 0.7 % of a slice
    (SLICE_ROWS * 128 // FUSED_DENSE_DIV, 128, "edge"),
    (SLICE_ROWS * 128 // FUSED_DENSE_DIV + 1, 128, "tile"),
    (SLICE_ROWS * 256 // FUSED_DENSE_DIV, 256, "edge"),
    (SLICE_ROWS * 256 // FUSED_DENSE_DIV + 1, 256, "tile"),
    (SLICE_ROWS * 128 // 2, 128, "tile"), (SLICE_ROWS * 256, 256, "tile")])
def test_fused_tile_route_is_a_function_of_the_count(nnz, bc, want):
    assert fused_tile_route(nnz, bc) == want


@pytest.mark.parametrize("kw,want", [(1, 4), (128, 4), (256, 4), (257, 2),
                                     (384, 2), (512, 2)])
def test_fused_batch_follows_the_launch_width(kw, want):
    assert fused_batch(kw) == want


def emulate_fused(a: tsp.BSR, x, y, h, edge_op: str, routes=None):
    """``fusedmm_edge_kernel``'s walk, warp by warp (fp32; scores as
    plain dot products). ``routes`` collects each slice-tile's route."""
    k = h.shape[1]
    assert k <= K_CHUNK
    u_max, v_per = fused_batch(k), a.bc // 128
    d = x.shape[1]
    xp = torch.zeros((a.nrows, d))
    xp[: x.shape[0]] = x
    yp = torch.zeros((a.ncols, d))
    yp[: y.shape[0]] = y
    hp = torch.zeros((a.ncols, k))
    hp[: h.shape[0]] = h
    out = torch.zeros((a.nrows, k))
    ptr = torch.searchsorted(a.blk_row, torch.arange(a.n_block_rows + 1,
                                                     dtype=torch.int32))
    softmax = edge_op == "softmax"

    def weight(s, m):
        return (torch.exp(s - m) if softmax else
                torch.sigmoid(s) if edge_op == "sigmoid" else s)

    for rb in range(a.n_block_rows):
        tiles = range(int(ptr[rb]), int(ptr[rb + 1]))
        for sl in range(a.br // SLICE_ROWS):
            row0 = rb * a.br + sl * SLICE_ROWS
            masks = [a.blocks[b, sl * SLICE_ROWS:(sl + 1) * SLICE_ROWS] != 0
                     for b in tiles]
            dense = [fused_tile_route(int(mk.sum()), a.bc) == "tile"
                     for mk in masks]
            if routes is not None:
                routes += dense
            for w in range(SLICE_ROWS // 4):
                rows = row0 + 4 * w + torch.arange(4)
                m = torch.full((4,), -1e30)
                z = torch.zeros(4)
                acc = torch.zeros((4, k))
                pend: list = []

                def flush():
                    s = [float(xp[rows[r]] @ yp[j]) for j, r in pend]
                    for r in range(4):
                        mine = [u for u, (_, q) in enumerate(pend) if q == r]
                        if softmax:
                            m_new = max([float(m[r])] + [s[u] for u in mine])
                            if m_new > m[r]:
                                alpha = torch.exp(m[r] - m_new)
                                z[r] *= alpha
                                acc[r] *= alpha
                                m[r] = m_new
                        for u in mine:
                            p = weight(torch.tensor(s[u]), m[r])
                            if softmax:
                                z[r] += p
                            acc[r] += p * hp[pend[u][0]]
                    pend.clear()

                for ti, b in enumerate(tiles):
                    mk = masks[ti][4 * w: 4 * w + 4]
                    col0 = int(a.blk_col[b]) * a.bc
                    if dense[ti]:
                        s = xp[rows] @ yp[col0:col0 + a.bc].T
                        if softmax:
                            tmax = torch.where(mk, s, -1e30).max(1).values
                            m_new = torch.maximum(m, tmax)
                            alpha = torch.exp(m - m_new)
                            p = torch.where(mk, torch.exp(s - m_new[:, None]),
                                            0.0)
                            z = z * alpha + p.sum(1)
                            acc = acc * alpha[:, None]
                            m = m_new
                        else:
                            p = torch.where(mk, weight(s, 0.0), 0.0)
                        acc = acc + p @ hp[col0:col0 + a.bc]
                        continue
                    for r in range(4):
                        for v in range(v_per):
                            for e in range(4):
                                for lane in range(32):
                                    col = 128 * v + 4 * lane + e
                                    if bool(mk[r, col]):
                                        pend.append((col0 + col, r))
                                        if len(pend) == u_max:
                                            flush()
                if pend:
                    flush()
                out[rows] = acc / z.clamp_min(1e-30)[:, None] if softmax \
                    else acc
    return out


def fused_case(rng, br: int, bc: int):
    """A 300 x 280 graph whose rows 100..227 are empty (block rows of only
    their zero tile at br = 32), one 50 % and one full tile in rows
    0..31 (the tile route), two padding blocks, both packages' BSR."""
    n, m = 300, 280
    lin = rng.choice(n * m, size=1500, replace=False)
    dst, src = lin // m, lin % m
    keep = (dst < 100) | (dst >= 228)
    dst, src = dst[keep], src[keep]
    dense_cols = np.arange(m)[(np.arange(m) // bc) == 0]
    half = rng.random((32, dense_cols.size)) < 0.5
    full_r = np.repeat(np.arange(32), dense_cols.size)
    dst = np.concatenate([dst, full_r[half.reshape(-1)]])
    src = np.concatenate([src, np.tile(dense_cols, 32)[half.reshape(-1)]])
    if bc == 128 and m > 128:
        fr, fc = np.meshgrid(np.arange(32, 64), np.arange(128, 256),
                             indexing="ij")
        dst = np.concatenate([dst, fr.reshape(-1)])
        src = np.concatenate([src, fc.reshape(-1)])
    key = np.unique(dst * m + src)
    dst, src = key // m, key % m
    val = rng.standard_normal(key.size).astype(np.float32)
    ref = C.coo_from_edges(src, dst, val, n, m)
    nb = C.bsr_from_coo(ref, br=br, bc=bc).nblocks + 2
    return (C.bsr_from_coo(ref, br=br, bc=bc, pad_blocks_to=nb),
            tsp.bsr_from_coo(tsp.coo_from_edges(src, dst, val, n, m), br=br,
                             bc=bc, pad_blocks_to=nb))


def fused_atol(edge_op, h, want) -> float:
    return 1e-4 * float((h if edge_op == "softmax" else want).abs().max())


@pytest.mark.parametrize("edge_op", ["softmax", "sigmoid", "none"])
@pytest.mark.parametrize("br,bc,k", [(32, 128, 48), (128, 128, 300),
                                     (128, 256, 130)])
def test_fused_edge_emulation_matches_plain(edge_op, br, bc, k):
    """Both routes in one walk (the dense tiles of rows 0..63), empty
    block rows, padding blocks, x and y short of the operand: against
    the plain version; the empty rows store 0."""
    rng = np.random.default_rng(br + bc + k)
    _, a = fused_case(rng, br, bc)
    d = 40
    x = torch.from_numpy(rng.standard_normal((290, d)).astype(np.float32))
    x /= d ** 0.5
    y = torch.from_numpy(rng.standard_normal((270, d)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((270, k)).astype(np.float32))
    routes: list = []
    got = emulate_fused(a, x, y, h, edge_op, routes)
    assert any(routes) and not all(routes)
    want = fusedmm_bsr_plain(a, x, y, h, edge_op=edge_op)
    assert float((got - want).abs().max()) <= fused_atol(edge_op, h, want)
    assert bool((got[100:128] == 0).all()) and bool((got[300:] == 0).all())


@pytest.mark.parametrize("edge_op", ["softmax", "sigmoid", "none"])
def test_fused_edge_emulation_matches_pallas_interpret(edge_op):
    """The emulated kernel against the reference's Pallas FusedMM in
    interpret mode on the same graph and operands (32 x 128 tiles)."""
    rng = np.random.default_rng(11)
    want_bsr, a = fused_case(rng, 32, 128)
    x = rng.standard_normal((300, 24)).astype(np.float32) / 5
    y = rng.standard_normal((280, 24)).astype(np.float32)
    h = rng.standard_normal((280, 20)).astype(np.float32)
    want = np.asarray(jops.fusedmm_bsr(
        want_bsr, jnp.asarray(x), jnp.asarray(y), jnp.asarray(h),
        edge_op=edge_op, interpret=True))
    got = emulate_fused(a, torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(h), edge_op).numpy()
    atol = 1e-4 * float(np.abs(h if edge_op == "softmax" else want).max())
    assert float(np.abs(got[:300] - want[:300]).max()) <= atol
