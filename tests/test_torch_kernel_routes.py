"""What the hand kernels of the ragged GEMM and the scaled block SDDMM
decide and compute, checked on the CPU.

- The ragged GEMM's instance (``kernels.ragged_gemm.ragged_instance``)
  is a function of dtype, shape and alignment alone: the ``wgmma``
  instance takes bf16 operands that TMA can stride (D and F multiples of
  8, 16-byte aligned), and every MoE configuration's expert products land
  on it.
- The scaled SDDMM kernel (``csrc/sddmm.cu``, ``sddmm_nnz_kernel``) is
  emulated in plain torch: per 32-row slice of a tile, a dense slice
  (more than 1 / ``DENSE_DIV`` of its positions nonzero) takes the tile
  products (one fma chain over D in order), any other slice one dot
  product per nonzero in the kernel's order (an 8-lane group a nonzero:
  lane t sums d = 32 c + 4 t + e, e = 0..3, with fma, then a butterfly
  over 4, 2, 1). The emulation is
  held against the plain version and the reference's Pallas kernel
  (interpret mode) within 2 (D + 1) eps Σ_d |x_i,d y_j,d| |a_ij|, the
  bound ``chip_smoke.py`` holds the kernel to on the card. fma is
  emulated as an fp64 product and sum rounded once to fp32 (exact but for
  rare double roundings, far inside the bound)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
from repro.kernels import ops as jops

from repro_torch.configs import get_config
from repro_torch.configs.registry import arch_names
from repro_torch.core import sparse as tsp
from repro_torch.kernels.ragged_gemm import INSTANCES, ragged_instance
from repro_torch.kernels.sddmm import DENSE_DIV, SLICE_ROWS, sddmm_bsr_plain

EPS32 = 2.0 ** -24
BF16, F32 = torch.bfloat16, torch.float32


# --------------------------------------------------------------------------
# the ragged GEMM's instance
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,f,x_ptr,w_ptr,want", [
    (BF16, 4096, 6400, 0, 4096, "wgmma"),    # phi3.5-moe gate / up
    (BF16, 6400, 4096, 256, 0, "wgmma"),     # ... down
    (BF16, 256, 6408, 0, 0, "wgmma"),        # F past a whole 256 tile
    (BF16, 100, 72, 0, 0, "wmma"),           # D % 8 != 0
    (BF16, 96, 20, 0, 0, "wmma"),            # F % 8 != 0
    (BF16, 4096, 6400, 2, 0, "wmma"),        # x not 16-byte aligned
    (BF16, 4096, 6400, 0, 8, "wmma"),        # w not 16-byte aligned
    (F32, 4096, 6400, 0, 0, "f32"),
    (F32, 100, 72, 4, 4, "f32")])
def test_ragged_instance_is_a_function_of_dtype_shape_alignment(
        dtype, d, f, x_ptr, w_ptr, want):
    assert ragged_instance(dtype, d, f, x_ptr, w_ptr) == want
    assert want in INSTANCES


def test_ragged_instance_rejects_other_dtypes():
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ragged_instance(torch.float16, 64, 64, 0, 0)


@pytest.mark.parametrize("arch", [a for a in arch_names()
                                  if get_config(a).n_experts])
def test_moe_expert_products_take_the_wgmma_instance(arch):
    """moe_mlp's three products, (E, D, F) for gate and up and (E, F, D)
    for down, on freshly allocated bf16 buffers (16-byte aligned)."""
    cfg = get_config(arch)
    x = torch.empty((128, cfg.d_model), dtype=BF16)
    w = torch.empty((1, 8, 8), dtype=BF16)
    for d, f in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
        assert ragged_instance(BF16, d, f, x.data_ptr(),
                               w.data_ptr()) == "wgmma"


# --------------------------------------------------------------------------
# the scaled SDDMM kernel's arithmetic, emulated
# --------------------------------------------------------------------------

def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def butterfly(p: torch.Tensor) -> torch.Tensor:
    """An 8-lane group's xor-shuffle sum over the last axis."""
    lanes = torch.arange(8)
    for o in (4, 2, 1):
        p = p + p[..., lanes ^ o]
    return p[..., 0]


def emulate_scaled(a: tsp.BSR, x: torch.Tensor, y: torch.Tensor,
                   routes: list | None = None) -> torch.Tensor:
    """``sddmm_nnz_kernel``'s output, slice by slice; ``routes`` collects
    True for each slice that took the dense tile products."""
    d = x.shape[1]
    dp = -(-d // 32) * 32
    xp = torch.zeros((a.nrows, dp))
    xp[: x.shape[0], :d] = x
    yp = torch.zeros((a.ncols, dp))
    yp[: y.shape[0], :d] = y
    out = torch.zeros((a.nblocks, a.br, a.bc))
    for b in range(a.nblocks):
        r, c = int(a.blk_row[b]), int(a.blk_col[b])
        ys = yp[c * a.bc:(c + 1) * a.bc]
        for r0 in range(0, a.br, SLICE_ROWS):
            tile = a.blocks[b, r0:r0 + SLICE_ROWS]
            xs = xp[r * a.br + r0:r * a.br + r0 + SLICE_ROWS]
            nz = tile != 0
            dense = int(nz.sum()) * DENSE_DIV > SLICE_ROWS * a.bc
            if routes is not None:
                routes.append(dense)
            if dense:
                s = torch.zeros((SLICE_ROWS, a.bc))
                for k in range(dp):
                    s = fma(xs[:, k:k + 1], ys[None, :, k], s)
                out[b, r0:r0 + SLICE_ROWS] = torch.where(nz, s * tile, 0.0)
                continue
            rows, cols = nz.nonzero(as_tuple=True)
            # (entry, c, lane t, e): element 32 c + 4 t + e
            xv = xs[rows].view(-1, dp // 32, 8, 4)
            yv = ys[cols].view(-1, dp // 32, 8, 4)
            p = torch.zeros((rows.numel(), 8))
            for c in range(dp // 32):
                for e in range(4):
                    p = fma(xv[:, c, :, e], yv[:, c, :, e], p)
            out[b, r0 + rows, cols] = tile[rows, cols] * butterfly(p)
    return out


def exact_and_bound(a: tsp.BSR, x: torch.Tensor, y: torch.Tensor):
    """fp64 scores times A, and 2 (D + 1) eps Σ_d |x y| |a| per position."""
    d = x.shape[1]
    xp = torch.zeros((a.nrows, d), dtype=torch.float64)
    xp[: x.shape[0]] = x.double()
    yp = torch.zeros((a.ncols, d), dtype=torch.float64)
    yp[: y.shape[0]] = y.double()
    rows = a.blk_row.long()[:, None] * a.br + torch.arange(a.br)
    cols = a.blk_col.long()[:, None] * a.bc + torch.arange(a.bc)
    xs, ys = xp[rows], yp[cols]
    blocks = a.blocks.double()
    exact = torch.bmm(xs, ys.transpose(1, 2)) * blocks
    mag = torch.bmm(xs.abs(), ys.abs().transpose(1, 2)) * blocks.abs()
    return exact, 2 * (d + 1) * EPS32 * mag + 1e-300


@pytest.fixture(scope="module")
def proteins_bsr():
    """128 x 128 tiles at the 0.69 % fill of A in chip_smoke.py phase 9
    (ogbn-proteins at scale 1/4): a 384 x 640 matrix, 3 x 5 tiles, and
    two padding blocks."""
    rng = np.random.default_rng(0)
    n, m = 384, 640
    lin = rng.choice(n * m, size=round(0.0069 * n * m), replace=False)
    coo = tsp.coo_from_edges(lin % m, lin // m, rng.standard_normal(
        lin.size).astype(np.float32), n, m)
    nb = tsp.bsr_from_coo(coo, br=128, bc=128).nblocks
    return tsp.bsr_from_coo(coo, br=128, bc=128, pad_blocks_to=nb + 2)


@pytest.mark.parametrize("d", [1, 130, 256])
def test_scaled_sddmm_emulation_within_the_stated_bound(proteins_bsr, d):
    """On ogbn-proteins-shaped tiles (every slice sparse, the per-nonzero
    route), against fp64 and against the plain version; x and y a few
    rows short of the padded rows and columns."""
    a = proteins_bsr
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((a.nrows - 9, d))
                         .astype(np.float32)) / d ** 0.5
    y = torch.from_numpy(rng.standard_normal((a.ncols - 5, d))
                         .astype(np.float32))
    routes: list = []
    got = emulate_scaled(a, x, y, routes)
    assert not any(routes)
    exact, bound = exact_and_bound(a, x, y)
    assert float(((got.double() - exact).abs() / bound).max()) <= 1.0
    plain = sddmm_bsr_plain(a, x, y, scale_by_a=True)
    assert bool(((got - plain).abs().double() <= bound).all())
    assert bool((got[a.blocks == 0] == 0).all())


def _fill_tiles(rng, fills, br=128, bc=128):
    """One block row, one tile a fill fraction; rows 300.. of x absent."""
    n = len(fills)
    blocks = np.zeros((n, br, bc), np.float32)
    for b, fill in enumerate(fills):
        mask = rng.random((br, bc)) < fill
        blocks[b][mask] = rng.standard_normal(int(mask.sum()))
    return tsp.BSR(blk_row=torch.zeros(n, dtype=torch.int32),
                   blk_col=torch.arange(n, dtype=torch.int32),
                   blocks=torch.from_numpy(blocks), nrows=br, ncols=n * bc,
                   br=br, bc=bc, n_real_blocks=n)


@pytest.mark.parametrize("bc", [128, 256])
def test_scaled_sddmm_routes_dense_slices_and_stays_in_bound(bc):
    """Tiles at 0.7 %, 5 %, 50 % and 100 % fill: the sparse ones take the
    per-nonzero route, the dense ones the tile products, and both stay
    within the bound; where A is 0 the output is exactly 0."""
    rng = np.random.default_rng(bc)
    a = _fill_tiles(rng, (0.007, 0.05, 0.5, 1.0), bc=bc)
    d = 40
    x = torch.from_numpy(rng.standard_normal((100, d)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((a.ncols - 3, d))
                         .astype(np.float32))
    routes: list = []
    got = emulate_scaled(a, x, y, routes)
    per_tile = np.array(routes).reshape(a.nblocks, -1)
    assert per_tile.tolist() == [[False] * 4, [False] * 4, [True] * 4,
                                 [True] * 4]
    exact, bound = exact_and_bound(a, x, y)
    assert float(((got.double() - exact).abs() / bound).max()) <= 1.0
    assert bool((got[a.blocks == 0] == 0).all())


def test_scaled_sddmm_emulation_writes_zero_where_a_is_zero():
    """A non-finite score: where A is 0 the kernel writes 0, the plain
    version s * 0 = NaN; where A is not 0 both are non-finite."""
    rng = np.random.default_rng(0)
    a = _fill_tiles(rng, (0.01,))
    a.blocks[0, 7, 5] = 2.0
    x = torch.ones((128, 8))
    y = torch.ones((128, 8))
    y[5] = torch.inf
    got = emulate_scaled(a, x, y)
    plain = sddmm_bsr_plain(a, x, y, scale_by_a=True)
    zero = a.blocks[0, :, 5] == 0
    assert bool(zero.any()) and bool(torch.isnan(plain[0, :, 5][zero]).all())
    assert bool((got[0, :, 5][zero] == 0).all())
    assert bool(torch.isinf(got[0, :, 5][~zero]).all())
    finite = torch.isfinite(plain)
    assert torch.equal(got[finite], plain[finite])


def test_scaled_sddmm_emulation_matches_pallas_interpret():
    """The emulated kernel against the reference's Pallas SDDMM in
    interpret mode on the same graph and operands (x, y short of the
    padded BSR; padding blocks)."""
    rng = np.random.default_rng(3)
    n, m, nnz = 300, 280, 2000
    lin = rng.choice(n * m, size=nnz, replace=False)
    dst, src = lin // m, lin % m
    val = rng.standard_normal(nnz).astype(np.float32)
    ref = C.coo_from_edges(src, dst, val, n, m)
    nb = C.bsr_from_coo(ref, br=32, bc=128).nblocks + 3
    want_bsr = C.bsr_from_coo(ref, br=32, bc=128, pad_blocks_to=nb)
    a = tsp.bsr_from_coo(tsp.coo_from_edges(src, dst, val, n, m), br=32,
                         bc=128, pad_blocks_to=nb)
    d = 64
    x = rng.standard_normal((n, d)).astype(np.float32) / 8
    y = rng.standard_normal((m, d)).astype(np.float32)
    want = np.asarray(jops.sddmm_bsr(want_bsr, jnp.asarray(x),
                                     jnp.asarray(y), scale_by_a=True,
                                     interpret=True))
    got = emulate_scaled(a, torch.from_numpy(x), torch.from_numpy(y))
    _, bound = exact_and_bound(a, torch.from_numpy(x), torch.from_numpy(y))
    assert float((np.abs(got.numpy() - want) / bound.numpy()).max()) <= 1.0
