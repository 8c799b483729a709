"""The split-TF32 ("3xTF32") arithmetic of the hand BSR kernel, emulated
in plain torch on the CPU, against an fp64 product.

``csrc/bsr_spmm.cu`` rounds each operand to TF32 with ``cvt.rna`` (10
mantissa bits, to nearest, ties away from zero), keeps the rounding
residue as a second TF32 number, and sums a_hi b_hi + a_hi b_lo + a_lo b_hi
in fp32 on the tensor cores. ``chip_smoke.py`` holds every BSR launch to
``kernels.bsr_spmm.split_tf32_bound``; here the same bound is checked
against the emulated arithmetic on a small ogbn-proteins-shaped graph
(GCN-normalised R-MAT adjacency, 128 x 128 tiles) before the card sees
it, and shown to be tight enough to reject a single TF32 pass."""
import numpy as np
import pytest
import torch

from repro_torch.core import sparse as tsp
from repro_torch.data import make_dataset
from repro_torch.kernels.bsr_spmm import split_tf32_bound


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero (``cvt.rna``):
    add half a TF32 ulp to the magnitude bits and clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def emulate(a: tsp.BSR, h: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The kernel's arithmetic: per block row, per tile, 8 tile columns at
    a time (one wgmma k-step), the three split products added to an fp32
    accumulator; ``passes = 1`` keeps a_hi b_hi only (plain TF32)."""
    k = h.shape[1]
    hp = torch.zeros((a.ncols, k), dtype=torch.float32)
    hp[: h.shape[0]] = h
    out = torch.zeros((a.nrows, k), dtype=torch.float32)
    for b in range(a.nblocks):
        r, c = int(a.blk_row[b]), int(a.blk_col[b])
        a_hi, a_lo = split(a.blocks[b])
        h_hi, h_lo = split(hp[c * a.bc:(c + 1) * a.bc])
        acc = out[r * a.br:(r + 1) * a.br]
        for j in range(0, a.bc, 8):
            terms = [a_hi[:, j:j + 8] @ h_hi[j:j + 8]]
            if passes == 3:
                terms = [a_lo[:, j:j + 8] @ h_hi[j:j + 8],
                         a_hi[:, j:j + 8] @ h_lo[j:j + 8]] + terms
            for t in terms:
                acc += t
    return out


@pytest.fixture(scope="module")
def proteins_bsr():
    ds = make_dataset("ogbn-proteins", scale=1 / 256, seed=0)
    return tsp.bsr_from_coo(tsp.gcn_normalize(ds.coo), br=128, bc=128)


def _exact_and_bound(a: tsp.BSR, h: torch.Tensor):
    """fp64 product, Σ|a_ij h_j| and each row's real terms d."""
    blocks = a.blocks.double()
    hp = torch.zeros((a.ncols, h.shape[1]), dtype=torch.float64)
    hp[: h.shape[0]] = h.double()
    exact = torch.zeros((a.nrows, h.shape[1]), dtype=torch.float64)
    mag = torch.zeros_like(exact)
    d = torch.zeros(a.nrows, dtype=torch.float64)
    for b in range(a.nblocks):
        r, c = int(a.blk_row[b]), int(a.blk_col[b])
        rows = slice(r * a.br, (r + 1) * a.br)
        hb = hp[c * a.bc:(c + 1) * a.bc]
        exact[rows] += blocks[b] @ hb
        mag[rows] += blocks[b].abs() @ hb.abs()
        d[rows] += (blocks[b] != 0).sum(1).double()
    return exact, split_tf32_bound(d[:, None], mag) + 1e-300


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                    # TF32 spacing on [1, 2)
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-39, 0.0], dtype=torch.float32)
    want = [one, one + ulp, -(one + ulp), one, one + ulp, None, 0.0]
    got = tf32_rna(x)
    for g, w in zip(got.tolist(), want):
        if w is not None:
            assert g == w
    # a subnormal keeps its 10 leading fraction bits
    assert int(got[5:6].view(torch.int32)) & 0x1FFF == 0
    # x = hi + lo leaves at most 2^-22 |x|
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split(v)
    assert (((v.double() - hi.double() - lo.double()).abs())
            <= 2.0 ** -22 * v.double().abs()).all()


@pytest.mark.parametrize("k", [1, 112, 256])
def test_split_tf32_within_the_stated_bound(proteins_bsr, k):
    rng = np.random.default_rng(k)
    a = proteins_bsr
    h = torch.from_numpy(rng.standard_normal((a.ncols - 11, k))
                         .astype(np.float32))
    exact, bound = _exact_and_bound(a, h)
    got = emulate(a, h).double()
    ratio = float(((got - exact).abs() / bound).max())
    assert ratio <= 1.0, ratio
    # one TF32 pass (2^-11 a product) breaks the same bound
    one = emulate(a, h, passes=1).double()
    assert float(((one - exact).abs() / bound).max()) > 1.0
