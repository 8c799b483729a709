"""The port's distributed GNN message passing (``repro_torch.dist.gnn``,
``gnn2d``, the tensor collectives of ``dist.collectives`` and
``kernels.ref.edge_weights(mesh=, axis=)``) against the JAX reference,
on the CPU.

- Host layouts, bitwise the reference's: ``build_dist_graph`` (ELL,
  SELL, an empty trailing band, a ``CachedGraph`` input),
  ``partition_2d`` (ELL, SELL, rectangular, empty tiles, the plan of a
  ``CachedGraph``), ``comm_volume`` / ``comm_volume_2d``,
  ``scores_to_dense`` and the grid's factorisations.
- Operations: one run of four gloo CPU ranks (``dist.run_ranks``, one
  compute thread a rank) does every case: the 1-D SpMM on 4 bands (ELL
  and SELL, sum and mean, the gradient in H), the 2 x 2 SpMM (ELL and
  SELL, sum and mean, compressed), SDDMM, FusedMM with all three edge
  ops and its gradients in x, y and h (ELL and SELL tiles), and the
  ring. They are held against the reference's ``shard_map`` run on 4
  forced CPU devices, every case in one subprocess (as
  ``test_multidevice.py`` runs it), with the reference's own tolerances:
  1e-4 on outputs, 1e-4 of the largest element on gradients, and the
  compressed wire within ``pc * amax / 127`` of the exact sum. The bytes
  a rank's collectives move equal ``comm_volume(_2d)`` x 4.
- One band and the 1 x 1 grid in this process, without a process group
  (the collectives are identities), against the reference on its one
  device."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coo_from_edges as jax_coo
from repro.core.autotune import KernelPlan as JPlan
from repro.core.cache import build_cached_graph as jax_cached
from repro.dist import gnn as jgnn
from repro.dist import gnn2d as jgnn2d
from repro.dist.mesh import make_grid_mesh as jax_grid_mesh

from repro_torch import dist as tdist
from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.cache import build_cached_graph

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120.0
N, K, NNZ = 64, 16, 500                   # the reference's SpMM cases
RN, RM, RD, RK, RNNZ = 48, 64, 8, 16, 400   # its rectangular attention case
PLANS = {"ell": None, "sell": ("sell", 8)}
EDGE_OPS = ("softmax", "sigmoid", "none")


@pytest.fixture(autouse=True)
def _one_compute_thread():
    """One intra-op thread a test (the ranks set their own): the suite
    runs beside other workers, whose idle OpenMP threads would contend
    with these many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jplan(p):
    return None if p is None else JPlan(kind=p[0], sell_c=p[1])


def _tplan(p):
    return None if p is None else KernelPlan(kind=p[0], sell_c=p[1])


def _edges(seed, n, m, nnz):
    rng = np.random.default_rng(seed)
    lin = rng.choice(n * m, size=nnz, replace=False)
    return (lin % m, lin // m, rng.standard_normal(nnz).astype(np.float32))


def _inputs() -> dict:
    rng = np.random.default_rng(1)
    src, dst, val = _edges(0, N, N, NNZ)
    rsrc, rdst, rval = _edges(2, RN, RM, RNNZ)
    f = (lambda *s: rng.standard_normal(s).astype(np.float32))
    return dict(src=src, dst=dst, val=val, h=f(N, K), rsrc=rsrc, rdst=rdst,
                rval=rval, x=f(RN, RD), y=f(RM, RD), rh=f(RM, RK),
                ring_a=f(32, 32), ring_h=f(32, K))


def _bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_layout(got, want, fields, what):
    for f in fields:
        gv, wv = getattr(got, f), getattr(want, f)
        if wv is None:
            assert gv is None, (what, f)
        elif isinstance(wv, (int, str)):
            assert gv == wv, (what, f, gv, wv)
        else:
            _bits(gv.numpy(), np.asarray(wv), f"{what}.{f}")


# --------------------------------------------------------------------------
# host layouts, bitwise
# --------------------------------------------------------------------------

_DIST_FIELDS = ("idx", "val", "inv_deg", "slice_of", "inv_perm", "nrows",
                "ncols", "parts", "rows_per_part", "kind", "sell_c")
_G2D_FIELDS = ("idx", "val", "inv_deg", "slice_of", "perm", "inv_perm",
               "nrows", "ncols", "pr", "pc", "rows_per_tile",
               "cols_per_tile", "kind", "sell_c")


@pytest.mark.parametrize("kind", ["ell", "sell"])
@pytest.mark.parametrize("n,parts", [(64, 4), (9, 4), (50, 3), (7, 1)])
def test_build_dist_graph_matches_reference_bitwise(kind, n, parts):
    """(9, 4): three bands of three rows and an empty trailing band."""
    src, dst, val = _edges(n, n, n, min(3 * n, n * n))
    got = tdist.build_dist_graph(tsp.coo_from_edges(src, dst, val, n, n),
                                 parts, plan=_tplan(PLANS[kind]))
    want = jgnn.build_dist_graph(jax_coo(src, dst, val, n, n), parts,
                                 plan=_jplan(PLANS[kind]))
    _same_layout(got, want, _DIST_FIELDS, f"dist {kind} {n}/{parts}")
    assert got.kind == kind
    assert tdist.comm_volume(got, K) == jgnn.comm_volume(want, K)


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_build_dist_graph_of_a_cached_graph_follows_its_plan(kind):
    src, dst, val = _edges(5, N, N, NNZ)
    tg = build_cached_graph(tsp.coo_from_edges(src, dst, val, N, N),
                            plan=_tplan(PLANS[kind]) or KernelPlan.trusted(),
                            device="cpu")
    jg = jax_cached(jax_coo(src, dst, val, N, N),
                    plan=_jplan(PLANS[kind]) or JPlan.trusted())
    got, want = tdist.build_dist_graph(tg, 4), jgnn.build_dist_graph(jg, 4)
    _same_layout(got, want, _DIST_FIELDS, f"cached {kind}")
    assert got.kind == kind


@pytest.mark.parametrize("kind", ["ell", "sell"])
@pytest.mark.parametrize("n,m,pr,pc", [
    (64, 64, 2, 2), (48, 64, 2, 2), (30, 70, 2, 3), (13, 9, 3, 1),
    (5, 40, 2, 2)])
def test_partition_2d_matches_reference_bitwise(kind, n, m, pr, pc):
    """Square, rectangular and 2 x 3 grids; (5, 40): row block 1 holds
    no edge (empty tiles); (13, 9) on 3 x 1."""
    src, dst, val = _edges(n + m, n, m, min(2 * n, n * m))
    if n == 5:                       # every edge in rows 0..2: tiles 2, 3 empty
        dst = dst % 3
        key = np.unique(dst * m + src, return_index=True)[1]
        src, dst, val = src[key], dst[key], val[key]
    got = tdist.partition_2d(tsp.coo_from_edges(src, dst, val, n, m), pr, pc,
                             plan=_tplan(PLANS[kind]))
    want = jgnn2d.partition_2d(jax_coo(src, dst, val, n, m), pr, pc,
                               plan=_jplan(PLANS[kind]))
    _same_layout(got, want, _G2D_FIELDS, f"2d {kind} {n}x{m} {pr}x{pc}")
    assert tdist.comm_volume_2d(got, K) == jgnn2d.comm_volume_2d(want, K)
    for trim in (True, False):
        _bits(tdist.scores_to_dense(got, got.val, trim=trim),
              jgnn2d.scores_to_dense(want, want.val, trim=trim),
              f"scores_to_dense trim={trim}")
    dense = np.zeros((n, m), np.float32)
    dense[dst, src] = val
    _bits(tdist.scores_to_dense(got, got.val), dense, "round trip")


def _same_piece(got, want):
    for f in ("idx", "val", "slice_of", "perm", "inv_perm"):
        if hasattr(want.op, f):
            _bits(getattr(got.op, f), getattr(want.op, f), f)
    assert (got.op.nrows, got.op.ncols, got.index) == (
        want.op.nrows, want.op.ncols, want.index)
    for f in ("inv_deg", "rows", "cols"):
        _bits(getattr(got, f), getattr(want, f), f)
    for order in ("row_order", "col_order"):
        for f in ("perm", "offsets", "src"):
            _bits(getattr(getattr(got, order), f),
                  getattr(getattr(want, order), f), f"{order}.{f}")


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_build_tile_and_build_band_are_the_stacked_pieces(kind):
    """One tile or band built alone equals the stacked partition's,
    field for field (an ELL piece as wide as the partition's widest),
    empty trailing bands included."""
    src, dst, val = _edges(8, RN, RM, RNNZ)
    a = tsp.coo_from_edges(src, dst, val, RN, RM)
    g = tdist.partition_2d(a, 2, 3, plan=_tplan(PLANS[kind]))
    for p in range(6):
        grid, got = tdist.build_tile(a, 2, 3, p, plan=_tplan(PLANS[kind]),
                                     device="cpu")
        assert grid == g.grid
        _same_piece(got, g.tile(p, "cpu"))
    for n, parts in ((RN, 4), (9, 4)):
        b = tsp.coo_from_edges(src % 9, dst % n, val, n, RM) if n == 9 \
            else a
        if n == 9:
            key = np.unique((dst % 9) * RM + src % 9, return_index=True)[1]
            b = tsp.coo_from_edges((src % 9)[key], (dst % 9)[key], val[key],
                                   9, RM)
        g1 = tdist.build_dist_graph(b, parts, plan=_tplan(PLANS[kind]))
        for p in range(parts):
            geo, got = tdist.build_band(b, parts, p,
                                        plan=_tplan(PLANS[kind]),
                                        device="cpu")
            assert (geo.ncols, geo.parts, geo.rows_per_part, geo.kind) == (
                g1.ncols, g1.parts, g1.rows_per_part, g1.kind)
            assert tdist.comm_volume(geo, K) == tdist.comm_volume(g1, K)
            _same_piece(got, g1.band(p, "cpu"))


def test_partition_2d_of_a_cached_graph_follows_its_plan():
    src, dst, val = _edges(6, RN, RM, RNNZ)
    tg = build_cached_graph(tsp.coo_from_edges(src, dst, val, RN, RM),
                            plan=KernelPlan(kind="sell", sell_c=8),
                            device="cpu")
    jg = jax_cached(jax_coo(src, dst, val, RN, RM),
                    plan=JPlan(kind="sell", sell_c=8))
    got, want = tdist.partition_2d(tg, 2), jgnn2d.partition_2d(jg, 2)
    assert got.kind == "sell"
    _same_layout(got, want, _G2D_FIELDS, "cached 2d")


def test_grid_factorisations_match_reference():
    """``grid_shape`` is the reference mesh's shape for every count it
    builds; one process without a process group gets the 1 x 1 grid."""
    for n in (1, 2, 3, 4, 6, 8, 9, 12, 16):
        want = jax_grid_mesh(n) if n <= len(jax.devices()) else None
        pr, pc = tdist.grid_shape(n)
        assert pr * pc == n and pr <= pc
        if want is not None:
            assert (pr, pc) == tuple(want.shape.values())
        # the reference's rule, applied by hand
        r = max(int(n ** 0.5), 1)
        while n % r:
            r -= 1
        assert (pr, pc) == (r, n // r)
    one = tdist.make_grid_mesh(device="cpu")
    assert one.shape == {"row": 1, "col": 1} and one.groups == {
        "row": None, "col": None}
    assert tdist.grid_axes(one) == ("row", "col")
    assert tdist.grid_axes(tdist.make_data_mesh(device="cpu")) == (
        "data", "model")
    with pytest.raises(ValueError, match="spans every rank"):
        tdist.make_grid_mesh(4, device="cpu")


def test_band_piece_drops_the_stacking_pad_steps():
    """A SELL band taken from the stack is the band's own packing: the
    pad steps gone, ``slice_of`` monotone, ``perm`` the inverse of
    ``inv_perm``; its ``(rows, cols)`` slot lists are the band's edges."""
    src, dst, val = _edges(3, N, N, NNZ)
    g = tdist.build_dist_graph(tsp.coo_from_edges(src, dst, val, N, N), 4,
                               plan=KernelPlan(kind="sell", sell_c=8))
    for p in range(4):
        band = g.band(p, "cpu")
        sof = band.op.slice_of
        assert bool((sof[1:] >= sof[:-1]).all())
        assert int(sof[-1]) == band.op.nslices - 1
        assert torch.equal(band.op.perm[band.op.inv_perm.long()],
                           torch.arange(g.rows_per_part, dtype=torch.int32))
        ok = band.cols < N
        got = sorted(zip((band.rows[ok] + p * g.rows_per_part).tolist(),
                         band.cols[ok].tolist()))
        sel = (dst >= p * g.rows_per_part) & (dst < (p + 1) * g.rows_per_part)
        assert got == sorted(zip(dst[sel].tolist(), src[sel].tolist()))


# --------------------------------------------------------------------------
# the operations: four gloo ranks against the reference's shard_map run
# --------------------------------------------------------------------------

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import coo_from_edges
from repro.core.autotune import KernelPlan
from repro.dist import (build_dist_graph, distributed_spmm, partition_2d,
                        distributed_spmm_2d, distributed_sddmm_2d,
                        distributed_fusedmm_2d)
from repro.dist.collectives import ring_allgather_matmul
d = dict(np.load(IN))
m1 = jax.make_mesh((4,), ('data',))
m2 = jax.make_mesh((2, 2), ('row', 'col'))
a = coo_from_edges(d['src'], d['dst'], d['val'], N, N)
ar = coo_from_edges(d['rsrc'], d['rdst'], d['rval'], RN, RM)
h, x, y, rh = (jnp.asarray(d[k]) for k in ('h', 'x', 'y', 'rh'))
res = {}
for kind, plan in (('ell', None), ('sell', KernelPlan(kind='sell',
                                                      sell_c=8))):
    g = build_dist_graph(a, 4, plan=plan)
    g2 = partition_2d(a, 2, 2, plan=plan)
    gr = partition_2d(ar, 2, 2, plan=plan)
    with m1:
        for red in ('sum', 'mean'):
            res[f'spmm1d_{kind}_{red}'] = jax.jit(
                lambda hh: distributed_spmm(g, hh, m1, reduce=red))(h)
        res[f'spmm1d_{kind}_grad'] = jax.jit(jax.grad(lambda hh: jnp.sum(
            distributed_spmm(g, hh, m1, reduce='mean') ** 2)))(h)
    with m2:
        for red in ('sum', 'mean'):
            res[f'spmm2d_{kind}_{red}'] = jax.jit(
                lambda hh: distributed_spmm_2d(g2, hh, m2, reduce=red))(h)
        res[f'spmm2d_{kind}_compressed'] = jax.jit(
            lambda hh: distributed_spmm_2d(g2, hh, m2, compress=True))(h)
        for scale in (True, False):
            res[f'sddmm_{kind}_{scale}'] = jax.jit(
                lambda xx, yy: distributed_sddmm_2d(
                    gr, xx, yy, m2, scale_by_a=scale))(x, y)
        for op in EDGE_OPS:
            res[f'fusedmm_{kind}_{op}'] = jax.jit(
                lambda xx, yy, hh: distributed_fusedmm_2d(
                    gr, xx, yy, hh, m2, edge_op=op))(x, y, rh)
            grads = jax.jit(jax.grad(lambda xx, yy, hh: jnp.sum(
                distributed_fusedmm_2d(gr, xx, yy, hh, m2, edge_op=op)
                ** 2), argnums=(0, 1, 2)))(x, y, rh)
            for name, gv in zip('xyh', grads):
                res[f'fusedmm_{kind}_{op}_d{name}'] = gv
A, H = jnp.asarray(d['ring_a']), jnp.asarray(d['ring_h'])
def body(a_band, h_loc):
    return ring_allgather_matmul(
        lambda src: jax.lax.dynamic_slice(a_band, (0, src * 8), (8, 8)),
        h_loc, 'data')
with m1:
    res['ring'] = jax.jit(jax.shard_map(
        body, mesh=m1, in_specs=(P('data', None), P('data', None)),
        out_specs=P('data', None)))(A, H)
np.savez(OUT, **{k: np.asarray(v) for k, v in res.items()})
"""


def _reference_run(tmp: Path, inputs: dict) -> subprocess.Popen:
    np.savez(tmp / "in.npz", **inputs)
    code = ("import os\nos.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=4'\n"
            f"IN, OUT = {str(tmp / 'in.npz')!r}, {str(tmp / 'ref.npz')!r}\n"
            f"N, RN, RM = {N}, {RN}, {RM}\nEDGE_OPS = {EDGE_OPS!r}\n"
            + textwrap.dedent(_REFERENCE))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _gnn_rank(mesh, d) -> dict:
    """Every case of this module on one of four ranks: ``mesh`` is the
    4-rank data mesh (the 1-D bands, the ring); the 2 x 2 grid is made
    here. Returns this rank's pieces (numpy) and its wire bytes."""
    torch.set_num_threads(1)
    r = mesh.index("data")
    grid = tdist.make_grid_mesh(device="cpu")
    a = tsp.coo_from_edges(d["src"], d["dst"], d["val"], N, N)
    ar = tsp.coo_from_edges(d["rsrc"], d["rdst"], d["rval"], RN, RM)
    t = {k: torch.from_numpy(d[k]) for k in ("h", "x", "y", "rh")}
    res, wire = {}, {}
    for kind, plan in PLANS.items():
        g = tdist.build_dist_graph(a, 4, plan=_tplan(plan))
        band = g.local(mesh)
        h_loc = tdist.shard_rows(t["h"], 4, r)
        for red in ("sum", "mean"):
            tdist.reset_wire_stats()
            res[f"spmm1d_{kind}_{red}"] = _np(tdist.distributed_spmm(
                band, h_loc, mesh, reduce=red))
            wire[f"spmm1d_{kind}"] = tdist.wire_stats()
        hh = h_loc.clone().requires_grad_()
        (tdist.distributed_spmm(band, hh, mesh, reduce="mean") ** 2
         ).sum().backward()
        res[f"spmm1d_{kind}_grad"] = _np(hh.grad)

        g2 = tdist.partition_2d(a, 2, 2, plan=_tplan(plan))
        tile = g2.local(grid)
        p = tile.index
        hc = tdist.col_shard(g2, t["h"], p)
        for red in ("sum", "mean"):
            tdist.reset_wire_stats()
            res[f"spmm2d_{kind}_{red}"] = _np(tdist.distributed_spmm_2d(
                tile, hc, grid, reduce=red))
            wire[f"spmm2d_{kind}"] = tdist.wire_stats()
        res[f"spmm2d_{kind}_compressed"] = _np(tdist.distributed_spmm_2d(
            tile, hc, grid, compress=True))

        gr = tdist.partition_2d(ar, 2, 2, plan=_tplan(plan))
        rt = gr.local(grid)
        x = tdist.row_shard(gr, t["x"], p)
        y = tdist.col_shard(gr, t["y"], p)
        rh = tdist.col_shard(gr, t["rh"], p)
        for scale in (True, False):
            res[f"sddmm_{kind}_{scale}"] = _np(tdist.distributed_sddmm_2d(
                rt, x, y, grid, scale_by_a=scale, shape=gr.idx.shape[1:]))
        for op in EDGE_OPS:
            res[f"fusedmm_{kind}_{op}"] = _np(tdist.distributed_fusedmm_2d(
                rt, x, y, rh, grid, edge_op=op))
            leaves = [v.clone().requires_grad_() for v in (x, y, rh)]
            (tdist.distributed_fusedmm_2d(rt, *leaves, grid, edge_op=op)
             ** 2).sum().backward()
            for name, leaf in zip("xyh", leaves):
                res[f"fusedmm_{kind}_{op}_d{name}"] = _np(leaf.grad)
    band_a = torch.from_numpy(d["ring_a"])[8 * r:8 * r + 8]
    res["ring"] = _np(tdist.ring_allgather_matmul(
        lambda src: band_a[:, 8 * src:8 * src + 8],
        torch.from_numpy(d["ring_h"])[8 * r:8 * r + 8], mesh, "data"))
    return dict(rank=r, tile=p, coords=(grid.index("row"), grid.index("col")),
                backend=mesh.backend, res=res, wire=wire)


@pytest.fixture(scope="module")
def gnn_run(tmp_path_factory):
    """The reference's 4-device run (a subprocess) and the port's four
    ranks, side by side."""
    tmp = tmp_path_factory.mktemp("dist_gnn")
    inputs = _inputs()
    proc = _reference_run(tmp, inputs)
    try:
        ranks = tdist.run_ranks(_gnn_rank, 4, str(tmp), args=(inputs,),
                                device="cpu", timeout_s=RANK_TIMEOUT)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference run:\n{out}\n{err[-4000:]}"
    ref = dict(np.load(tmp / "ref.npz"))
    return inputs, ranks, ref


def _rows(ranks, key, n):
    """The ranks' row-major (1-D: row-sharded) pieces in rank order."""
    return np.concatenate([r["res"][key] for r in ranks])[:n]


def _col_major(ranks, key, m, pr=2, pc=2):
    """The ranks' column-major pieces (rank ``(i, j)`` holds block ``j *
    pr + i``) in row order."""
    blocks = [None] * (pr * pc)
    for r in ranks:
        i, j = r["coords"]
        blocks[j * pr + i] = r["res"][key]
    return np.concatenate(blocks)[:m]


def _close(got, want, what, atol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err < atol, (what, err)


def _grad_close(got, want, what):
    rel = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-9)
    assert rel < 1e-4, (what, rel)


def test_ranks_are_a_2x2_gloo_grid(gnn_run):
    _, ranks, _ = gnn_run
    for r, got in enumerate(ranks):
        assert got["rank"] == got["tile"] == r and got["backend"] == "gloo"
        assert got["coords"] == divmod(r, 2)


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_distributed_spmm_1d_matches_reference(gnn_run, kind):
    inputs, ranks, ref = gnn_run
    dense = np.zeros((N, N), np.float32)
    dense[inputs["dst"], inputs["src"]] = inputs["val"]
    for red in ("sum", "mean"):
        key = f"spmm1d_{kind}_{red}"
        _close(_rows(ranks, key, N), ref[key], key)
    _close(_rows(ranks, f"spmm1d_{kind}_sum", N), dense @ inputs["h"],
           "against the dense product")
    _grad_close(_rows(ranks, f"spmm1d_{kind}_grad", N),
                ref[f"spmm1d_{kind}_grad"], f"{kind} dH")
    g = tdist.build_dist_graph(tsp.coo_from_edges(
        inputs["src"], inputs["dst"], inputs["val"], N, N), 4,
        plan=_tplan(PLANS[kind]))
    for got in ranks:       # the halo: the whole padded H on every rank
        assert got["wire"][f"spmm1d_{kind}"] == {"all_gather": dict(
            calls=1, bytes=4 * tdist.comm_volume(g, K)["elements"],
            staged_bytes=0, ms=got["wire"][f"spmm1d_{kind}"]["all_gather"][
                "ms"])}


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_distributed_spmm_2d_matches_reference(gnn_run, kind):
    inputs, ranks, ref = gnn_run
    for red in ("sum", "mean"):
        key = f"spmm2d_{kind}_{red}"
        _close(_rows(ranks, key, N), ref[key], key)
    g2 = tdist.partition_2d(tsp.coo_from_edges(
        inputs["src"], inputs["dst"], inputs["val"], N, N), 2, 2,
        plan=_tplan(PLANS[kind]))
    assert g2.cols_per_tile == N // 2       # the halo is one column block
    vol = tdist.comm_volume_2d(g2, K)
    for got in ranks:
        w = got["wire"][f"spmm2d_{kind}"]
        assert set(w) == {"all_gather", "psum_scatter"}
        assert w["all_gather"]["bytes"] == 4 * vol["gather_rows"] * K
        assert w["psum_scatter"]["bytes"] == 4 * vol["scatter_rows"] * K
        assert sum(v["bytes"] for v in w.values()) == 4 * vol["elements"]


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_distributed_spmm_2d_compressed_within_the_shared_quantum(gnn_run,
                                                                   kind):
    """The reference's bound: ``pc`` int8 rounding errors of the shared
    grid (``amax`` over the column blocks' partial products) sum."""
    inputs, ranks, ref = gnn_run
    dense = np.zeros((N, N), np.float32)
    dense[inputs["dst"], inputs["src"]] = inputs["val"]
    h = inputs["h"]
    cpt = N // 2
    parts = [dense[:, j * cpt:(j + 1) * cpt] @ h[j * cpt:(j + 1) * cpt]
             for j in range(2)]
    bound = 2 * max(np.abs(q).max() for q in parts) / 127.0 + 1e-6
    got = _rows(ranks, f"spmm2d_{kind}_compressed", N)
    assert float(np.abs(got - dense @ h).max()) <= bound
    assert float(np.abs(ref[f"spmm2d_{kind}_compressed"] - dense @ h).max()
                 ) <= bound


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_distributed_sddmm_2d_matches_reference(gnn_run, kind):
    inputs, ranks, ref = gnn_run
    gr = tdist.partition_2d(tsp.coo_from_edges(
        inputs["rsrc"], inputs["rdst"], inputs["rval"], RN, RM), 2, 2,
        plan=_tplan(PLANS[kind]))
    dense = np.zeros((RN, RM), np.float32)
    dense[inputs["rdst"], inputs["rsrc"]] = inputs["rval"]
    for scale in (True, False):
        key = f"sddmm_{kind}_{scale}"
        got = np.stack([r["res"][key] for r in ranks])
        _close(got, ref[key], key)
        pad = gr.idx.numpy() >= gr.cols_per_tile
        assert not got[pad].any()           # pad slots are 0
        sref = inputs["x"] @ inputs["y"].T * (dense if scale else
                                              (dense != 0))
        _close(tdist.scores_to_dense(gr, got), sref, f"{key} dense")


@pytest.mark.parametrize("op", EDGE_OPS)
@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_distributed_fusedmm_2d_and_its_gradients_match_reference(
        gnn_run, kind, op):
    inputs, ranks, ref = gnn_run
    key = f"fusedmm_{kind}_{op}"
    _close(_rows(ranks, key, RN), ref[key], key)
    _grad_close(_rows(ranks, f"{key}_dx", RN), ref[f"{key}_dx"], "dx")
    for name in ("dy", "dh"):
        _grad_close(_col_major(ranks, f"{key}_{name}", RM),
                    ref[f"{key}_{name}"], name)


def test_ring_allgather_matmul_matches_reference(gnn_run):
    inputs, ranks, ref = gnn_run
    got = np.concatenate([r["res"]["ring"] for r in ranks])
    _close(got, ref["ring"], "ring")
    _close(got, inputs["ring_a"] @ inputs["ring_h"], "ring dense")


# --------------------------------------------------------------------------
# one band, the 1 x 1 grid: identities in this process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_one_band_and_one_tile_match_reference(kind):
    inputs = _inputs()
    src, dst, val = inputs["src"], inputs["dst"], inputs["val"]
    h = inputs["h"]
    x, y = inputs["h"][:, :RD].copy(), inputs["h"][::-1, RD:].copy()
    a, ja = tsp.coo_from_edges(src, dst, val, N, N), jax_coo(src, dst, val,
                                                             N, N)
    data, grid = tdist.make_data_mesh(device="cpu"), \
        tdist.make_grid_mesh(device="cpu")
    jm1 = jax.make_mesh((1,), ("data",))
    jm2 = jax.make_mesh((1, 1), ("row", "col"))
    g = tdist.build_dist_graph(a, 1, plan=_tplan(PLANS[kind]))
    jg = jgnn.build_dist_graph(ja, 1, plan=_jplan(PLANS[kind]))
    g2 = tdist.partition_2d(a, 1, plan=_tplan(PLANS[kind]))
    jg2 = jgnn2d.partition_2d(ja, 1, plan=_jplan(PLANS[kind]))

    def reference(hh, xx, yy):
        with jm1:
            one = [jgnn.distributed_spmm(jg, hh, jm1, reduce=red)
                   for red in ("sum", "mean")]
        with jm2:
            tile = [jgnn2d.distributed_spmm_2d(jg2, hh, jm2, reduce=red)
                    for red in ("sum", "mean")]
            tile.append(jgnn2d.distributed_sddmm_2d(jg2, xx, yy, jm2)[0])
            tile += [jgnn2d.distributed_fusedmm_2d(jg2, xx, yy, hh, jm2,
                                                   edge_op=op)
                     for op in EDGE_OPS]
        return one + tile

    want = jax.jit(reference)(*(jnp.asarray(v) for v in (h, x, y)))
    th, tx, ty = (torch.from_numpy(v) for v in (h, x, y))
    got = [tdist.distributed_spmm(g, th, data, reduce=red)
           for red in ("sum", "mean")]
    got += [tdist.distributed_spmm_2d(g2, th, grid, reduce=red)
            for red in ("sum", "mean")]
    got.append(tdist.distributed_sddmm_2d(g2, tx, ty, grid))
    got += [tdist.distributed_fusedmm_2d(g2, tx, ty, th, grid, edge_op=op)
            for op in EDGE_OPS]
    names = ["1 band sum", "1 band mean", "1x1 sum", "1x1 mean",
             "1x1 sddmm"] + [f"1x1 fusedmm {op}" for op in EDGE_OPS]
    for name, gv, wv in zip(names, got, want, strict=True):
        _close(_np(gv), wv, name)
    # the compressed wire over one rank is the exact sum
    _bits(_np(tdist.distributed_spmm_2d(g2, th, grid, compress=True)),
          _np(got[2]), "1x1 compressed")
    ring = tdist.ring_allgather_matmul(lambda src: th.T, th, data, "data")
    _close(_np(ring), h.T @ h, "1-rank ring")
