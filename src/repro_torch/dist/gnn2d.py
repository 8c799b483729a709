"""Distributed GNN operations over a ``(pr x pc)`` vertex-cut tile grid:
SpMM, SDDMM and FusedMM (``src/repro/dist/gnn2d.py``).

Why 2-D: the 1-D bands (:mod:`repro_torch.dist.gnn`) all-gather the
whole feature matrix every step, O(N K) a rank whatever the rank count.
With the adjacency blocked over a ``(pr x pc)`` grid, rank ``(i, j)``
owns tile ``A[row block i, column block j]`` and one SpMM step is

1. a ``'row'``-axis all-gather of H's column block ``j``: N / pr rows;
2. the tile's SpMM, the hand ELL or SELL kernel on a ``(N / pr) x
   (M / pc)`` block;
3. a ``'col'``-axis reduce-scatter of the partial row sums, each rank
   keeping its ``1 / pc`` (int8 on the wire with ``compress=True``).

Layouts (the reference's; all padding is done once, at partition time):

* rows pad to ``pr * rows_per_tile``, ``rows_per_tile`` a multiple of
  ``pc`` (so the reduce-scatter tiles evenly) and of the SELL slice
  height C when the plan picks SELL;
* columns pad to ``pc * cols_per_tile``, ``cols_per_tile`` a multiple
  of ``pr`` (so column blocks gather evenly over ``'row'``);
* tile ``(i, j)`` stores **local** column ids, sentinel
  ``cols_per_tile``: the gathered column block is all it indexes;
* **row-major** operands and results (the output of SpMM and FusedMM,
  the ``x`` of SDDMM and FusedMM): rank ``(i, j)`` holds rows
  ``[i * rpt + j * rpt / pc, ...)`` (:func:`row_shard`);
* **column-major** operands (the ``h`` and ``y`` inputs): rank ``(i, j)``
  holds rows ``[j * cpt + i * cpt / pr, ...)`` (:func:`col_shard`), so
  the ``'row'``-axis all-gather reassembles column block ``j`` in order.

The tile layout follows the kernel plan: a SELL plan packs every tile
degree-sorted (σ = the tile), anything else keeps ELL tiles padded to
the largest in-tile degree of any tile.

:func:`partition_2d` builds the reference's host arrays, every tile
stacked (bitwise the reference's); each rank takes only its own tile to
its device (:meth:`Graph2D.tile`, :meth:`Graph2D.local`: a
:class:`~repro_torch.dist.gnn.Band` over local column ids).
:func:`build_tile` builds one tile alone, the same bits, for tiles too
large to stack once a rank (ELL tiles padded to a hub's degree). On a
rank:

* :func:`distributed_spmm_2d` — sum or mean, ``compress=``;
  differentiable in ``h`` unless compressed;
* :func:`distributed_sddmm_2d` — each slot's score ``x_row · y_col``
  through the per-edge SDDMM kernel (kernel E), in the tile layout, the
  pad slots 0, scaled by A or not;
* :func:`distributed_fusedmm_2d` — kernel E scores, the edge op
  (``kernels.ref.edge_weights`` with the row softmax's max and
  denominator reduced over ``'col'``: a row's neighbourhood spans the
  column tiles), the tile's SpMM with the weights as its values, and the
  ``'col'`` reduce-scatter. Differentiable in x, y and h: ``dw`` by
  kernel E, ``dh`` and the scores' gradients by the ordered segment sum
  (kernel S), the gathers' gradients by reduce-scatters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import sparse as sp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.cache import CachedGraph
from repro_torch.dist.collectives import (all_gather, compressed_psum_scatter,
                                          psum_scatter)
from repro_torch.dist.gnn import (Band, SlotSpMM, _host_graph, _t, ell_piece,
                                  sell_piece)
from repro_torch.dist.sharding import grid_axes
from repro_torch.kernels import segment_sum as kseg
from repro_torch.kernels.edge_dots import edge_dots
from repro_torch.kernels.fusedmm import EDGE_OPS
from repro_torch.kernels.ref import edge_weights

__all__ = ["Graph2D", "Grid", "partition_2d", "build_tile", "ell_tile_width",
           "distributed_spmm_2d", "distributed_sddmm_2d",
           "distributed_fusedmm_2d",
           "scores_to_dense", "comm_volume_2d", "row_shard", "col_shard"]


@dataclasses.dataclass(frozen=True)
class Graph2D:
    """Vertex-cut adjacency: ``pr x pc`` tiles stacked row-major (tile
    ``p = i * pc + j``), host tensors (the reference's layout).

    ELL layout (``kind == 'ell'``): ``idx`` / ``val`` are ``(pr * pc,
    rows_per_tile, max_deg)`` with local column ids and the sentinel
    ``cols_per_tile``; ``slice_of`` / ``perm`` / ``inv_perm`` are None.
    SELL layout (``kind == 'sell'``): ``idx`` / ``val`` are ``(pr * pc,
    n_steps, C)`` packed degree-major per tile (tiles padded to one step
    count with sentinel steps of slice 0), ``slice_of`` ``(pr * pc,
    n_steps)``, ``perm`` / ``inv_perm`` ``(pr * pc, rows_per_tile)``:
    sorted position <-> tile-local row. ``inv_deg``: ``(pr *
    rows_per_tile,)`` 1/deg of the whole row (the mean normalises by the
    global degree, not the tile's), row-major like the SpMM output."""

    idx: torch.Tensor
    val: torch.Tensor
    inv_deg: torch.Tensor
    slice_of: Optional[torch.Tensor]
    perm: Optional[torch.Tensor]
    inv_perm: Optional[torch.Tensor]
    nrows: int
    ncols: int
    pr: int
    pc: int
    rows_per_tile: int
    cols_per_tile: int
    kind: str = "ell"
    sell_c: int = 8

    @property
    def parts(self) -> int:
        return self.pr * self.pc

    @property
    def max_deg(self) -> int:
        if self.kind != "ell":
            raise ValueError("max_deg is an ELL-layout property")
        return self.idx.shape[-1]

    @property
    def n_steps(self) -> int:
        if self.kind != "sell":
            raise ValueError("n_steps is a SELL-layout property")
        return self.idx.shape[1]

    @property
    def nslices(self) -> int:
        if self.kind != "sell":
            raise ValueError("nslices is a SELL-layout property")
        return self.rows_per_tile // self.sell_c

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def grid(self) -> "Grid":
        return Grid(**{f.name: getattr(self, f.name)
                       for f in dataclasses.fields(Grid)})

    def tile(self, p: int, device="cuda") -> Band:
        """Tile ``p`` alone, on ``device``, as the kernel's operand over
        local column ids; its ``inv_deg`` is its rank's row-major
        ``rows_per_tile / pc`` rows."""
        cpt = self.cols_per_tile
        if self.kind == "sell":
            op = sell_piece(self.idx[p], self.val[p], self.slice_of[p],
                            self.inv_perm[p], cpt, self.sell_c)
        else:
            op = ell_piece(self.idx[p], self.val[p], cpt)
        n = self.rows_per_tile // self.pc
        return Band.make(op, self.inv_deg[p * n:(p + 1) * n], p, device)

    def local(self, mesh) -> Band:
        """This rank's tile (``p = i * pc + j`` at grid coordinates
        ``(i, j)``) on its device."""
        row_ax, col_ax = _check_mesh(self, mesh)
        return self.tile(mesh.index(row_ax) * self.pc + mesh.index(col_ax),
                         mesh.device)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Grid:
    """The geometry of a ``(pr x pc)`` partition (the scalar fields of
    :class:`Graph2D`): what :func:`row_shard`, :func:`col_shard` and
    :func:`comm_volume_2d` read."""

    nrows: int
    ncols: int
    pr: int
    pc: int
    rows_per_tile: int
    cols_per_tile: int
    kind: str
    sell_c: int

    @property
    def parts(self) -> int:
        return self.pr * self.pc


def _grid(coo: sp.COO, pr: int, pc: int, plan: KernelPlan) -> Grid:
    kind = "sell" if plan.wants_sell else "ell"
    c = plan.sell_c
    r_align = int(np.lcm(pc, c)) if kind == "sell" else pc
    return Grid(nrows=coo.nrows, ncols=coo.ncols, pr=pr, pc=pc,
                rows_per_tile=max(_round_up(-(-coo.nrows // pr), r_align),
                                  r_align),
                cols_per_tile=max(_round_up(-(-coo.ncols // pc), pr), pr),
                kind=kind, sell_c=c)


def _edges(coo: sp.COO):
    return (coo.row[: coo.nse].cpu().numpy(), coo.col[: coo.nse].cpu().numpy(),
            coo.val[: coo.nse].cpu().numpy())


def _tile_coo(row, col, val, grid: Grid, p: int) -> sp.COO:
    """Tile ``p``'s edges over tile-local rows and columns."""
    i, j = divmod(p, grid.pc)
    rpt, cpt = grid.rows_per_tile, grid.cols_per_tile
    m = (row >= i * rpt) & (row < (i + 1) * rpt) & (col >= j * cpt) & \
        (col < (j + 1) * cpt)
    return sp.coo_from_edges(col[m] - j * cpt, row[m] - i * rpt, val[m],
                             nrows=rpt, ncols=cpt)


def _inv_deg(deg: np.ndarray, grid: Grid) -> np.ndarray:
    inv = np.ones(grid.pr * grid.rows_per_tile, np.float32)  # pad rows: 1
    inv[:grid.nrows] = 1.0 / np.maximum(deg, 1.0)
    return inv


def partition_2d(a: Union[sp.COO, CachedGraph], pr: int,
                 pc: int | None = None,
                 plan: Optional[KernelPlan] = None) -> Graph2D:
    """The one-time host partition into a ``(pr x pc)`` tile grid
    (``pc`` defaults to ``pr``, the square grid of
    :func:`~repro_torch.dist.mesh.make_grid_mesh`). The layout follows
    ``plan`` (an explicit one wins; else a CachedGraph's plan; else
    ELL): a SELL plan packs each tile degree-sorted, anything else keeps
    ELL tiles padded to the largest in-tile degree."""
    pc = pr if pc is None else pc
    coo, deg, own_plan = _host_graph(a)
    grid = _grid(coo, pr, pc, own_plan if plan is None else plan)
    row, col, val = _edges(coo)
    cpt, c = grid.cols_per_tile, grid.sell_c
    inv = _inv_deg(deg, grid)
    tiles = [_tile_coo(row, col, val, grid, p) for p in range(grid.parts)]
    if grid.kind == "sell":
        sells = [sp.sell_from_coo(t, c=c, sigma=0) for t in tiles]
        n_steps = max(s.n_steps for s in sells)
        idxs, vals, sofs, perms, invps = [], [], [], [], []
        for s in sells:
            pad = n_steps - s.n_steps
            # sentinel pad steps: no neighbours, attributed to slice 0
            idxs.append(np.pad(s.idx.numpy(), ((0, pad), (0, 0)),
                               constant_values=cpt))
            vals.append(np.pad(s.val.numpy(), ((0, pad), (0, 0))))
            sofs.append(np.pad(s.slice_of.numpy(), (0, pad)))
            perms.append(s.perm.numpy())
            invps.append(s.inv_perm.numpy())
        return Graph2D(idx=_t(np.stack(idxs), np.int32),
                       val=_t(np.stack(vals)), inv_deg=_t(inv),
                       slice_of=_t(np.stack(sofs), np.int32),
                       perm=_t(np.stack(perms), np.int32),
                       inv_perm=_t(np.stack(invps), np.int32),
                       **_fields(grid))
    md = _ell_width(row, col, grid)
    ells = [sp.ell_from_coo(t, max_deg=md) for t in tiles]
    return Graph2D(idx=_t(np.stack([e.idx.numpy() for e in ells]), np.int32),
                   val=_t(np.stack([e.val.numpy() for e in ells])),
                   inv_deg=_t(inv), slice_of=None, perm=None, inv_perm=None,
                   **_fields(grid))


def _fields(grid: Grid) -> dict:
    return {f.name: getattr(grid, f.name) for f in dataclasses.fields(grid)}


def _ell_width(row, col, grid: Grid) -> int:
    """The ELL tiles' one width: the largest in-tile degree of any row of
    any tile (at least 1)."""
    if not row.size:
        return 1
    key = row.astype(np.int64) * grid.pc + col // grid.cols_per_tile
    return max(int(np.bincount(key).max()), 1)


def ell_tile_width(a: Union[sp.COO, CachedGraph], pr: int,
                   pc: int | None = None) -> tuple[Grid, int]:
    """The geometry of an ELL partition into a ``(pr x pc)`` grid and its
    tiles' one width (the widest in-tile degree), without packing a
    tile: what the tiles would take (``rows_per_tile x width`` slots
    each) before they are built."""
    pc = pr if pc is None else pc
    coo, _, _ = _host_graph(a)
    grid = _grid(coo, pr, pc, KernelPlan.trusted())
    row, col, _ = _edges(coo)
    return grid, _ell_width(row, col, grid)


def build_tile(a: Union[sp.COO, CachedGraph], pr: int, pc: int, p: int,
               plan: Optional[KernelPlan] = None, device="cuda"
               ) -> tuple[Grid, Band]:
    """Tile ``p`` of :func:`partition_2d`'s grid alone, built on the host
    and taken to ``device``, without packing the other tiles: equal to
    ``partition_2d(a, pr, pc, plan).tile(p, device)`` (an ELL tile is as
    wide as the widest tile of the grid). For tiles too large to stack
    on one host four times over. Returns the grid's geometry too."""
    coo, deg, own_plan = _host_graph(a)
    grid = _grid(coo, pr, pc, own_plan if plan is None else plan)
    row, col, val = _edges(coo)
    t = _tile_coo(row, col, val, grid, p)
    if grid.kind == "sell":
        s = sp.sell_from_coo(t, c=grid.sell_c, sigma=0)
        op = sell_piece(s.idx, s.val, s.slice_of, s.inv_perm,
                        grid.cols_per_tile, grid.sell_c)
    else:
        e = sp.ell_from_coo(t, max_deg=_ell_width(row, col, grid))
        op = ell_piece(e.idx, e.val, grid.cols_per_tile)
    n = grid.rows_per_tile // grid.pc
    inv = _t(_inv_deg(deg, grid)[p * n:(p + 1) * n])
    return grid, Band.make(op, inv, p, device)


# --------------------------------------------------------------------------
# layouts shared by the three operations
# --------------------------------------------------------------------------

def _check_mesh(g: Graph2D, mesh) -> tuple[str, str]:
    row_ax, col_ax = grid_axes(mesh)
    if (mesh.shape[row_ax], mesh.shape[col_ax]) != (g.pr, g.pc):
        raise ValueError(f"mesh {dict(mesh.shape)} against the graph's "
                         f"{g.pr} x {g.pc} grid")
    return row_ax, col_ax


def _block(x: torch.Tensor, total: int, blocks: int, b: int) -> torch.Tensor:
    n = total // blocks
    blk = x[b * n:(b + 1) * n]
    if blk.shape[0] < n:
        blk = torch.cat([blk, blk.new_zeros((n - blk.shape[0],) +
                                            tuple(x.shape[1:]))])
    return blk


def row_shard(g: Union[Graph2D, Grid], x: torch.Tensor, p: int) -> torch.Tensor:
    """Tile ``p``'s rank's row-major rows of ``x`` (``(N, D)``, padded
    with zero rows): ``rows_per_tile / pc`` rows from row ``p *
    rows_per_tile / pc``. The results of SpMM and FusedMM come back in
    this layout: the ranks' pieces in rank order are the rows in order."""
    return _block(x, g.pr * g.rows_per_tile, g.parts, p)


def col_shard(g: Union[Graph2D, Grid], y: torch.Tensor, p: int) -> torch.Tensor:
    """Tile ``p = i * pc + j``'s rank's column-major rows of ``y``
    (``(M, D)``, padded with zero rows): ``cols_per_tile / pr`` rows
    from row ``j * cols_per_tile + i * cols_per_tile / pr``."""
    i, j = divmod(p, g.pc)
    return _block(y, g.pc * g.cols_per_tile, g.parts, j * g.pr + i)


def comm_volume_2d(g: Union[Graph2D, Grid], k: int) -> dict:
    """A rank's collective traffic (feature rows, elements) in one
    :func:`distributed_spmm_2d` step: the ``'row'`` gather buffer and the
    ``'col'`` reduce-scatter operand. Compare ``gnn.comm_volume`` (the
    1-D halo, the whole padded H)."""
    return dict(gather_rows=g.cols_per_tile, scatter_rows=g.rows_per_tile,
                elements=(g.cols_per_tile + g.rows_per_tile) * k)


def _tile_of(g, mesh) -> tuple[Band, str, str]:
    if isinstance(g, Graph2D):
        row_ax, col_ax = _check_mesh(g, mesh)
        return g.local(mesh), row_ax, col_ax
    row_ax, col_ax = grid_axes(mesh)
    return g, row_ax, col_ax


# --------------------------------------------------------------------------
# SpMM
# --------------------------------------------------------------------------

def distributed_spmm_2d(g: Union[Graph2D, Band], h: torch.Tensor, mesh,
                        reduce: str = "sum", *,
                        compress: bool = False) -> torch.Tensor:
    """A @ H on this rank, A vertex-cut over the mesh's grid. ``g``: this
    rank's tile (or the :class:`Graph2D`); ``h``: this rank's
    column-major ``(cols_per_tile / pr, K)`` rows of H (:func:`col_shard`).
    Returns this rank's row-major ``(rows_per_tile / pc, K)`` rows of the
    result (:func:`row_shard`'s layout), in ``h``'s dtype.
    ``compress=True`` sums the partial rows over ``'col'`` on the int8
    wire (:func:`~repro_torch.dist.collectives.compressed_psum_scatter`).
    Differentiable in ``h`` unless compressed."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce must be 'sum' or 'mean', got {reduce!r}")
    tile, row_ax, col_ax = _tile_of(g, mesh)
    hg = all_gather(h, mesh, row_ax)        # column block j, (cpt, K)
    if hg.shape[0] != tile.op.ncols:
        raise ValueError(f"distributed_spmm_2d: the gathered column block "
                         f"has {hg.shape[0]} rows, the tile "
                         f"{tile.op.ncols} columns")
    part = SlotSpMM.apply(tile.weight, hg, tile)
    if compress:
        part = compressed_psum_scatter(part, mesh, col_ax)
    else:
        part = psum_scatter(part, mesh, col_ax)
    if reduce == "mean":
        part = part * tile.inv_deg[:, None]
    return part.to(h.dtype)


# --------------------------------------------------------------------------
# SDDMM
# --------------------------------------------------------------------------

class _SlotScores(torch.autograd.Function):
    """Each slot's ``x[row] · y[col]`` through kernel E (sentinel columns
    read zero rows: 0). Backward: ``dx`` and ``dy`` ordered segment sums
    over the piece's row and column orders (kernel S)."""

    @staticmethod
    def forward(ctx, x, y, piece):
        ctx.piece = piece
        ctx.save_for_backward(x, y)
        return edge_dots(x, y, piece.rows, piece.cols)

    @staticmethod
    def backward(ctx, ds):
        x, y = ctx.saved_tensors
        piece = ctx.piece
        ds = ds.float().contiguous()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = kseg.gather_scale_sum(y, piece.row_order, ds).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = kseg.gather_scale_sum(x, piece.col_order, ds).to(y.dtype)
        return dx, dy, None


def _tile_shape(g, tile: Band) -> tuple:
    """The stacked layout's shape of one tile's slots."""
    if isinstance(g, Graph2D):
        return tuple(g.idx.shape[1:])
    return tuple(tile.op.idx.shape)


def distributed_sddmm_2d(g: Union[Graph2D, Band], x: torch.Tensor,
                         y: torch.Tensor, mesh, *, scale_by_a: bool = True,
                         shape: tuple | None = None) -> torch.Tensor:
    """Per-slot scores ``s = x[row] · y[col]`` over this rank's tile.
    ``x``: this rank's row-major ``(rows_per_tile / pc, D)`` rows
    (:func:`row_shard`), ``y``: its column-major ``(cols_per_tile / pr,
    D)`` rows (:func:`col_shard`). The rank gathers x's row block over
    ``'col'`` and y's column block over ``'row'`` (both O(N / sqrt(P)))
    and scores its tile's slots through kernel E. Returns the scores in
    the tile's stacked layout (``g.idx[p]``'s shape, or ``shape`` when
    ``g`` is a tile: SELL tiles are padded to one step count), 0 on pad
    slots, times A's values when ``scale_by_a``; :func:`scores_to_dense`
    scatters the ranks' pieces back."""
    tile, row_ax, col_ax = _tile_of(g, mesh)
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)}")
    xg = all_gather(x, mesh, col_ax)              # row block i, (rpt, D)
    yg = all_gather(y, mesh, row_ax)              # column block j, (cpt, D)
    s = _SlotScores.apply(xg, yg, tile)
    valid = tile.cols < tile.op.ncols
    if scale_by_a:
        s = s * tile.weight
    s = torch.where(valid, s, 0.0).reshape(tile.op.idx.shape)
    want = _tile_shape(g, tile) if shape is None else tuple(shape)
    if want[0] > s.shape[0]:
        s = torch.cat([s, s.new_zeros((want[0] - s.shape[0],) +
                                      tuple(s.shape[1:]))])
    return s.to(x.dtype)


def scores_to_dense(g: Graph2D, s, *, trim: bool = True) -> np.ndarray:
    """Host scatter of tile-layout scores (the ranks' pieces of
    :func:`distributed_sddmm_2d` stacked in rank order, or ``g.val``
    itself) back to a dense matrix, for tests and inspection.
    ``trim=True`` returns the ``(N, M)`` matrix; ``trim=False`` the padded
    ``(pr * rpt, pc * cpt)`` canvas, whose pad region must stay 0."""
    s = np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s)
    rpt, cpt = g.rows_per_tile, g.cols_per_tile
    out = np.zeros((g.pr * rpt, g.pc * cpt), s.dtype)
    idx = g.idx.numpy()
    for p in range(g.parts):
        i, j = divmod(p, g.pc)
        if g.kind == "sell":
            pos = (g.slice_of[p].numpy()[:, None] * g.sell_c
                   + np.arange(g.sell_c)[None, :])
            rows = g.perm[p].numpy()[pos]
        else:
            rows = np.broadcast_to(np.arange(rpt)[:, None], idx[p].shape)
        m = idx[p] < cpt
        np.add.at(out, (i * rpt + rows[m], j * cpt + idx[p][m]), s[p][m])
    return out[: g.nrows, : g.ncols] if trim else out


# --------------------------------------------------------------------------
# FusedMM
# --------------------------------------------------------------------------

def distributed_fusedmm_2d(g: Union[Graph2D, Band], x: torch.Tensor,
                           y: torch.Tensor, h: torch.Tensor, mesh, *,
                           edge_op: str = "softmax") -> torch.Tensor:
    """``out[i] = sum_j f(x_i · y_j) h_j`` over A's sparsity, vertex-cut:
    kernel E scores on the tile's slots, the edge op
    (``kernels.ref.edge_weights``, the row softmax's max and sum reduced
    over ``'col'``), the tile's SpMM with the weights as its values, and
    the ``'col'`` reduce-scatter. ``x`` row-major, ``y`` and ``h``
    column-major (:func:`row_shard`, :func:`col_shard`); returns this
    rank's row-major ``(rows_per_tile / pc, K)`` rows. No (N x N) edge
    tensor exists, only the tile's slots. Differentiable in x, y, h."""
    if edge_op not in EDGE_OPS:
        raise ValueError(f"edge_op {edge_op!r} not in {EDGE_OPS}")
    tile, row_ax, col_ax = _tile_of(g, mesh)
    xg = all_gather(x, mesh, col_ax)              # (rpt, D)
    yg = all_gather(y, mesh, row_ax)              # (cpt, D)
    hg = all_gather(h, mesh, row_ax)              # (cpt, K)
    s = _SlotScores.apply(xg, yg, tile)
    valid = tile.cols < tile.op.ncols
    w = edge_weights(s, tile.rows, tile.op.nrows, valid, edge_op,
                     order=tile.row_order, mesh=mesh, axis=col_ax)
    part = SlotSpMM.apply(w, hg, tile)
    return psum_scatter(part, mesh, col_ax).to(h.dtype)
