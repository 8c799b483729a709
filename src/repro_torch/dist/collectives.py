"""The collectives of the port's distributed paths (``src/repro/dist/
collectives.py``): the gradient sync of data-parallel training, its int8
wire and the unanimity bit; and the tensor collectives of the
distributed GNN path (``dist.gnn``, ``dist.gnn2d``) over one mesh axis.

The reference runs these inside a ``shard_map`` body and takes a mesh
axis *name*; here each rank is a process and the functions take the
rank's :class:`~repro_torch.dist.mesh.Mesh` and the axis name. Every
rank of the axis must issue the same collectives in the same order.
Leaves are nested dicts of tensors (``optim.optimizer.tree_map``). A
collective over an axis whose group is None (a one-rank axis) is an
identity.

**Gradient sync.** ``sync_grads`` with ``wire='fp32'`` is an
``all_reduce`` sum, then a divide by the axis size, in each leaf's own
dtype. ``wire='int8'`` composes :func:`compressed_psum`: the leaf's
absmax max-reduced, so every rank quantizes onto one grid
(``optim.compression.int8_compress`` with ``amax=``), the int8 values
summed as int32, dequantized once, then divided.

**The GNN path's tensor collectives**, tiled on dim 0 like the
reference's: :func:`all_gather` (its backward :func:`psum_scatter`),
:func:`psum_scatter` (its backward :func:`all_gather`), :func:`pmax` (no
gradient), :func:`axis_sum` (differentiable; its backward the sum of the
gradients), :func:`compressed_psum_scatter` and
:func:`ring_allgather_matmul`; and the tensor-parallel LM path's
Megatron pair: :func:`copy_to_axis` (identity forward, the ranks'
gradients summed backward: at the input of a product whose columns are
split) and :func:`reduce_from_axis` (the ranks' sum forward, identity
backward: at the output of a product whose rows are split). Unlike
:func:`axis_sum`, whose backward sums the ranks' gradients (right where
each rank's downstream differs, as in the 2-D GNN path), the reduced
output of a tensor-parallel product feeds the same replicated
computation on every rank, so its gradient is already whole there; the
same pair for a dimension (the sequence) split over an axis:
:func:`split_to_axis` (this rank's block forward, the blocks' gradients
gathered backward) and :func:`gather_from_axis` (the blocks gathered
forward, this rank's block of the gradient kept backward, without a
sum: every rank computes the same replicated downstream, so each already
holds the whole gradient). :func:`all_to_all` is the manual
expert-parallel MoE's exchange (``jax.lax.all_to_all`` with
``axis_index_groups``), its backward the same exchange of the
gradients. The backend only moves data: a
reduce-scatter is an ``all_to_all_single`` and a sum of the received
pieces in rank order, a sum or max an ``all_gather_into_tensor`` and
the reduction of the gathered rows, so the arithmetic runs on the
tensors' own device (the card's in a card run), in one order on every
run. What gloo takes on card tensors (``tools/gloo_probe.py``, four ranks
on one H100, torch 2.11): ``all_gather_into_tensor``,
``all_to_all_single``, ``all_reduce`` and ``broadcast`` (gloo stages
them through the host itself); it refuses the list ``all_to_all`` and
hands a card pointer to its socket in ``isend`` / ``irecv`` (the process
aborts). So the ring's send / receive pair is staged through host
buffers where gloo carries card tensors (:data:`GLOO_STAGED`); on NCCL
(a card a rank) and on the CPU nothing is staged. Every call adds to
this process's :func:`wire_stats`: calls, the bytes of the buffer the
backend fills (an all-gather's gathered rows, an all-to-all's received
rows, a receive's buffer: the reference's ``comm_volume`` counts), the
bytes staged, and the host ms (after a device sync on both sides when
:func:`reset_wire_stats` asked for ``timing``).
"""
from __future__ import annotations

import math
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.optim.compression import int8_compress, int8_decompress
from repro_torch.optim.optimizer import tree_leaves, tree_map

__all__ = ["axis_size", "all_agree", "psum", "pmean", "compressed_psum",
           "sync_grads", "wire_bytes", "replicas_equal", "all_gather",
           "psum_scatter", "pmax", "axis_sum", "compressed_psum_scatter",
           "ring_allgather_matmul", "GLOO_STAGED", "wire_stats",
           "reset_wire_stats", "copy_to_axis", "reduce_from_axis",
           "gather_dim", "split_to_axis", "gather_from_axis", "all_to_all"]


def axis_size(mesh, axis: str = "data") -> int:
    """Size of ``axis`` on ``mesh``."""
    return int(mesh.shape[axis])


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_agree(flag: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The unanimity bit: True on *every* rank iff ``flag`` (a bool
    scalar tensor) is True on every rank of ``axis`` (the int32 sum of the
    flags equals the axis size). Every rank issues it unconditionally, so
    all ranks branch the same way after it and no later collective
    strands a rank that decided otherwise. The result stays a tensor on
    ``flag``'s device."""
    total = _all_reduce(flag.to(torch.int32).reshape(1), mesh.group(axis))
    return total[0] == axis_size(mesh, axis)


def psum(tree, mesh, axis: str = "data"):
    """The sum over ``axis`` of every leaf (an ``all_reduce`` of a copy:
    the inputs are not written), in the leaf's own dtype."""
    group = mesh.group(axis)
    if group is None:
        return tree
    return tree_map(lambda x: _all_reduce(x.contiguous().clone(), group),
                    tree)


def pmean(tree, mesh, axis: str = "data"):
    """The mean over ``axis`` of every leaf: :func:`psum`, then a divide
    by the axis size, in the leaf's own dtype."""
    if mesh.group(axis) is None:
        return tree
    n = axis_size(mesh, axis)
    return tree_map(lambda x: x / n, psum(tree, mesh, axis))


def compressed_psum(tree, mesh, axis: str = "data", *, mean: bool = True):
    """Quantized mean (or sum) of a gradient tree over ``axis``. A leaf:
    amax = the max over the ranks of its absmax, int8 quantize onto
    amax / 127, int32 sum, dequantize; the error is bounded by the shared
    quantum (amax / 127)."""
    n, group = axis_size(mesh, axis), mesh.group(axis)
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    # one max-reduce for every leaf's absmax (the reference's per-leaf
    # pmax, gathered into one collective)
    amax = torch.stack([x.detach().float().abs().amax() for x in leaves])
    amax = _all_reduce(amax, group, dist.ReduceOp.MAX)
    it = iter(range(len(leaves)))

    def one(x):
        q, scale = int8_compress(x.float(), amax=amax[next(it)])
        total = _all_reduce(q.to(torch.int32), group)
        out = int8_decompress(total, scale)
        if mean:
            out = out / n
        return out.to(x.dtype)
    return tree_map(one, tree)


def sync_grads(tree, mesh, axis: str = "data", *, wire: str = "fp32",
               mean: bool = True):
    """The gradient sync of a data-parallel step, placed between the
    gradients and the optimizer: reduce ``tree`` over ``axis``.
    ``wire='fp32'`` is the exact sum (and mean), ``wire='int8'`` the
    shared-scale quantized wire of :func:`compressed_psum`."""
    if wire == "int8":
        return compressed_psum(tree, mesh, axis, mean=mean)
    if wire != "fp32":
        raise ValueError(f"wire must be 'fp32' or 'int8', got {wire!r}")
    return (pmean if mean else psum)(tree, mesh, axis)


def wire_bytes(tree, wire: str = "fp32") -> int:
    """Bytes one rank puts on the wire for one :func:`sync_grads` of
    ``tree`` (tensors, or anything with a ``shape``), as the reference
    counts them: fp32 4 bytes an element; int8 1 byte an element and 8 a
    leaf for the shared scale's exchange (the deployment's accounting,
    where the int32 sum happens in the network)."""
    leaves = tree_leaves(tree)
    n = sum(math.prod(x.shape) if len(x.shape) else 1 for x in leaves)
    if wire == "int8":
        return n + 8 * len(leaves)
    return 4 * n


def replicas_equal(tree, mesh, axis: str = "data") -> bool:
    """True on every rank iff every rank of ``axis`` holds the same bits
    in every leaf of ``tree`` as the axis's first rank (which broadcasts
    its copy). A collective: every rank issues it."""
    group = mesh.group(axis)
    if group is None:
        return True
    src = dist.get_global_rank(group, 0)
    same = torch.ones((), dtype=torch.bool,
                      device=tree_leaves(tree)[0].device)
    for x in tree_leaves(tree):
        first = x.detach().contiguous().clone()
        dist.broadcast(first, src=src, group=group)
        same = same & torch.equal(first, x)
    return bool(all_agree(same, mesh, axis))


# --------------------------------------------------------------------------
# the distributed GNN path's tensor collectives over one mesh axis
# --------------------------------------------------------------------------

# the backend ops gloo does not carry on card tensors, staged through host
# buffers (tools/gloo_probe.py): isend / irecv abort the process
GLOO_STAGED = frozenset({"send_recv"})

_STATS: dict = {}
_TIMING = [False]


def reset_wire_stats(timing: bool = False) -> None:
    """Zero this process's :func:`wire_stats`; ``timing`` syncs the
    device before and after every collective, so its ms is the wire's
    alone."""
    _STATS.clear()
    _TIMING[0] = bool(timing)


def wire_stats() -> dict:
    """``{op: {"calls", "bytes", "staged_bytes", "ms"}}`` since the last
    :func:`reset_wire_stats`, ops named as the reference's collectives
    (``all_gather``, ``psum_scatter``, ``pmax``, ``psum``, ``ppermute``,
    ``all_to_all``)."""
    return {k: dict(v) for k, v in _STATS.items()}


class _Wire:
    """Times one collective and adds it to :func:`wire_stats`."""

    def __init__(self, op: str, t: torch.Tensor):
        self.op, self.dev = op, t.device
        self.staged = 0

    def _sync(self):
        if _TIMING[0] and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        ms = (time.perf_counter() - self.t0) * 1e3
        st = _STATS.setdefault(self.op, dict(calls=0, bytes=0,
                                             staged_bytes=0, ms=0.0))
        st["calls"] += 1
        st["bytes"] += self.bytes
        st["staged_bytes"] += self.staged
        st["ms"] += ms
        return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gathered(x: torch.Tensor, mesh, axis: str, op: str) -> torch.Tensor:
    """``(n, *x.shape)``: every rank's ``x`` of the axis, in axis order."""
    n, group = axis_size(mesh, axis), mesh.group(axis)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    with _Wire(op, x) as w:
        w.bytes = _nbytes(out)
        dist.all_gather_into_tensor(out, x, group=group)
    return out.view((n,) + tuple(x.shape))


def _gather_rows(x, mesh, axis):
    if mesh.group(axis) is None:
        return x
    g = _gathered(x, mesh, axis, "all_gather")
    return g.reshape((-1,) + tuple(x.shape[1:]))


def _scatter_sum(x, mesh, axis):
    """This rank's block of the axis-wide sum of ``x`` (dim 0 cut into
    ``n`` blocks): the blocks exchanged by one ``all_to_all_single``,
    then summed here in rank order."""
    n, group = axis_size(mesh, axis), mesh.group(axis)
    if group is None:
        return x
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: {x.shape[0]} rows over {n} ranks")
    x = x.contiguous()
    got = torch.empty_like(x)
    with _Wire("psum_scatter", x) as w:
        w.bytes = _nbytes(got)
        dist.all_to_all_single(got, x, group=group)
    return got.view((n, x.shape[0] // n) + tuple(x.shape[1:])).sum(
        0, dtype=x.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather_rows(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.mesh, ctx.axis), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _scatter_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.mesh, ctx.axis), None, None


class _AxisSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _gathered(x, mesh, axis, "psum").sum(0, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return (_gathered(g, ctx.mesh, ctx.axis, "psum").sum(0, dtype=g.dtype),
                None, None)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` stacked on dim 0, in axis order
    (``jax.lax.all_gather(..., tiled=True)``). Differentiable: the
    backward is :func:`psum_scatter`."""
    if mesh.group(axis) is None:
        return x
    return _AllGather.apply(x, mesh, axis)


def psum_scatter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's ``1/n`` of dim 0 of the sum of ``x`` over ``axis``
    (``jax.lax.psum_scatter(..., tiled=True)``); dim 0 divides by the
    axis size. Differentiable: the backward is :func:`all_gather`."""
    if mesh.group(axis) is None:
        return x
    return _PsumScatter.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis``, without a gradient."""
    if mesh.group(axis) is None:
        return x.detach()
    return _gathered(x.detach(), mesh, axis, "pmax").amax(0)


def axis_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise sum of ``x`` over ``axis`` (``jax.lax.psum`` of
    one tensor), in rank order. Differentiable: the backward sums the
    ranks' gradients the same way."""
    if mesh.group(axis) is None:
        return x
    return _AxisSum.apply(x, mesh, axis)


def _axis_total(x, mesh, axis):
    """The sum of every rank's ``x`` over ``axis``, in rank order."""
    g = _gathered(x.reshape(1) if x.dim() == 0 else x, mesh, axis, "psum")
    return g.sum(0, dtype=x.dtype).reshape(x.shape)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _axis_total(g, ctx.mesh, ctx.axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _axis_total(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_axis(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Megatron's ``f``: ``x`` unchanged forward; backward, the sum of the
    ranks' gradients over ``axis`` (an axis name or a tuple of names),
    in rank order, so every rank gets the same bits. Put it on the
    replicated input of a product whose columns are split over the
    axis: each rank's gradient is its columns' share."""
    for a in _axes(axis):
        if mesh.group(a) is not None:
            x = _CopyToAxis.apply(x, mesh, a)
    return x


def reduce_from_axis(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Megatron's ``g``: the sum of the ranks' ``x`` over ``axis``, in
    rank order (the same bits on every rank); backward, the gradient
    unchanged. Put it on the partial output of a product whose rows are
    split over the axis."""
    for a in _axes(axis):
        if mesh.group(a) is not None:
            x = _ReduceFromAxis.apply(x, mesh, a)
    return x


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def gather_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` joined along ``dim``, in axis order
    (``all_gather(..., axis=dim, tiled=True)``); not differentiable."""
    if mesh.group(axis) is None:
        return x
    moved = x.detach().movedim(dim, 0).contiguous()
    g = _gathered(moved, mesh, axis, "all_gather")
    return g.reshape((-1,) + tuple(moved.shape[1:])).movedim(0, dim)


def _block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over the {n} ranks of {axis!r}")
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * step, step).contiguous()


class _SplitToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _block(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, *ctx.args), None, None, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, *ctx.args), None, None, None


def split_to_axis(x: torch.Tensor, mesh, axis: str, dim: int
                  ) -> torch.Tensor:
    """This rank's block of dim ``dim`` of a tensor every rank of ``axis``
    holds whole (block ``i`` of ``n`` on the axis's ``i``-th rank).
    Backward, the ranks' block gradients gathered along ``dim``
    (:func:`gather_dim`): each block's gradient comes from its rank
    alone, so the gathered gradient is the whole one, on every rank."""
    if mesh.group(axis) is None:
        return x
    return _SplitToAxis.apply(x, mesh, axis, dim)


def gather_from_axis(x: torch.Tensor, mesh, axis: str, dim: int
                     ) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` joined along ``dim``, in axis order
    (:func:`gather_dim`, differentiable). Backward, this rank's block of
    the gradient, without a sum: the gathered tensor feeds the same
    replicated computation on every rank, so every rank already holds
    the whole gradient (a sum would scale it by the axis size)."""
    if mesh.group(axis) is None:
        return x
    return _GatherFromAxis.apply(x, mesh, axis, dim)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    with _Wire("all_to_all", x) as w:
        w.bytes = _nbytes(out)
        dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, mesh, axis: str, groups=None
               ) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, axis_index_groups=groups)``:
    dim 0 cut into ``n`` equal blocks, ``n`` the size of this rank's group
    (the whole axis, or its part of ``groups``, the reference's lists of
    axis indices; :meth:`~repro_torch.dist.mesh.Mesh.axis_group`); block
    ``i`` goes to the group's ``i``-th rank, and block ``i`` of the
    result came from it. One ``all_to_all_single``, which gloo carries on
    card tensors. Differentiable: with equal blocks the exchange is its
    own transpose, so the backward is the same exchange of the
    gradients."""
    group = mesh.axis_group(axis, groups)
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: {x.shape[0]} blocks over a group "
                         f"of {n}")
    return _AllToAll.apply(x, group)


def compressed_psum_scatter(x: torch.Tensor, mesh, axis: str, *,
                            mean: bool = False) -> torch.Tensor:
    """The int8 reduce-scatter: :func:`psum_scatter` with
    :func:`compressed_psum`'s wire. amax = the max over the ranks of
    ``|x|``, int8 quantize onto amax / 127, the int32 reduce-scatter,
    one dequantize; the error of an element is at most ``n`` quanta
    (``n`` rounding errors sum). Not differentiable."""
    if mesh.group(axis) is None:
        return x
    xf = x.detach().float()
    amax = pmax(xf.abs().amax().reshape(1), mesh, axis)[0]
    q, scale = int8_compress(xf, amax=amax)
    out = int8_decompress(_scatter_sum(q.to(torch.int32), mesh, axis),
                          scale)
    if mean:
        out = out / axis_size(mesh, axis)
    return out.to(x.dtype)


def _ppermute(h: torch.Tensor, mesh, axis: str, shift: int = -1
              ) -> torch.Tensor:
    """Send ``h`` to the rank ``shift`` places along the axis's ring and
    return what the rank ``shift`` places back sent (one ring hop; by
    default to the previous rank, from the next); staged through host
    buffers where gloo would carry card tensors."""
    group, n, me = mesh.group(axis), axis_size(mesh, axis), \
        mesh.index(axis)
    to = dist.get_global_rank(group, (me + shift) % n)
    frm = dist.get_global_rank(group, (me - shift) % n)
    staged = h.device.type == "cuda" and mesh.backend == "gloo" and \
        "send_recv" in GLOO_STAGED
    h = h.contiguous()
    with _Wire("ppermute", h) as w:
        src = h.cpu() if staged else h
        got = torch.empty_like(src)
        w.bytes = _nbytes(got)
        if staged:
            w.staged = 2 * _nbytes(got)
        ops = [dist.P2POp(dist.isend, src, to, group=group),
               dist.P2POp(dist.irecv, got, frm, group=group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            got = got.to(h.device)
    return got


def ring_allgather_matmul(block_fn: Callable[[int], torch.Tensor],
                          h_loc: torch.Tensor, mesh, axis: str
                          ) -> torch.Tensor:
    """``sum_src block_fn(src) @ H_rows(src)`` with H rotated around the
    axis's ring: ``block_fn(src)`` is this rank's ``(rows, cols_shard)``
    block for ring position ``src``, ``h_loc`` this rank's ``(cols_shard,
    K)`` rows of H. At step ``t`` the buffer holds rank ``(me + t) % n``'s
    rows, received from the next rank; ``n - 1`` hops, and the whole H
    is never held at once. Not differentiable."""
    n, me = axis_size(mesh, axis), mesh.index(axis)
    h, acc = h_loc, None
    for step in range(n):
        contrib = block_fn((me + step) % n) @ h
        acc = contrib if acc is None else acc + contrib
        if step + 1 < n:
            h = _ppermute(h, mesh, axis)
    return acc
