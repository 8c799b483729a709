"""The collectives of data-parallel training (``src/repro/dist/
collectives.py``): the gradient sync, its int8 wire, the unanimity bit.

The reference runs these inside a ``shard_map`` body and takes a mesh
axis *name*; here each rank is a process and the functions take the
rank's :class:`~repro_torch.dist.mesh.Mesh` and the axis name. Every
rank of the axis must issue the same collectives in the same order.
Leaves are nested dicts of tensors (``optim.optimizer.tree_map``).

``sync_grads`` with ``wire='fp32'`` is an ``all_reduce`` sum, then a
divide by the axis size, in each leaf's own dtype. ``wire='int8'``
composes :func:`compressed_psum`: the leaf's absmax max-reduced, so
every rank quantizes onto one grid (``optim.compression.int8_compress``
with ``amax=``), the int8 values summed as int32, dequantized once, then
divided. A collective over an axis whose group is None (a one-rank mesh
without a process group) is an identity.

The reference's ``compressed_psum_scatter`` and ``ring_allgather_matmul``
(the distributed SpMM's reduce-scatter and ring) wait for ROADMAP.md
queue 1, item 5b: gloo, which reduces where ranks share a card, runs
neither on card tensors.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.optim.compression import int8_compress, int8_decompress
from repro_torch.optim.optimizer import tree_leaves, tree_map

__all__ = ["axis_size", "all_agree", "psum", "pmean", "compressed_psum",
           "sync_grads", "wire_bytes", "replicas_equal"]


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
