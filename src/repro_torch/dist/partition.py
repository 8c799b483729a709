"""Partition tables for the LM stack: ``LM_RULES``, each leaf's logical
axes, the ``*_shardings`` builders, and a rank's slices of the params
(``src/repro/dist/partition.py``).

``LM_RULES`` is the reference's baseline mapping onto the production
meshes (``'pod'`` x ``'data'`` x ``'model'``): ``batch`` over ``('pod',
'data')``; ``d_ff``, ``d_inner``, ``vocab``, ``qkv``, ``heads``,
``kv_heads`` and ``experts`` over ``'model'``; ``seq`` and ``d_model``
whole (``override(seq="model")`` is the reference's sequence-parallel
rule set, which the port's layers refuse). :data:`WHOLE_ATTENTION_RULES`
keeps the attention whole on every rank (``qkv``, ``heads`` and
``kv_heads`` unsplit; the experts and the vocabulary still split): the
rule set of a ``'model'`` axis wider than the KV heads, which the
default rules would cut (``transformer._head_split`` raises there).
The builders take the active rules (``dist.sharding.use_rules``) unless
given others, as the layers do.

The builders map nested dicts (params, a ``TrainState``'s params and
moments, batches, decode caches) to matching trees of
:class:`~repro_torch.dist.sharding.Sharding`; leaves are classified by
their path, so the optimizer moments, whose trees mirror the params,
take the params' layout. :func:`shard_params` takes full params (the
port's tensors, or the numpy arrays ``transformer.params_from_jax``
takes) to this rank's slices, :func:`gather_params` back: how weights
cross from the JAX package to a sharded port, and how a sharded run's
checkpoint keeps the one-rank format.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import Rules, Sharding, current_rules, \
    grid_axes, resolve_spec

__all__ = ["LM_RULES", "WHOLE_ATTENTION_RULES", "param_logical_axes",
           "param_shardings", "state_shardings", "batch_shardings",
           "cache_shardings", "graph2d_shardings", "shard_params",
           "gather_params"]


LM_RULES = Rules({
    "batch": ("pod", "data"),
    "seq": (),
    "d_model": (),
    "d_ff": ("model",),
    "d_inner": ("model",),
    "vocab": ("model",),
    "qkv": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "expert_capacity": (),
    "d_state": (),
})

WHOLE_ATTENTION_RULES = LM_RULES.override(qkv=(), heads=(), kv_heads=())


# Trailing-dim logical axes per parameter leaf name
# (``models/lm/layers.PARAM_AXES`` holds the GLU MLP's). Leaves under the
# stacked "layers" subtree carry one more leading (n_layers,) dim, padded
# with None. Unlisted leaves (norm scales, the router, the SSD's scalars)
# replicate.
_LEAF_AXES: dict = {
    "embed": ("vocab", "d_model"),
    "lm_head": ("d_model", "vocab"),
    "meta": (None, "d_model"),
    "wq": ("d_model", "qkv"),
    "wk": ("d_model", "qkv"),
    "wv": ("d_model", "qkv"),
    "bq": ("qkv",),
    "bk": ("qkv",),
    "bv": ("qkv",),
    "wo": ("qkv", "d_model"),
    "wg": ("d_model", "d_ff"),
    "wu": ("d_model", "d_ff"),
    "wd": ("d_ff", "d_model"),
    "in_proj": ("d_model", "d_inner"),
    "out_proj": ("d_inner", "d_model"),
}


def param_logical_axes(path, leaf) -> tuple:
    """Logical axes of one (possibly layer-stacked) parameter leaf;
    ``path`` is its keys from the root (``("layers", "moe", "wg")``)."""
    ndim = len(leaf.shape)
    keys = list(path)
    name = keys[-1] if keys else None
    base = _LEAF_AXES.get(name)
    if base is None:
        return (None,) * ndim
    if "moe" in keys and name in ("wg", "wu", "wd"):
        base = ("experts",) + base      # stacked (E·R, D, F) expert weights
    if len(base) > ndim:                # e.g. a name collision: replicate
        return (None,) * ndim
    return (None,) * (ndim - len(base)) + tuple(base)


def _sharding(mesh, axes, leaf, rules) -> Sharding:
    ndim = len(leaf.shape)
    axes = tuple(axes)[:ndim] + (None,) * max(0, ndim - len(axes))
    return Sharding(mesh, resolve_spec(axes, mesh, tuple(leaf.shape),
                                       rules))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if tree is None:
        return None
    return fn(path, tree)


def param_shardings(mesh, params, rules: Optional[Rules] = None):
    """Params tree -> matching tree of :class:`Sharding`."""
    rules = rules or current_rules()
    return _map_with_path(
        lambda p, l: _sharding(mesh, param_logical_axes(p, l), l, rules),
        params)


def state_shardings(mesh, state, rules: Optional[Rules] = None):
    """A ``TrainState`` (params, AdamW moments, EF residuals) -> the same
    structure of shardings; moments and residuals take their param's."""
    return param_shardings(mesh, state, rules)


def batch_shardings(mesh, batch: dict, rules: Optional[Rules] = None
                    ) -> dict:
    """Batch dict -> {key: Sharding}: dim 0 the global batch, dim 1 the
    sequence, further dims whole."""
    rules = rules or current_rules()
    return {k: _sharding(mesh, ("batch", "seq"), v, rules)
            for k, v in batch.items()}


# decode cache: (L, B, KV, capacity, head_dim) buffers split over batch
# and KV heads; positions and slot maps over batch
_CACHE_AXES: dict = {
    "pos": ("batch",),
    "k": (None, "batch", "kv_heads", None, None),
    "v": (None, "batch", "kv_heads", None, None),
    "slot_pos": ("batch", None),
    "ssm_state": (None, "batch", "heads", None, None),
    "conv_buf": (None, "batch", None, None),
}


def cache_shardings(mesh, cache: dict, rules: Optional[Rules] = None
                    ) -> dict:
    """Decode-cache dict -> {key: Sharding}."""
    rules = rules or current_rules()
    return {k: _sharding(mesh, _CACHE_AXES.get(k, ()), v, rules)
            for k, v in cache.items()}


def graph2d_shardings(mesh, g):
    """A 2-D vertex-cut partition's arrays -> matching shardings: every
    leaf is tile-stacked (or row-major) on dim 0, split over the grid's
    two axes together (``dist.gnn2d.Graph2D.local`` takes the same
    block). ``g`` is a dict tree or a dataclass of arrays."""
    row_ax, col_ax = grid_axes(mesh)

    def one(_, leaf):
        return Sharding(mesh, ((row_ax, col_ax),) + (None,) * (
            len(leaf.shape) - 1))
    if isinstance(g, dict):
        return _map_with_path(one, g)
    import dataclasses
    return {f.name: one(None, getattr(g, f.name))
            for f in dataclasses.fields(g)
            if hasattr(getattr(g, f.name), "shape")}


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def shard_params(mesh, params, rules: Optional[Rules] = None, *,
                 device=None) -> dict:
    """Full params (tensors, or numpy arrays as ``params_from_jax`` takes
    them) -> this rank's slices by :func:`param_shardings`, contiguous,
    on ``device`` (default: the mesh's)."""
    dev = mesh.device if device is None else torch.device(device)
    sh = param_shardings(mesh, params, rules)

    def one(x, s):
        part = s.local(_as_tensor(x))
        # a copy of its own: the slice must not hold the full leaf alive
        return torch.empty(part.shape, dtype=part.dtype,
                           device=dev).copy_(part)
    return _tree_zip(one, params, sh)


def gather_params(mesh, params, like, rules: Optional[Rules] = None
                  ) -> dict:
    """This rank's slices -> the full params on every rank, by the
    shardings of ``like`` (the full params' shapes: tensors, ``meta``
    tensors or anything with a ``shape``); all-gathers over the split
    axes, so every rank calls it."""
    return _tree_zip(lambda x, s: s.gather(x) if s.is_split else x,
                     params, param_shardings(mesh, like, rules))


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)
