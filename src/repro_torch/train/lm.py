"""LM train step and serving step factories (``src/repro/train/lm.py``):
plain callables over the port's transformer (PyTorch runs eagerly; there
is nothing to jit).

``make_train_step`` builds the reference's update: gradients (averaged
over ``accum`` microbatches, accumulated in fp32), the expert replicas'
gradients tied, optional int8 error-feedback compression of the
gradients at the optimizer boundary, then AdamW with fp32 moments over
the params' dtype and global-norm clipping. On the card the forward and
backward run the hand kernels (``kernels/ops.py``).

The reference donates the state to its jitted step. The port updates the
state's params and moments in place (``opt.update_in_place``, leaf by
leaf in slices), so no tree of fp32 updates is ever whole: the values
equal ``opt.update`` + ``apply_updates`` on the same grads. The step
declares that to :class:`~repro_torch.train.fault_tolerance.ResilientLoop`:
its ``in_place`` flag is set just before the first write, so a step that
fails after it is never saved as an emergency checkpoint.

Data parallelism (``make_train_step(sync_axis=, mesh=)``,
:func:`make_data_parallel_step`) runs one process a rank over a
``repro_torch.dist.Mesh``: each rank takes its slice of the global
batch, and the gradients are reduced over the mesh axis by the
hand-written collective (``dist.collectives.sync_grads``) before the
optimizer, so the replicated state gets the same update on every rank.

Tensor and expert parallelism (``make_train_state(mesh=)``,
``make_train_step(mesh=)``) run over a ``('data', 'model')`` mesh: a
rank holds its slices of the params and moments by the rules
(``dist.partition.param_shardings``), takes its rows of the global
batch, runs the step under ``with mesh:`` (the layers call the
``'model'`` collectives), syncs the gradients over ``'data'`` within its
``'model'`` coordinate, and clips by the whole tree's norm.
:func:`shaped_batch`, :func:`shaped_state` and :func:`shaped_cache` give
``meta`` tensors of a rank's shapes, each with its ``.sharding``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import axis_size, pmean, sync_grads
from repro_torch.dist.partition import (batch_shardings, cache_shardings,
                                        param_shardings, shard_params)
from repro_torch.dist.sharding import Sharding
from repro_torch.models.lm import transformer as T
from repro_torch.models.lm.layers import dtype_of
from repro_torch.models.lm.moe import tie_expert_replica_grads
from repro_torch.optim import adamw
from repro_torch.optim.compression import (ef_compress_update, ef_init,
                                           int8_decompress)
from repro_torch.optim.optimizer import global_norm, tree_leaves, tree_map
from repro_torch.train.fault_tolerance import InPlaceUpdate

__all__ = ["TrainState", "make_train_state", "make_train_step",
           "make_data_parallel_step", "loss_and_grads", "make_prefill_step",
           "make_decode_step", "shaped_batch", "shaped_state",
           "shaped_cache", "full_param_shapes"]

_EF_MODEL = ("int8 error feedback over a 'model' axis (the int8 scale of a "
             "split leaf needs the absmax over 'model') is not ported "
             "(ROADMAP.md queue 1, item 5b.5)")


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    ef: Any          # error-feedback residuals or None


def _model_split(mesh) -> bool:
    return mesh is not None and int(mesh.shape.get("model", 1)) > 1


def full_param_shapes(cfg: ModelConfig) -> dict:
    """The whole params as ``meta`` tensors (shapes and dtypes)."""
    return T.init_params(cfg, None, device="meta")


def make_train_state(cfg: ModelConfig, generator: torch.Generator, opt, *,
                     compression: bool = False, device="cuda",
                     mesh=None) -> TrainState:
    """Random params from ``generator`` on ``device``, the optimizer's
    zero state and, with ``compression``, zero EF residuals. With
    ``mesh``: the whole params drawn from ``generator`` on the mesh's
    device and this rank's slices kept (bitwise the one-rank state's
    slices), the moments zero in those shapes."""
    if mesh is not None:
        if compression and _model_split(mesh):
            raise NotImplementedError(f"make_train_state: {_EF_MODEL}")
        params = shard_params(mesh, T.init_params(cfg, generator,
                                                  mesh.device))
    else:
        params = T.init_params(cfg, generator, device)
    ef = ef_init(params) if compression else None
    return TrainState(params=params, opt_state=opt.init(params), ef=ef)


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict) -> tuple:
    """-> (loss, metrics, grads): ``T.loss_fn`` and its gradient in every
    param (a tree like ``params``, in the params' dtypes)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = tree_leaves(leaves)
    with torch.enable_grad():
        loss, metrics = T.loss_fn(cfg, leaves, batch)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for g, p in zip(gs, flat))
    grads = tree_map(lambda _: next(it), leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _microbatches(batch: dict, accum: int) -> list:
    out = [{} for _ in range(accum)]
    for key, val in batch.items():
        if val.shape[0] % accum:
            raise ValueError(f"batch of {val.shape[0]} does not split into "
                             f"{accum} microbatches")
        for i, part in enumerate(val.reshape(accum, val.shape[0] // accum,
                                             *val.shape[1:])):
            out[i][key] = part
    return out


def make_train_step(cfg: ModelConfig, *, lr=3e-4, weight_decay: float = 0.1,
                    clip_norm: float = 1.0, accum: int = 1,
                    compression: bool = False, sync_axis=None, mesh=None):
    """Returns (step_fn, opt). ``step_fn(state, batch) -> (state,
    metrics)``: ``batch`` is ``{"tokens", "targets"}`` ((B, S) int
    tensors on the params' device; :func:`shaped_batch` names each
    family's keys: ``frames`` for audio, ``image_emb`` beside the tokens
    for vlm), metrics ``loss``, ``xent``, ``aux``
    and ``grad_norm`` (device scalars; the norm is the global norm of the
    gradients the optimizer receives, before clipping). The order is the
    reference's: gradients (averaged over ``accum`` microbatches in fp32)
    -> tied expert replicas -> int8 error feedback (``compression``) ->
    AdamW with clipping. The step takes the state over, as the reference
    donates it: params and moments are updated in place, and the returned
    state holds the same tensors; ``step_fn.in_place`` (an
    ``InPlaceUpdate``) is set just before the first write.

    ``sync_axis`` (an axis name of ``mesh``, a ``repro_torch.dist.Mesh``)
    is the reference's explicit data-parallel mode: this rank's step on
    its own batch, the gradients reduced over the axis after the replica
    tie and before ``in_place.begin()`` (the exact fp32 mean, or with
    ``compression`` the int8 shared-scale wire of
    ``dist.collectives.compressed_psum``; the wire quantizer is
    stateless, so the error-feedback residuals are left untouched in this
    mode), the loss and metrics averaged over the axis. Every rank of the
    axis must call the step.

    ``mesh`` without ``sync_axis`` is the tensor- and expert-parallel
    step (the reference's GSPMD step): the state holds this rank's slices
    (:func:`make_train_state` with the mesh), ``batch`` this rank's rows
    of the global batch (its block of the ``'data'`` axis); the step runs
    under ``with mesh:``, the experts' replicas are tied across ranks,
    the gradients are synced over ``'data'`` (fp32) within each
    ``'model'`` coordinate, the loss and metrics averaged over
    ``'data'``, and the clip norm is the whole tree's. ``compression``
    with a ``'model'`` axis raises. Every rank of the mesh must call
    the step."""
    if sync_axis is not None and mesh is None:
        raise ValueError(f"make_train_step(sync_axis={sync_axis!r}) needs "
                         "the mesh the axis belongs to (mesh=...)")
    sharded = mesh is not None and sync_axis is None
    if sharded and compression and _model_split(mesh):
        raise NotImplementedError(f"make_train_step: {_EF_MODEL}")
    opt = adamw(lr, weight_decay=weight_decay, clip_norm=clip_norm,
                state_dtype=torch.float32)
    shardings = param_shardings(mesh, full_param_shapes(cfg)) \
        if sharded else None

    def step(state: TrainState, batch: dict):
        if not sharded:
            return _step(state, batch)
        with mesh:
            return _step(state, batch)

    def _step(state: TrainState, batch: dict):
        if accum == 1:
            loss, metrics, grads = loss_and_grads(cfg, state.params, batch)
        else:
            grads, loss = None, 0.0
            for mb in _microbatches(batch, accum):
                l_mb, _, g = loss_and_grads(cfg, state.params, mb)
                if grads is None:
                    grads = tree_map(lambda x: x.float(), g)
                else:
                    tree_map(lambda a, x: a.add_(x), grads, g)
                loss = loss + l_mb
                del g
            grads = tree_map(lambda a: a / accum, grads)
            loss = loss / accum
            metrics = {"xent": loss,
                       "aux": torch.zeros((), device=loss.device)}
        grads = tie_expert_replica_grads(cfg, grads)
        ef = state.ef
        axis = "data" if sharded else sync_axis
        if axis is not None:
            grads = sync_grads(grads, mesh, axis,
                               wire="int8" if compression else "fp32")
            keys = sorted(metrics)
            avg = pmean(torch.stack([loss.float()] + [
                metrics[k].float() for k in keys]), mesh, axis)
            loss = avg[0]
            metrics = {k: avg[i + 1] for i, k in enumerate(keys)}
        elif compression:
            qtree, ef = ef_compress_update(grads, ef)
            grads = tree_map(lambda _, qs: int8_decompress(*qs), grads,
                             qtree)
        norm = global_norm(grads, shardings)
        in_place.begin()
        opt_state = opt.update_in_place(grads, state.opt_state,
                                        state.params, norm)
        metrics = dict(metrics, loss=loss, grad_norm=norm)
        return TrainState(state.params, opt_state, ef), metrics

    in_place = step.in_place = InPlaceUpdate()
    return step, opt


def make_data_parallel_step(cfg: ModelConfig, mesh, *, axis: str = "data",
                            **kw):
    """:func:`make_train_step` in the reference's data-parallel call
    contract: returns ``(step_fn, opt)`` with ``step_fn(state,
    global_batch) -> (state, metrics)``, where every rank of ``mesh``
    passes the same global batch and its replicated state, takes its
    slice of the batch's leading dim (rank ``i`` of ``n`` the ``i``-th
    of ``n`` equal parts; the batch size must divide by the axis size)
    and the gradients are reduced over ``axis`` inside the step (fp32,
    or the int8 wire with ``compression=True``). Pure data parallelism:
    parameters are replicated over the whole mesh."""
    if mesh is None:
        raise ValueError("make_data_parallel_step needs the mesh "
                         "(repro_torch.dist.make_data_mesh)")
    step, opt = make_train_step(cfg, sync_axis=axis, mesh=mesh, **kw)
    n, i = axis_size(mesh, axis), mesh.index(axis)

    def dp_step(state: TrainState, batch: dict):
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"a global batch of {b} does not split over "
                             f"the {n} ranks of the {axis!r} axis")
        part = b // n
        return step(state, {k: v[i * part:(i + 1) * part]
                            for k, v in batch.items()})

    dp_step.in_place = step.in_place
    return dp_step, opt


def make_prefill_step(cfg: ModelConfig, capacity: int):
    def pre(params, batch):
        return T.prefill(cfg, params, batch, capacity)
    return pre


def make_decode_step(cfg: ModelConfig):
    def dec(params, cache, tokens):
        return T.decode_step(cfg, params, cache, tokens)
    return dec


def _with_shardings(tree: dict, shardings: dict) -> dict:
    """``meta`` tensors of each leaf's local shape, carrying its sharding
    as ``.sharding``."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _with_shardings(val, shardings[key])
            continue
        sh = shardings[key]
        t = torch.empty(sh.local_shape(val.shape), dtype=val.dtype,
                        device="meta")
        t.sharding = sh
        out[key] = t
    return out


def shaped_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
                 mesh=None, rules=None) -> dict:
    """The batch ``make_train_step`` takes for ``cfg`` at ``seq_len``
    positions, as tensors on the ``meta`` device (shapes and dtypes, no
    storage), with the reference's keys: audio ``frames`` (B, S,
    d_model) in the config's dtype and ``targets``; vlm ``tokens`` and
    ``targets`` of ``seq_len - n_prefix_tokens`` and ``image_emb`` (B,
    n_prefix_tokens, d_model); the others ``tokens`` and ``targets``;
    ints int32. With ``mesh`` (a rank's ``Mesh``, or the shape-only
    production mesh), each tensor has this rank's shape by
    ``dist.partition.batch_shardings`` and carries that sharding as
    ``.sharding``."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    i32, dt = torch.int32, dtype_of(cfg)
    if cfg.family == "audio":
        b = {"frames": spec((batch_size, seq_len, cfg.d_model), dt),
             "targets": spec((batch_size, seq_len), i32)}
    elif cfg.family == "vlm":
        text = seq_len - cfg.n_prefix_tokens
        b = {"tokens": spec((batch_size, text), i32),
             "image_emb": spec((batch_size, cfg.n_prefix_tokens,
                                cfg.d_model), dt),
             "targets": spec((batch_size, text), i32)}
    else:
        b = {"tokens": spec((batch_size, seq_len), i32),
             "targets": spec((batch_size, seq_len), i32)}
    if mesh is None:
        return b
    return _with_shardings(b, batch_shardings(mesh, b, rules))


def shaped_state(cfg: ModelConfig, opt, mesh=None,
                 compression: bool = False, rules=None) -> TrainState:
    """The :class:`TrainState` of ``cfg`` as ``meta`` tensors; with
    ``mesh``, this rank's slices' shapes, each leaf carrying its
    ``.sharding`` (the moments and residuals their param's)."""
    params = full_param_shapes(cfg)
    ef = ef_init(params) if compression else None
    state = TrainState(params=params, opt_state=opt.init(params), ef=ef)
    if mesh is None:
        return state
    sh = param_shardings(mesh, params, rules)
    local = lambda t: _with_shardings(t, sh) if t is not None \
        else None                                           # noqa: E731
    state.opt_state.step.sharding = Sharding(mesh, ())   # replicated
    return TrainState(params=local(params), opt_state=state.opt_state._replace(
        mu=local(state.opt_state.mu), nu=local(state.opt_state.nu)),
        ef=local(ef))


def shaped_cache(cfg: ModelConfig, batch_size: int, capacity: int,
                 mesh=None, rules=None) -> dict:
    """The decode cache of ``cfg`` as ``meta`` tensors; with ``mesh``,
    this rank's shapes by ``dist.partition.cache_shardings``, each with
    its ``.sharding``."""
    cache = T.init_cache(cfg, batch_size, capacity, device="meta")
    if mesh is None:
        return cache
    return _with_shardings(cache, cache_shardings(mesh, cache, rules))
