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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import transformer as T
from repro_torch.models.lm.moe import tie_expert_replica_grads
from repro_torch.optim import adamw
from repro_torch.optim.compression import (ef_compress_update, ef_init,
                                           int8_decompress)
from repro_torch.optim.optimizer import global_norm, tree_leaves, tree_map
from repro_torch.train.fault_tolerance import InPlaceUpdate

__all__ = ["TrainState", "make_train_state", "make_train_step",
           "make_data_parallel_step", "loss_and_grads", "make_prefill_step",
           "make_decode_step"]

_DISTRIBUTED = ("data-parallel steps are not ported yet (ROADMAP.md queue "
                "1, item 5: distributed)")


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    ef: Any          # error-feedback residuals or None


def make_train_state(cfg: ModelConfig, generator: torch.Generator, opt, *,
                     compression: bool = False, device="cuda") -> TrainState:
    """Random params from ``generator`` on ``device``, the optimizer's
    zero state and, with ``compression``, zero EF residuals."""
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
                    compression: bool = False, sync_axis=None):
    """Returns (step_fn, opt). ``step_fn(state, batch) -> (state,
    metrics)``: ``batch`` is ``{"tokens", "targets"}`` ((B, S) int
    tensors on the params' device), metrics ``loss``, ``xent``, ``aux``
    and ``grad_norm`` (device scalars; the norm is the global norm of the
    gradients the optimizer receives, before clipping). The order is the
    reference's: gradients (averaged over ``accum`` microbatches in fp32)
    -> tied expert replicas -> int8 error feedback (``compression``) ->
    AdamW with clipping. The step takes the state over, as the reference
    donates it: params and moments are updated in place, and the returned
    state holds the same tensors; ``step_fn.in_place`` (an
    ``InPlaceUpdate``) is set just before the first write. ``sync_axis``
    (the reference's data-parallel mode) raises NotImplementedError."""
    if sync_axis is not None:
        raise NotImplementedError(f"make_train_step(sync_axis=...): "
                                  f"{_DISTRIBUTED}")
    opt = adamw(lr, weight_decay=weight_decay, clip_norm=clip_norm,
                state_dtype=torch.float32)

    def step(state: TrainState, batch: dict):
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
        if compression:
            qtree, ef = ef_compress_update(grads, ef)
            grads = tree_map(lambda _, qs: int8_decompress(*qs), grads,
                             qtree)
        norm = global_norm(grads)
        in_place.begin()
        opt_state = opt.update_in_place(grads, state.opt_state,
                                        state.params, norm)
        metrics = dict(metrics, loss=loss, grad_norm=norm)
        return TrainState(state.params, opt_state, ef), metrics

    in_place = step.in_place = InPlaceUpdate()
    return step, opt


def make_data_parallel_step(cfg: ModelConfig, mesh=None, **kw):
    """The reference's ``shard_map`` data-parallel step: not ported."""
    raise NotImplementedError(f"make_data_parallel_step: {_DISTRIBUTED}")


def make_prefill_step(cfg: ModelConfig, capacity: int):
    def pre(params, batch):
        return T.prefill(cfg, params, batch, capacity)
    return pre


def make_decode_step(cfg: ModelConfig):
    def dec(params, cache, tokens):
        return T.decode_step(cfg, params, cache, tokens)
    return dec
