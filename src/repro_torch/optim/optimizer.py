"""AdamW with the reference's update (``src/repro/optim/optimizer.py``).

Functional, like the reference: ``opt.init(params) -> state`` and
``opt.update(grads, state, params) -> (updates, state)``, then
:func:`apply_updates`. Params, grads and moments are nested dicts of
tensors (the port's stand-in for a pytree). The update is bias-corrected
with decoupled weight decay on the pre-step parameter:

    u = -lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "AdamWState", "adamw", "apply_updates", "tree_map"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params)


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32 on the params' device, as the reference
    mu: Any
    nu: Any


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts with the same keys."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def adamw(lr: float, *, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params) -> AdamWState:
        leaves: list = []
        tree_map(leaves.append, params)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        # the step count and the bias corrections live on the device, so a
        # caller can hold the step with ``torch.where`` without a host sync;
        # the corrections are fp32, as the reference computes them (c2 at
        # step 1 is 1 - fp32(0.999): 1.3e-5 off the exact 0.001)
        step = state.step + 1
        t = step.to(torch.float32)
        base = lambda b: torch.full((), b, dtype=torch.float32,   # noqa: E731
                                    device=t.device)
        c1 = 1.0 - torch.pow(base(b1), t)
        c2 = 1.0 - torch.pow(base(b2), t)
        mu = tree_map(lambda g, m: b1 * m + (1 - b1) * g, grads, state.mu)
        nu = tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(g), grads,
                  state.nu)
        updates = tree_map(
            lambda m, v, p: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                                   + weight_decay * p),
            mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)
