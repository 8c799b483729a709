"""Optimizers with the reference's updates (``src/repro/optim/optimizer.py``).

Functional, like the reference: ``opt.init(params) -> state`` and
``opt.update(grads, state, params) -> (updates, state)``, then
:func:`apply_updates`. Params, grads and states are nested dicts of
tensors (the port's stand-in for a pytree). AdamW is bias-corrected with
decoupled weight decay on the pre-step parameter,

    u = -lr_t * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p),

its moments in the params' dtype unless ``state_dtype`` names another
(fp32 moments over bf16 params, the large-model configuration); grads
and params are cast to the moments' dtype first. ``lr`` is a number or a
schedule ``step -> lr`` (``optim/schedules.py``) called on the device
step count, so no step reads a value back to the host. ``clip_norm``
clips the grads by their global norm before the update.

AdamW's ``update_in_place(grads, state, params, norm=None) -> state``
writes ``update`` + :func:`apply_updates` into the params and moments
themselves, leaf by leaf in slices of at most ``_SLICE`` elements, so no
tree of fp32 updates is ever whole (the LM train step, which takes its
state over as the reference donates it); the same elementwise
arithmetic, so the same values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "AdamWState", "SGDState", "adamw", "sgd",
           "apply_updates", "global_norm", "clip_by_global_norm",
           "tree_map", "tree_leaves"]

_SLICE = 1 << 27         # elements an in-place update handles at a time


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params)
    # (grads, state, params, norm) -> state, params updated in place;
    # AdamW only
    update_in_place: Callable | None = None


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32 on the params' device, as the reference
    mu: Any
    nu: Any


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any           # None without momentum


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts with the same keys."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in ``tree_map``'s order."""
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def _as_schedule(lr) -> Callable:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (a device scalar).

    ``shardings`` (a matching tree of ``dist.sharding.Sharding``; the
    leaves are this rank's slices) gives the norm of the whole tree: the
    squares of the split leaves are summed over their axes (in rank
    order, the same bits on every rank), the replicated leaves counted
    once, so the clip scale is the one-rank step's."""
    sq = lambda x: torch.sum(torch.square(x.float()))   # noqa: E731
    if shardings is None:
        return torch.sqrt(sum(sq(x) for x in tree_leaves(tree)))
    from repro_torch.dist.collectives import reduce_from_axis
    whole, split, meshes = [], {}, []

    def add(x, s):                       # pairs each leaf with its sharding
        axes = tuple(a for i in range(len(s.spec)) for a in s.dim_axes(i)
                     if int(s.mesh.shape[a]) > 1)
        (split.setdefault(axes, []) if axes else whole).append(sq(x))
        meshes.append(s.mesh)
    tree_map(add, tree, shardings)
    total = sum(whole, torch.zeros((), device=tree_leaves(tree)[0].device))
    for axes, parts in sorted(split.items()):
        total = total + reduce_from_axis(sum(parts), meshes[0], axes)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """-> (tree scaled by min(1, max_norm / norm), norm). Each leaf is
    scaled in fp32 and rounded to its own dtype once, as the reference
    does (a bf16 leaf times an fp32 scalar)."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), n


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _step_scalars(step: torch.Tensor, b1: float, b2: float):
    """The bias corrections 1 - b^t, on the device in fp32, as the
    reference computes them (c2 at step 1 is 1 - fp32(0.999): 1.3e-5
    off the exact 0.001). The step stays on the device, so a caller can
    hold it with ``torch.where`` without a host sync."""
    t = step.to(torch.float32)
    base = lambda b: torch.full((), b, dtype=torch.float32,   # noqa: E731
                                device=t.device)
    return 1.0 - torch.pow(base(b1), t), 1.0 - torch.pow(base(b2), t)


def _adamw_leaf(g, m, v, p, *, lr_t, c1, c2, b1, b2, eps, weight_decay):
    """One leaf's AdamW: -> (fp32 update, new m, new v). The moments
    keep their dtype; the fp32 device scalars (lr_t, c1, c2) widen the
    rest to fp32, as the reference's type promotion does (a no-op for
    fp32 moments). ``update`` and ``update_in_place`` both run this, so
    they give the same values."""
    gf = g.to(m.dtype)
    m2 = b1 * m + (1 - b1) * gf
    v2 = b2 * v + (1 - b2) * torch.square(gf)
    u = -lr_t * ((m2.float() / c1) / (torch.sqrt(v2.float() / c2) + eps)
                 + (weight_decay * p.to(m.dtype)).float())
    return u, m2, v2


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype: torch.dtype | None = None,
          clip_norm: float | None = None) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params) -> AdamWState:
        def z(p):
            return torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                               device=p.device)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32,
                             device=tree_leaves(params)[0].device),
            mu=tree_map(z, params), nu=tree_map(z, params))

    def scalars(state: AdamWState):
        step = state.step + 1
        c1, c2 = _step_scalars(step, b1, b2)
        return step, dict(lr_t=sched(step), c1=c1, c2=c2, b1=b1, b2=b2,
                          eps=eps, weight_decay=weight_decay)

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step, kw = scalars(state)
        out = tree_map(lambda g, m, v, p: _adamw_leaf(g, m, v, p, **kw),
                       grads, state.mu, state.nu, params)
        pick = lambda i: tree_map(lambda _, o: o[i], grads, out)  # noqa: E731
        return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2))

    @torch.no_grad()
    def update_in_place(grads, state: AdamWState, params, norm=None):
        """``update`` + ``apply_updates`` written into ``params`` and
        ``state``'s moments; ``norm`` is the grads' global norm when the
        caller has it. Returns the new state (the same moment tensors)."""
        scale = None
        if clip_norm is not None:
            norm = global_norm(grads) if norm is None else norm
            scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
        step, kw = scalars(state)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            g, m, v, p = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
            for lo in range(0, p.numel(), _SLICE):
                sl = slice(lo, lo + _SLICE)
                gs = g[sl]
                if scale is not None:      # clip_by_global_norm's rounding
                    gs = (gs.float() * scale).to(gs.dtype)
                u, m2, v2 = _adamw_leaf(gs, m[sl], v[sl], p[sl], **kw)
                m[sl].copy_(m2)
                v[sl].copy_(v2)
                p[sl].copy_(p[sl] + u.to(p.dtype))
        return AdamWState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update,
                     update_in_place=update_in_place)


def sgd(lr, *, momentum: float = 0.0, nesterov: bool = False,
        clip_norm: float | None = None) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params) -> SGDState:
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return SGDState(step=torch.zeros(
            (), dtype=torch.int32, device=tree_leaves(params)[0].device),
            momentum=mom)

    @torch.no_grad()
    def update(grads, state: SGDState, params):
        del params
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state.momentum,
                           grads)
            eff = tree_map(lambda m, g: momentum * m + g, mom, grads) \
                if nesterov else mom
            return tree_map(lambda e: -lr_t * e.float(), eff), \
                SGDState(step, mom)
        # an fp32 rate times a bf16 grad is fp32 in the reference too
        return tree_map(lambda g: -lr_t * g.float(), grads), \
            SGDState(step, None)

    return Optimizer(init=init, update=update)
