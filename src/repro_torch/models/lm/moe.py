"""MoE layer: top-k routing + expert GLU-MLP through the sparse dispatch.

The single-device path of the reference (``_moe_einsum``): route the
flattened tokens, remap onto replica-major expert slots, and run the
expert GLU over the (E, C, D) dispatch buffer. The three grouped
products go through ``kernels.ops.ragged_gemm`` (``moe_mlp``): the hand
kernel on the card, its plain version, the reference's XLA route, on
the CPU; the reference's einsum computes the same function.

Weights are stored (E·R, D, F) with R = replicas; the train step ties
the replicas' gradients (:func:`tie_expert_replica_grads`) so the copies
stay equal.

Under an active mesh whose rules split the expert stacks (``experts``
over ``'model'``, or else ``d_ff``), the einsum route runs split: every
rank routes every token (the routing is replicated), a rank dispatches
only its own experts' rows (no rank builds the whole (E·R, C, D)
buffer) or, with ``d_ff`` split, computes its columns of every expert;
``moe_mlp``'s three ragged GEMMs run over the rank's groups, the local
slots are combined, then ``reduce_from_axis`` sums the ranks' parts.
The router is replicated but its gradient through the kept gates is
this rank's share only, so the gates are recomputed from the logits
through ``copy_to_axis`` (``dispatch.topk_gates``: the same bits), which
sums that share over the ranks; the load-balancing loss's gradient is
whole on every rank and is not summed. Not ported yet: the manual
expert-parallel path (``_moe_manual``, an all-to-all over the
expert-parallel group; ROADMAP queue 1, item 5b.2).
"""
from __future__ import annotations

import torch

import dataclasses

from repro_torch.core import dispatch as D
from repro_torch.dist.collectives import (copy_to_axis, gather_dim,
                                          reduce_from_axis)
from repro_torch.dist.mesh import current_mesh
from repro_torch.dist.sharding import Sharding, split_axes
from repro_torch.models.lm.layers import (act_fn, dtype_of,
                                          truncated_normal_init)

__all__ = ["init_moe", "moe_layer", "tie_expert_replica_grads"]


def init_moe(generator: torch.Generator, cfg, device="cuda") -> dict:
    dt = dtype_of(cfg)
    e, r, d, f = cfg.n_experts, cfg.n_expert_replicas, cfg.d_model, cfg.d_ff

    def rep(w):                      # replicate expert slices R times
        return torch.cat([w] * r, dim=0) if r > 1 else w

    return {
        "router": truncated_normal_init(generator, (d, e), 1.0,
                                        torch.float32, device),
        "wg": rep(truncated_normal_init(generator, (e, d, f), 1.0, dt,
                                        device)),
        "wu": rep(truncated_normal_init(generator, (e, d, f), 1.0, dt,
                                        device)),
        "wd": rep(truncated_normal_init(generator, (e, f, d), 1.0, dt,
                                        device)),
    }


_EXPERT_AXES = ("experts", "d_model", "d_ff")


def expert_split(cfg) -> tuple:
    """How the active mesh and rules split the (E·R, D, F) expert stacks:
    ``("experts", axes)``, ``("d_ff", axes)`` or ``(None, ())``."""
    shape = (cfg.n_experts * cfg.n_expert_replicas, cfg.d_model, cfg.d_ff)
    for dim, kind in ((0, "experts"), (2, "d_ff")):
        axes = split_axes(_EXPERT_AXES, shape, dim)
        if axes:
            return kind, axes
    return None, ()


def tie_expert_replica_grads(cfg, grads: dict) -> dict:
    """Sum the gradients of each expert's R replicas, so tied copies stay
    identical: every ``wg`` / ``wu`` / ``wd`` leaf under a ``moe`` key,
    stacked (L, E·R, ...), gets the sum of its R slices of E experts in
    each slice. Other leaves, and configs with one replica, pass
    through. Where the active mesh splits the experts over ranks, an
    expert's replicas may sit on different ranks: the leaf is gathered
    over the experts' axes, tied, and this rank's slots kept."""
    r, e = cfg.n_expert_replicas, cfg.n_experts
    if r <= 1 or not e:
        return grads
    kind, axes = expert_split(cfg)
    mesh = current_mesh()

    def tie(g):
        if kind == "experts":
            for a in reversed(axes):
                g = gather_dim(g, mesh, a, 1)
        parts = [g[:, i * e:(i + 1) * e] for i in range(r)]
        tied = torch.cat([sum(parts[1:], parts[0])] * r, dim=1)
        if kind == "experts":
            tied = Sharding(mesh, (None, axes)).local(tied).contiguous()
        return tied

    def walk(tree, under_moe):
        out = {}
        for key, g in tree.items():
            if isinstance(g, dict):
                out[key] = walk(g, under_moe or key == "moe")
            elif under_moe and key in ("wg", "wu", "wd"):
                out[key] = tie(g)
            else:
                out[key] = g
        return out
    return walk(grads, False)


def _moe_einsum(cfg, p: dict, x: torch.Tensor):
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    logits = flat.float() @ p["router"]
    r = D.route_topk(logits, cfg.top_k, capacity_factor=cfg.capacity_factor)
    kind, axes = expert_split(cfg)
    experts = None
    if kind is not None:
        mesh = current_mesh()
        r = dataclasses.replace(r, gates=D.topk_gates(
            copy_to_axis(logits, mesh, axes), r.expert_idx))
        flat = copy_to_axis(flat, mesh, axes)
        if kind == "experts":
            n_local = p["wg"].shape[0]
            experts = (Sharding(mesh, (axes,)).block(0) * n_local, n_local)
    r = D.expand_replicas(r, cfg.n_expert_replicas)
    out = D.moe_mlp(flat, r, p["wg"], p["wu"], p["wd"], act=act_fn(cfg),
                    experts=experts)
    if kind is not None:
        out = reduce_from_axis(out, mesh, axes)
    return out.reshape(b, s, d), r.aux_loss


def moe_layer(cfg, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (out, aux_loss)."""
    return _moe_einsum(cfg, p, x)
