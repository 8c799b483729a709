"""MoE layer: top-k routing + expert GLU-MLP through the sparse dispatch.

The single-device path of the reference (``_moe_einsum``): route the
flattened tokens, remap onto replica-major expert slots, and run the
expert GLU over the (E, C, D) dispatch buffer. The three grouped
products go through ``kernels.ops.ragged_gemm`` (``moe_mlp``): the hand
kernel on the card, its plain version, the reference's XLA route, on
the CPU; the reference's einsum computes the same function.

Weights are stored (E·R, D, F) with R = replicas; the train step ties
the replicas' gradients (:func:`tie_expert_replica_grads`) so the copies
stay equal. Not ported yet: the manual expert-parallel path
(``_moe_manual``, an all-to-all over the expert-parallel group; ROADMAP
queue 1, item 5b).
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch as D
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


def tie_expert_replica_grads(cfg, grads: dict) -> dict:
    """Sum the gradients of each expert's R replicas, so tied copies stay
    identical: every ``wg`` / ``wu`` / ``wd`` leaf under a ``moe`` key,
    stacked (L, E·R, ...), gets the sum of its R slices of E experts in
    each slice. Other leaves, and configs with one replica, pass
    through."""
    r, e = cfg.n_expert_replicas, cfg.n_experts
    if r <= 1 or not e:
        return grads

    def walk(tree, under_moe):
        out = {}
        for key, g in tree.items():
            if isinstance(g, dict):
                out[key] = walk(g, under_moe or key == "moe")
            elif under_moe and key in ("wg", "wu", "wd"):
                parts = [g[:, i * e:(i + 1) * e] for i in range(r)]
                tied = sum(parts[1:], parts[0])
                out[key] = torch.cat([tied] * r, dim=1)
            else:
                out[key] = g
        return out
    return walk(grads, False)


def _moe_einsum(cfg, p: dict, x: torch.Tensor):
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    logits = flat.float() @ p["router"]
    r = D.route_topk(logits, cfg.top_k, capacity_factor=cfg.capacity_factor)
    r = D.expand_replicas(r, cfg.n_expert_replicas)
    out = D.moe_mlp(flat, r, p["wg"], p["wu"], p["wd"], act=act_fn(cfg))
    return out.reshape(b, s, d), r.aux_loss


def moe_layer(cfg, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (out, aux_loss)."""
    return _moe_einsum(cfg, p, x)
