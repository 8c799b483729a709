"""MoE layer: top-k routing + expert GLU-MLP through the sparse dispatch.

Two routes, taken under the reference's conditions (:func:`moe_layer`):
the manual expert-parallel path (``_moe_manual``) where the active mesh
has a ``'model'`` axis of exactly ``n_experts · n_expert_replicas`` ranks
and the sequence divides over it, and the einsum route otherwise (one
rank, decode's one position, other meshes).

**The einsum route** (the reference's ``_moe_einsum``): route the
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
whole on every rank and is not summed.

**The manual expert-parallel path** (the reference's ``_moe_manual``).
The reference shards the tokens over ``'model'`` by the sequence; the
port's activations are replicated over the ``'model'`` row, so each rank
takes its ``S / model`` block of the sequence (``split_to_axis``), routes
its own tokens (softmax, top-k, renormalised gates), scatters them into
an ``(E, Cs, D)`` send buffer of per-peer slots (``Cs`` = the reference's
per-peer capacity; a peer's slots past ``Cs`` are dropped), exchanges it
with its expert-parallel group (``dist.collectives.all_to_all``: the R
groups of E consecutive model ranks, the reference's
``axis_index_groups``), runs its one resident expert slice densely
(plain products, as the reference's), exchanges the results back,
combines them with the gates and gathers the output's sequence again
(``gather_from_axis``). The router is replicated but each rank's
gradient covers its own tokens only, so it enters through
``copy_to_axis`` (the ranks' shares summed over ``'model'``). The
load-balancing loss sums ``me``, ``ce`` and ``n`` over every mesh axis,
as the reference does, so its value is the whole batch's on every rank;
its backward hands each rank its own tokens' share (the sum of the
shares over the ranks is the whole batch's gradient). A caller that
averages the gradients over ``'data'`` scales the aux term by the
``'data'`` size first, as ``train.lm.make_train_step`` does.

:func:`moe_manual_reference` is the whole manual path in one process
(the ranks looped over, each exchange an indexing), what the tests and
the chip script hold the ranks against.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dispatch as D
from repro_torch.dist.collectives import (all_to_all, copy_to_axis,
                                          gather_dim, gather_from_axis,
                                          reduce_from_axis, split_to_axis,
                                          _axis_total)
from repro_torch.dist.mesh import current_mesh
from repro_torch.dist.sharding import Sharding, split_axes
from repro_torch.models.lm.layers import (act_fn, dtype_of,
                                          truncated_normal_init)

__all__ = ["init_moe", "moe_layer", "tie_expert_replica_grads",
           "moe_manual_reference", "route_manual",
           "manual_capacity", "ep_groups"]


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


# --------------------------------------------------------------------------
# the manual expert-parallel path
# --------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def manual_capacity(cfg, tokens: int) -> int:
    """``Cs``, the slots a rank sends each peer for its ``tokens`` local
    tokens: ``max(round_up(int(T k cf / E), 8), 8)``, as the reference."""
    return max(_round_up(int(tokens * cfg.top_k * cfg.capacity_factor
                             / cfg.n_experts), 8), 8)


def ep_groups(cfg) -> list:
    """The expert-parallel groups of the ``'model'`` axis: the R groups of
    E consecutive model ranks (the reference's ``axis_index_groups``)."""
    e = cfg.n_experts
    return [[g * e + i for i in range(e)]
            for g in range(cfg.n_expert_replicas)]


def route_manual(logits: torch.Tensor, k: int):
    """A rank's routing of its tokens: (probs, top-k gates renormalised,
    top-k experts), fp32. Ties keep ``torch.topk``'s sorted order, as
    ``dispatch.route_topk``."""
    probs = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.topk(probs, k, dim=-1, sorted=True)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    return probs, top_g, top_i


def _dispatch(cfg, flat: torch.Tensor, top_i: torch.Tensor, cs: int):
    """The (E, Cs, D) send buffer of a rank's (T, D) tokens, and where each
    (token, choice) pair went: its peer, its slot, whether it was kept.
    A dropped pair writes zeros to the last slot (the reference's
    clamped scatter)."""
    e, k = cfg.n_experts, cfg.top_k
    t, d = flat.shape
    peer = top_i.reshape(-1)
    pos, _ = D._slot_positions(peer.to(torch.int32), e)
    pos = pos.long()
    keep = pos < cs
    tok = torch.arange(t, device=flat.device).repeat_interleave(k)
    peer_c = torch.where(keep, peer, e - 1)
    pos_c = torch.where(keep, pos, cs - 1)
    vals = torch.where(keep[:, None], flat[tok],
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    send = torch.zeros((e, cs, d), dtype=flat.dtype, device=flat.device
                       ).index_put((peer_c, pos_c), vals, accumulate=True)
    return send, peer_c, pos_c, keep


def _expert(cfg, h_in, wg, wu, wd):
    """The resident expert's GLU on its received rows, densely."""
    return (act_fn(cfg)(h_in @ wg) * (h_in @ wu)) @ wd


def _combine(back, peer_c, pos_c, keep, top_g, t: int):
    """Each token's returned rows, weighted by its gates and summed over
    its k choices (the reference's segment sum over the pairs)."""
    picked = back[peer_c, pos_c]                           # (T k, D)
    w = torch.where(keep, top_g.reshape(-1).to(back.dtype),
                    torch.zeros((), dtype=back.dtype, device=back.device))
    return (picked * w[:, None]).reshape(t, -1, back.shape[-1]).sum(1)


def _aux(e: int, k: int, me, ce, n):
    return e * torch.sum((me / n) * (ce / (n * k)))


def _local_stats(probs, top_i, e: int) -> torch.Tensor:
    """(2E + 1,) fp32: ``me``, ``ce`` and the token count of a rank."""
    ce = (top_i.reshape(-1)[None, :] == torch.arange(
        e, device=top_i.device)[:, None]).sum(1).float()
    n = torch.full((1,), float(probs.shape[0]), device=probs.device)
    return torch.cat([probs.sum(0), ce, n])


class _StatsTotal(torch.autograd.Function):
    """The stats summed over every axis of the mesh, in rank order (the
    same bits on every rank). Backward: this rank's own share of the
    gradient, unsummed: the sum is the same on every rank, so every
    rank's incoming gradient is already the whole one."""

    @staticmethod
    def forward(ctx, v, mesh):
        for a in mesh.shape:
            if mesh.group(a) is not None:
                v = _axis_total(v, mesh, a)
        return v

    @staticmethod
    def backward(ctx, g):
        return g, None


def _manual_ok(cfg, seq: int, mesh) -> bool:
    """Whether the MoE layers take the manual path for a sequence of
    ``seq`` positions under ``mesh`` and the active rules: the
    reference's conditions on the port's rows (sparse dispatch, a
    ``'model'`` axis of exactly ``E · R`` ranks, a sequence that divides
    over it; the batch is already this rank's ``'data'`` rows), and, as
    the port's ranks hold their slices by the rules, the rules split the
    experts over ``'model'`` alone (one slice a rank)."""
    if not cfg.n_experts or not cfg.moe_sparse_dispatch or mesh is None \
            or "model" not in mesh.shape:
        return False
    m = int(mesh.shape["model"])
    if cfg.n_experts * cfg.n_expert_replicas != m:
        return False
    return seq % m == 0 and expert_split(cfg) == ("experts", ("model",))


def _moe_manual(cfg, p: dict, x: torch.Tensor, mesh):
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    x_blk = split_to_axis(x, mesh, "model", 1)             # (B, S/m, D)
    tl = x_blk.shape[0] * x_blk.shape[1]
    flat = x_blk.reshape(tl, d)
    router = copy_to_axis(p["router"], mesh, "model")
    probs, top_g, top_i = route_manual(flat.float() @ router, k)
    cs = manual_capacity(cfg, tl)
    send, peer_c, pos_c, keep = _dispatch(cfg, flat, top_i, cs)
    groups = ep_groups(cfg)
    recv = all_to_all(send, mesh, "model", groups)         # (E, Cs, D)
    y = _expert(cfg, recv.reshape(e * cs, d), p["wg"][0], p["wu"][0],
                p["wd"][0])
    back = all_to_all(y.reshape(e, cs, d).to(x.dtype), mesh, "model",
                      groups)
    out = _combine(back, peer_c, pos_c, keep, top_g.to(x.dtype), tl)
    tot = _StatsTotal.apply(_local_stats(probs, top_i, e), mesh)
    aux = _aux(e, k, tot[:e], tot[e:2 * e], tot[2 * e])
    out = out.reshape(x_blk.shape).to(x.dtype)
    return gather_from_axis(out, mesh, "model", 1), aux


def moe_manual_reference(cfg, p: dict, x: torch.Tensor, model: int,
                         data: int = 1):
    """The manual path of a ``(data, model)`` mesh in one process: ``x``
    the whole (B, S, D) batch, ``p`` the whole params; virtual rank (i, j)
    takes batch block i and sequence block j and holds expert slice j,
    each all-to-all stands in as indexing within the expert-parallel
    groups of each data row, the stats are summed over every virtual
    rank. -> (out (B, S, D), aux): the ranks' results, the same
    arithmetic rank by rank. Differentiable (the whole batch's
    gradients)."""
    e, k = cfg.n_experts, cfg.top_k
    if e * cfg.n_expert_replicas != model:
        raise ValueError(f"{cfg.name}: {e} experts x "
                         f"{cfg.n_expert_replicas} replicas on a 'model' "
                         f"axis of {model}")
    b, s, d = x.shape
    if s % model or b % data:
        raise ValueError(f"(B, S) = ({b}, {s}) over data {data} x model "
                         f"{model}")
    bl, sl = b // data, s // model
    tl = bl * sl
    cs = manual_capacity(cfg, tl)
    rows, stats = [], []
    for i in range(data):
        ranks = []
        for j in range(model):
            flat = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].reshape(tl, d)
            probs, top_g, top_i = route_manual(flat.float() @ p["router"], k)
            send, peer_c, pos_c, keep = _dispatch(cfg, flat, top_i, cs)
            ranks.append((send, peer_c, pos_c, keep, top_g))
            stats.append(_local_stats(probs, top_i, e))
        ys = []
        for j in range(model):
            g0 = (j // e) * e
            recv = torch.stack([ranks[g0 + i][0][j % e] for i in range(e)])
            ys.append(_expert(cfg, recv.reshape(e * cs, d), p["wg"][j],
                              p["wu"][j], p["wd"][j]
                              ).reshape(e, cs, d).to(x.dtype))
        outs = []
        for j in range(model):
            g0 = (j // e) * e
            back = torch.stack([ys[g0 + i][j % e] for i in range(e)])
            send, peer_c, pos_c, keep, top_g = ranks[j]
            outs.append(_combine(back, peer_c, pos_c, keep,
                                 top_g.to(x.dtype), tl
                                 ).reshape(bl, sl, d).to(x.dtype))
        rows.append(torch.cat(outs, dim=1))
    tot = torch.stack(stats).sum(0)
    return torch.cat(rows, dim=0), _aux(e, k, tot[:e], tot[e:2 * e],
                                        tot[2 * e])


def moe_layer(cfg, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (out, aux_loss)."""
    mesh = current_mesh()
    if _manual_ok(cfg, x.shape[1], mesh):
        return _moe_manual(cfg, p, x, mesh)
    return _moe_einsum(cfg, p, x)
