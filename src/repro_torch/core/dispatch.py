"""MoE token dispatch/combine expressed as sparse operators.

As in the reference, the token → expert-slot assignment is a sparse
(one-hot-valued) matrix P of shape (E·C, T): dispatch is P @ X and combine
is Pᵀ(gates) @ Y. Shapes are static (capacity-padded) and ``moe_mlp``
pads every expert's rows to a multiple of ``tm``, so each ``tm``-row tile
of the (E·C, D) buffer belongs to one expert and the ragged GEMM kernel
(``kernels/ops.ragged_gemm``) runs dense tiles.

``as_coo_matrices`` exposes the literal sparse matrices, on the port's
``core/sparse`` COO, so dispatch-as-SpMM can be checked against the
scatter.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["RouteInfo", "route_topk", "topk_gates", "dispatch", "combine",
           "moe_mlp", "as_coo_matrices", "expand_replicas"]


@dataclasses.dataclass(frozen=True)
class RouteInfo:
    """Static-shape routing decision for one batch of T tokens."""
    expert_idx: torch.Tensor   # (T, k) int32
    gates: torch.Tensor        # (T, k) float
    pos: torch.Tensor          # (T, k) int32 — slot within the expert
    keep: torch.Tensor         # (T, k) bool  — dropped if over capacity
    aux_loss: torch.Tensor     # load-balancing loss (scalar)
    capacity: int
    num_experts: int


def _slot_positions(slots: torch.Tensor, n: int):
    """Exclusive running count of each flat (token, choice) pair's slot,
    in the row-major (T, k) order: its position within the slot; and the
    pairs per slot. The one-hot is built (slot, pair)-major, so the scan
    runs along the contiguous axis (an outer-axis scan over T*k rows is
    slow on the card), and without ``one_hot``/``bincount``, which read
    the ids back to the host."""
    hit = (slots[None, :] == torch.arange(n, dtype=slots.dtype,
                                          device=slots.device)[:, None]
           ).to(torch.int32)                                   # (n, T*k)
    before = torch.cumsum(hit, dim=1, dtype=torch.int32) - hit
    return (before * hit).sum(dim=0, dtype=torch.int32), hit.sum(dim=1)


def route_topk(logits: torch.Tensor, k: int, *, capacity_factor: float = 1.25,
               tm: int = 128, renormalize: bool = True) -> RouteInfo:
    """Top-k routing with capacity padded to a multiple of ``tm``. Ties in
    the top-k keep ``torch.topk``'s sorted order (random fp32 logits make
    them improbable; the reference's ``lax.top_k`` takes the lower
    index)."""
    t, e = logits.shape
    gates_all = torch.softmax(logits.float(), dim=-1)
    top_g, top_i = torch.topk(gates_all, k, dim=-1, sorted=True)
    top_i = top_i.to(torch.int32)
    if renormalize:
        top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)

    cap = int(-(-(t * k * capacity_factor / e) // tm) * tm)   # round up
    cap = max(cap, tm)

    pos, counts = _slot_positions(top_i.reshape(-1), e)
    pos = pos.reshape(t, k)
    keep = pos < cap

    me = gates_all.mean(dim=0)                                    # (E,)
    ce = counts.float() / (t * k)
    aux = e * torch.sum(me * ce)

    return RouteInfo(expert_idx=top_i, gates=top_g.to(logits.dtype),
                     pos=pos, keep=keep, aux_loss=aux,
                     capacity=cap, num_experts=e)


def topk_gates(logits: torch.Tensor, expert_idx: torch.Tensor
               ) -> torch.Tensor:
    """The kept, renormalized gates of :func:`route_topk` recomputed from
    ``logits`` at its ``expert_idx`` (logical experts, before
    ``expand_replicas``): the same values, bit for bit, through another
    autograd path (the expert-parallel MoE sums this path's gradient
    over the ranks)."""
    gates_all = torch.softmax(logits.float(), dim=-1)
    g = gates_all.gather(-1, expert_idx.long())
    g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
    return g.to(logits.dtype)


def expand_replicas(r: RouteInfo, reps: int) -> RouteInfo:
    """Remap logical experts onto replica-major storage slots (slot =
    rep·E + e, rep round-robin over tokens), the reference's layout of
    (E·R, D, F) weights. The capacity per slot is rounded to 8, as the
    reference rounds it: with ``tm`` = 128 that capacity is not always
    tile-aligned, and ``moe_mlp`` then pads each expert's rows to whole
    tiles."""
    if reps <= 1:
        return r
    t, k = r.expert_idx.shape
    e = r.num_experts
    rep = (torch.arange(t, dtype=torch.int32,
                        device=r.expert_idx.device) % reps)[:, None]
    slots = rep * e + r.expert_idx                              # (T, k)
    n_slots = e * reps
    cap = -(-r.capacity // reps)
    cap = max(-(-cap // 8) * 8, 8)
    pos = _slot_positions(slots.reshape(-1), n_slots)[0].reshape(t, k)
    keep = pos < cap
    return RouteInfo(expert_idx=slots, gates=r.gates, pos=pos, keep=keep,
                     aux_loss=r.aux_loss, capacity=cap, num_experts=n_slots)


def _held(r: RouteInfo, experts) -> tuple:
    """(first expert, experts, kept pairs whose expert is among them)."""
    if experts is None:
        return 0, r.num_experts, r.keep
    lo, n = experts
    return lo, n, r.keep & (r.expert_idx >= lo) & (r.expert_idx < lo + n)


def dispatch(x: torch.Tensor, r: RouteInfo, experts=None) -> torch.Tensor:
    """P @ X: scatter tokens into the (E, C, D) expert buffer. The kept
    pairs' (expert, slot) rows are unique, so their writes are
    deterministic; the dropped pairs all go to one spare row past the
    buffer, which is cut off (the reference adds them as zeros into slot
    (E-1, C-1), which changes nothing). No host sync: no boolean-mask
    indexing. ``experts = (first, n)`` builds only those experts' (n, C,
    D) rows (the expert-parallel MoE: a rank's own experts)."""
    t, d = x.shape
    lo, e, held = _held(r, experts)
    c = r.capacity
    flat = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    row = torch.where(held, (r.expert_idx.long() - lo) * c + r.pos.long(),
                      e * c)
    tok = torch.arange(t, device=x.device)[:, None].expand_as(row)
    flat[row.reshape(-1)] = x[tok.reshape(-1)]
    return flat[:e * c].view(e, c, d)


def combine(y: torch.Tensor, r: RouteInfo, experts=None) -> torch.Tensor:
    """Pᵀ(g) @ Y: gather expert outputs back, weighted by the gates; with
    ``experts = (first, n)``, ``y`` holds those experts' rows and the
    others' pairs weigh 0."""
    lo, _, held = _held(r, experts)
    e_idx = torch.where(held, r.expert_idx - lo, 0).long()
    p_idx = torch.where(held, r.pos, 0).long()
    gathered = y[e_idx, p_idx]                                   # (T, k, F)
    w = torch.where(held, r.gates, torch.zeros_like(r.gates))[..., None]
    return torch.sum(gathered * w.to(y.dtype), dim=1)


def moe_mlp(x: torch.Tensor, r: RouteInfo, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, act=F.silu,
            tm: int = 128, experts=None) -> torch.Tensor:
    """Expert GLU-MLP over the dispatched buffer.

    x: (T, D); w_gate/w_up: (E, D, F); w_down: (E, F, D). Returns (T, D).
    ``experts = (first, n)``: the weights are those n experts' stacks,
    only their rows are dispatched and combined (the others' pairs add
    0), and the products run over n groups.
    The three grouped products go through ``kernels.ops.ragged_gemm``
    (the hand kernel on the card, its plain version, a batched product,
    on the CPU), which needs ``tm``-row tiles of one expert each. A
    capacity C that is not a multiple of ``tm`` (``expand_replicas``
    rounds a replica's capacity to 8) gets each expert's rows padded with
    zero rows up to ``ceil(C / tm) * tm``. ``keep`` (``pos < C``) is
    untouched, so the padding rows are never kept nor combined and the
    drop set is the reference's: the function equals the reference's
    einsum route.

    Differentiable in x, the gates (through ``combine``) and the three
    weights: the buffer's E equal groups of ``c_pad`` rows are what the
    ragged GEMM's weight gradient needs (``n_groups`` = E, from the
    shapes; ``tile_expert`` is never read back to the host).
    """
    from repro_torch.kernels import ops as kops
    buf = dispatch(x, r, experts)                       # (E, C, D)
    e, c, d = buf.shape
    c_pad = -(-c // tm) * tm
    if c_pad != c:
        buf = F.pad(buf, (0, 0, 0, c_pad - c))
    flat = buf.reshape(e * c_pad, d)
    tile_expert = torch.arange(e * (c_pad // tm), dtype=torch.int32,
                               device=x.device) // (c_pad // tm)
    g = kops.ragged_gemm(flat, w_gate, tile_expert, tm=tm, n_groups=e)
    u = kops.ragged_gemm(flat, w_up, tile_expert, tm=tm, n_groups=e)
    y = kops.ragged_gemm(act(g) * u, w_down, tile_expert, tm=tm, n_groups=e)
    return combine(y.reshape(e, c_pad, -1)[:, :c].to(x.dtype), r, experts)


def as_coo_matrices(r: RouteInfo, t: int):
    """Materialize the dispatch/combine operators as literal COO matrices
    (rows = E·C slots, cols = T tokens): dispatch = P @ X with unit values,
    combine = Pᵀ with gate values."""
    from repro_torch.core import sparse as sp

    e_idx = r.expert_idx.cpu().numpy()
    pos = r.pos.cpu().numpy()
    keep = r.keep.cpu().numpy()
    gates = r.gates.float().cpu().numpy()
    tk = e_idx.shape[1]
    tok = np.repeat(np.arange(t), tk)
    ei, pi, kp = e_idx.reshape(-1), pos.reshape(-1), keep.reshape(-1)
    gt = gates.reshape(-1)
    rows = (ei.astype(np.int64) * r.capacity + pi)[kp]
    cols = tok[kp]
    nslots = r.num_experts * r.capacity
    p = sp.coo_from_edges(cols, rows, np.ones(kp.sum(), np.float32),
                          nrows=nslots, ncols=t)
    pt = sp.coo_from_edges(rows, cols, gt[kp].astype(np.float32),
                           nrows=t, ncols=nslots)
    return p, pt
