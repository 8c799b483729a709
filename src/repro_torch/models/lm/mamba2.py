"""Mamba2 SSD (state-space duality) mixer: the chunked train / prefill
path and the recurrent decode path (``src/repro/models/lm/mamba2.py``).

Chunked SSD (Dao & Gu 2024, §6): the sequence is split into Q-token
chunks; within a chunk the dual quadratic (attention-like) form runs as
dense products, across chunks a small (H, P, N) state is carried by a
Python loop of S / Q steps (16 at 4,096 / 256). Decode is the SSM
recurrence proper: O(1) a token with a (B, H, P, N) state and a (B,
d_conv - 1, conv_dim) causal-conv tail.

Plain PyTorch, as the reference is plain XLA (it has no Pallas kernel
here): fp32 inside the SSD, the model dtype where the reference casts
back to it. The depthwise causal conv is ``d_conv`` shifted
multiply-adds in fp32, not ``F.conv1d``, whose cuDNN backward is not
guaranteed to give the same bits twice. n_groups == 1 is asserted (both
SSM configs use 1 group).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm.layers import dtype_of, truncated_normal_init

__all__ = ["init_mamba2", "mamba2_forward", "mamba2_decode", "SSMSlice",
           "ssd_chunked", "ssd_reference"]


class SSMSlice(NamedTuple):
    """One layer's SSM decode cache."""
    state: torch.Tensor      # (B, H, P, N) fp32
    conv_buf: torch.Tensor   # (B, d_conv - 1, conv_dim)


def init_mamba2(generator: torch.Generator, cfg, device="cuda") -> dict:
    """The reference's mixer params: projections in the config's dtype
    (fan-in rule), the conv bias zero, dt_bias / A_log / D / norm_scale
    fp32 (A = -exp(A_log) = -1)."""
    dt = dtype_of(cfg)
    di, h, n, g = cfg.d_inner, cfg.n_ssm_heads, cfg.d_state, cfg.n_groups
    assert g == 1, "n_groups == 1 assumed (both SSM configs)"
    proj_out = 2 * di + 2 * g * n + h

    def f32(fill, width):
        return torch.full((width,), fill, dtype=torch.float32, device=device)
    return {
        "in_proj": truncated_normal_init(generator, (cfg.d_model, proj_out),
                                         1.0, dt, device),
        "conv_w": truncated_normal_init(generator, (cfg.d_conv, cfg.conv_dim),
                                        1.0, dt, device),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dt, device=device),
        "dt_bias": f32(0.0, h), "A_log": f32(0.0, h), "D": f32(1.0, h),
        "norm_scale": f32(1.0, di),
        "out_proj": truncated_normal_init(generator, (di, cfg.d_model), 1.0,
                                          dt, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv in fp32, back in x's dtype. x: (B, S, C);
    w: (W, C): out[t] = sum_k x[t + k - (W - 1)] w[k] + b."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    wf = w.float()
    out = xp[:, :s] * wf[0]
    for k in range(1, width):
        out = out + xp[:, k:k + s] * wf[k]
    return (out + b.float()).to(x.dtype)


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------

def ssd_reference(x, dt, a_coef, b_in, c_in, init_state=None):
    """O(S) sequential oracle. x: (B, S, H, P), dt: (B, S, H), a_coef:
    (H,) < 0, b_in / c_in: (B, S, N). Returns (y fp32, final state)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    st = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state
    xf, dtf, bf, cf = x.float(), dt.float(), b_in.float(), c_in.float()
    ys = []
    for i in range(s):
        dtt = dtf[:, i]                                   # (B, H)
        decay = torch.exp(dtt * a_coef)
        upd = dtt[..., None, None] * xf[:, i, :, :, None] \
            * bf[:, i, None, None, :]                     # (B, H, P, N)
        st = st * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", st, cf[:, i]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros(
        (bsz, 0, h, p), dtype=torch.float32, device=x.device)
    return y, st


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q). Returns L with L[..., i, j] = sum_{j<k<=i} a_k (i >=
    j), -inf above the diagonal."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    ii = torch.arange(q, device=a.device)
    return torch.where(ii[:, None] >= ii[None, :], diff, -torch.inf)


def ssd_chunked(x, dt, a_coef, b_in, c_in, *, chunk: int, init_state=None):
    """Chunked SSD, the same signature and semantics as
    :func:`ssd_reference`. A ragged tail is padded with dt = 0 steps
    (decay 1, update 0: state-neutral) and cut from y."""
    bsz, s_orig, h, p = x.shape
    n = b_in.shape[-1]
    q = min(chunk, s_orig)
    pad = (-s_orig) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q

    xf = x.float().reshape(bsz, nc, q, h, p)
    dtf = dt.float().reshape(bsz, nc, q, h)
    bf = b_in.float().reshape(bsz, nc, q, n)
    cf = c_in.float().reshape(bsz, nc, q, n)

    a_h = (dtf * a_coef).transpose(2, 3)               # (B, NC, H, Q)
    cum = torch.cumsum(a_h, dim=-1)
    xdt = xf * dtf[..., None]                          # B x dt form

    # intra-chunk (the dual quadratic form)
    ell = torch.exp(_segsum(a_h))                      # (B, NC, H, Q, Q)
    scores = torch.einsum("bcin,bcjn->bcij", cf, bf)   # (B, NC, Q, Q)
    w = scores[:, :, None] * ell
    y_diag = torch.einsum("bchij,bcjhp->bcihp", w, xdt)

    # chunk summaries
    decay_to_end = torch.exp(cum[..., -1:] - cum)      # (B, NC, H, Q)
    states = torch.einsum("bchq,bcqn,bcqhp->bchpn", decay_to_end, bf, xdt)

    # inter-chunk recurrence, sequential over the NC chunks
    chunk_decay = torch.exp(cum[..., -1])              # (B, NC, H)
    st = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state
    prev = []
    for c in range(nc):
        prev.append(st)                                # state BEFORE chunk
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)             # (B, NC, H, P, N)

    # inter-chunk contribution
    y_off = torch.einsum("bcqn,bchpn,bchq->bcqhp", cf, prev_states,
                         torch.exp(cum))
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y[:, :s_orig], st


# --------------------------------------------------------------------------
# The whole mixer: forward (train / prefill) and decode
# --------------------------------------------------------------------------

def _split_proj(cfg, zxbcdt):
    di = cfg.d_inner
    return (zxbcdt[..., :di], zxbcdt[..., di:di + cfg.conv_dim],
            zxbcdt[..., di + cfg.conv_dim:])


def _gated_norm(y, z, scale, eps=1e-6):
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale


def mamba2_forward(cfg, p: dict, u: torch.Tensor, *,
                   init_state: SSMSlice | None = None,
                   return_state: bool = False):
    """u: (B, S, d_model) -> (B, S, d_model) [and the final SSMSlice with
    ``return_state``]."""
    bsz, s, _ = u.shape
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    z, xbc, dtp = _split_proj(cfg, u @ p["in_proj"])
    if init_state is not None:
        padded = torch.cat([init_state.conv_buf.to(xbc.dtype), xbc], dim=1)
        xbc_conv = F.silu(_causal_conv(padded, p["conv_w"], p["conv_b"])
                          )[:, -s:]
    else:
        xbc_conv = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    x_in = xbc_conv[..., :di]
    b_in = xbc_conv[..., di:di + n]
    c_in = xbc_conv[..., di + n:di + 2 * n]

    dt = F.softplus(dtp.float() + p["dt_bias"])                  # (B, S, H)
    a_coef = -torch.exp(p["A_log"])                              # (H,)
    xh = x_in.reshape(bsz, s, h, pd)
    y, final = ssd_chunked(xh, dt, a_coef, b_in, c_in, chunk=cfg.ssm_chunk,
                           init_state=None if init_state is None
                           else init_state.state)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = _gated_norm(y.reshape(bsz, s, di), z, p["norm_scale"])
    out = y.to(u.dtype) @ p["out_proj"]
    if not return_state:
        return out
    tail = max(cfg.d_conv - 1, 0)
    buf = xbc[:, s - tail:] if s >= tail else F.pad(
        xbc, (0, 0, tail - s, 0))
    return out, SSMSlice(state=final, conv_buf=buf.to(u.dtype))


def mamba2_decode(cfg, p: dict, u: torch.Tensor, cache: SSMSlice) -> tuple:
    """One-token recurrent step. u: (B, 1, d_model) -> (out, SSMSlice)."""
    bsz = u.shape[0]
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    z, xbc, dtp = _split_proj(cfg, u @ p["in_proj"])             # (B, 1, *)
    window = torch.cat([cache.conv_buf.to(xbc.dtype), xbc], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            p["conv_w"].float()) + p["conv_b"]
    xbc_c = F.silu(conv_out)                                     # (B, C) fp32
    x_in = xbc_c[:, :di].reshape(bsz, h, pd)
    b_in = xbc_c[:, di:di + n]
    c_in = xbc_c[:, di + n:di + 2 * n]

    dt = F.softplus(dtp[:, 0].float() + p["dt_bias"])            # (B, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))
    upd = dt[..., None, None] * x_in[..., None] * b_in[:, None, None, :]
    state = cache.state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_in)
    y = y + p["D"][None, :, None] * x_in
    y = _gated_norm(y.reshape(bsz, 1, di), z, p["norm_scale"])
    out = y.to(u.dtype) @ p["out_proj"]
    return out, SSMSlice(state=state, conv_buf=window[:, 1:].to(u.dtype))
