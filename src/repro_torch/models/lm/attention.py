"""Attention: GQA with RoPE, the chunked (flash-style) prefill path and
rolling-buffer KV-cache decode.

``chunked_attention`` walks KV chunks with a running max and sum, so the
S x T score matrix never exists whole; it is the plain version of the
flash attention kernel (``kernels/flash_attention.py``), which the
prefill block calls through ``kernels.ops.flash_attention`` for full
and sliding-window layers alike (the reference's ``banded_attention`` is
the same masked softmax; the kernel skips the KV tiles outside the
band and the sink prefix). ``decode_attention`` is one token against the
rolling buffer; it is no kernel in the reference either. Both take the
reference's ``meta_len``: the first ``meta_len`` keys (hymba's meta
tokens) are attention sinks, never window-masked, still causal.

GQA is computed in grouped form (B, KV, G, S, D): KV heads are never
repeated in memory. Products take fp32 operands (bf16 widens exactly) and
accumulate in fp32, as the reference's ``preferred_element_type``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["chunked_attention", "decode_attention", "KVSlice"]

_NEG = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, KV, G, S, D)"""
    b, hq, s, d = q.shape
    return q.reshape(b, n_kv, hq // n_kv, s, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      chunk: int = 1024, return_lse: bool = False,
                      meta_len: int = 0):
    """q: (B, Hq, S, D); k/v: (B, KV, T, D); q positions end-aligned to T.
    Returns (B, Hq, S, D) in q's dtype, and with ``return_lse`` also the
    fp32 (B, Hq, S) log-sum-exp of each row's scaled scores (-inf for a
    row with no kept key). q is scaled by 1 / sqrt(D) in its own dtype
    first, as the reference scales it. ``window`` None disables
    windowing; the first ``meta_len`` keys are sinks, visible whatever
    the window says (subject to causality)."""
    b, hq, s, d = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    qg = (_group(q, n_kv) * (1.0 / d ** 0.5)).float()   # (B, KV, G, S, D)
    chunk = min(chunk, t)
    g = hq // n_kv
    q_pos = (t - s) + torch.arange(s, device=q.device)
    m = torch.full((b, n_kv, g, s), _NEG, dtype=torch.float32,
                   device=q.device)
    z = torch.zeros((b, n_kv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, s, d), dtype=torch.float32,
                      device=q.device)
    # the reference pads the last chunk and masks the pad; a short last
    # chunk is the same sum
    for lo in range(0, t, chunk):
        hi = min(lo + chunk, t)
        kc, vc = k[:, :, lo:hi], v[:, :, lo:hi]
        s_blk = torch.einsum("bkgsd,bktd->bkgst", qg, kc.float())
        k_pos = torch.arange(lo, hi, device=q.device)
        mask = torch.ones((s, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            in_win = k_pos[None, :] > q_pos[:, None] - window
            if meta_len:
                in_win |= (k_pos < meta_len)[None, :]
            mask &= in_win
        s_blk = torch.where(mask, s_blk, _NEG)
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s_blk - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        z = z * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,bktd->bkgsd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(z, min=1e-30)[..., None]
    out = out.reshape(b, hq, s, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(z)).reshape(b, hq, s)
    return out


class KVSlice(NamedTuple):
    """One layer's rolling KV buffer + slot metadata."""
    k: torch.Tensor          # (B, KV, C, D)
    v: torch.Tensor          # (B, KV, C, D)
    slot_pos: torch.Tensor   # (B, C) int32 absolute position in each slot,
                             # -1 if empty


def decode_attention(q: torch.Tensor, kv: KVSlice, pos: torch.Tensor, *,
                     window: int, meta_len: int = 0) -> torch.Tensor:
    """One-token attention against a rolling buffer.

    q: (B, Hq, 1, D); pos: (B,) the new token's absolute position;
    window: int (FULL_ATTN_WINDOW for full attention). The new token's K/V
    must already be in the buffer. Slots holding positions < meta_len are
    sinks (never window-masked)."""
    b, hq, _, d = q.shape
    n_kv = kv.k.shape[1]
    qg = _group(q, n_kv)[:, :, :, 0]                 # (B, KV, G, D)
    s = torch.einsum("bkgd,bkcd->bkgc", qg.float(), kv.k.float()) / d ** 0.5
    in_win = kv.slot_pos > pos[:, None] - int(window)
    if meta_len:
        in_win |= kv.slot_pos < meta_len
    valid = (kv.slot_pos >= 0) & (kv.slot_pos <= pos[:, None]) & in_win
    s = torch.where(valid[:, None, None], s, _NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bkcd->bkgd", w.to(kv.v.dtype).float(),
                       kv.v.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)
