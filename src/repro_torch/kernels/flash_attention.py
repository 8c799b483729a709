"""Causal / sliding-window flash attention with GQA (LM prefill): the
hand-written CUDA kernel and its plain PyTorch version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the Hopper
replacement of the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``): queries aligned to the end of
the KV axis, online softmax in fp32, KV heads shared by ``Hq / Hkv``
query heads without repetition in memory, fully masked KV tiles skipped.
In bf16 one CTA owns one (batch x query head, 128-query tile) pair: a
producer warp stages Q, K and V with TMA into a ring of shared memory,
two warpgroups of 64 queries run both products on ``wgmma`` and keep the
accumulator and the softmax state in registers across the KV tiles it
keeps. The fp32 instance keeps a CUDA-core design (64 queries a CTA).
The kernel scales the fp32 product, as the Pallas kernel does;
``flash_attention_plain`` is the port of ``chunked_attention``, the
reference's route off the TPU, which scales q in q's dtype first. In
bf16 the two differ by that rounding.

For training, ``flash_attention_cuda(..., return_lse=True)`` also
returns the fp32 row log-sum-exp of the scaled scores (both instances
write it; serving asks for none), and ``flash_attention_plain_lse`` is
the plain twin. ``flash_attention_bwd_cuda`` launches
``csrc/flash_attention_bwd.cu``, the gradient (dq, dk, dv): a port-only
kernel, since the reference differentiates ``chunked_attention`` in XLA
and its Pallas kernel has no ``custom_vjp``. It recomputes P from the
LSE in fixed-order tiles, without atomics, so two launches give the same
bits; ``flash_attention_bwd_plain`` is the same math in PyTorch over KV
chunks.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_cuda", "flash_attention_plain",
           "flash_attention_plain_lse", "flash_attention_bwd_cuda",
           "flash_attention_bwd_plain", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128)      # the kernel's instances
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_Q_TILE, _GRID_Y = 64, 65_535


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None
                          ) -> torch.Tensor:
    """Plain PyTorch flash attention: ``chunked_attention`` (KV chunks of
    1024 with a running max and sum, the reference's XLA route)."""
    from repro_torch.models.lm.attention import chunked_attention
    return chunked_attention(q, k, v, causal=causal, window=window)


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None) -> tuple:
    """:func:`flash_attention_plain` and the fp32 (B, Hq, S) row
    log-sum-exp of the scaled scores."""
    from repro_torch.models.lm.attention import chunked_attention
    return chunked_attention(q, k, v, causal=causal, window=window,
                             return_lse=True)


def _check_operands(q, k, v):
    """Raise unless q (B, Hq, S, D) and k / v (B, Hkv, T, D) are what the
    kernels take: CUDA, bf16 or fp32, contiguous and 16-byte aligned,
    S <= T, Hq % Hkv == 0, D in :data:`HEAD_DIMS`, within the grid."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q must be a CUDA tensor, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q must be bf16 or fp32, got "
                         f"{q.dtype}")
    for name, arr in (("q", q), ("k", k), ("v", v)):
        if arr.device != q.device or arr.dtype != q.dtype or \
                arr.dim() != 4 or not arr.is_contiguous() or \
                arr.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"16-byte aligned 4-D {q.dtype} tensor on "
                             f"{q.device}, got {arr.dtype} "
                             f"{tuple(arr.shape)} on {arr.device}")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, t, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k and v must be (B, Hkv, T, D) "
                         f"= ({b}, Hkv, T, {d}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq = {hq} is not a multiple of "
                         f"Hkv = {hkv}")
    if s > t:
        raise ValueError(f"flash_attention: S = {s} queries exceed T = {t} "
                         f"keys (queries are aligned to the end of the KV "
                         f"axis)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not built "
                         f"({HEAD_DIMS})")
    if b * hq >= 2 ** 31 or -(-s // _Q_TILE) > _GRID_Y or t >= 2 ** 31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} exceeds "
                         f"the launch grid")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         return_lse: bool = False):
    """(B, Hq, S, D) attention on the card through the hand kernel. q (B,
    Hq, S, D), k / v (B, Hkv, T, D), S <= T, Hq % Hkv == 0, D in
    :data:`HEAD_DIMS`, all contiguous, all bf16 or all fp32. ``window``
    None disables the window. Scores are scaled by 1 / sqrt(D). With
    ``return_lse`` -> (out, lse), lse the fp32 (B, Hq, S) row log-sum-exp
    of the scaled scores. Counts its launches in
    ``flash_attention_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    _check_operands(q, k, v)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lib = load_kernel("flash_attention")
    fn = getattr(lib, f"flash_attention_{_DTYPES[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b * hq, hq, hkv, s, t, d, int(causal), int(window is not None),
                0 if window is None else int(window), 1.0 / d ** 0.5,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              chunk: int = 1024) -> tuple:
    """Plain PyTorch gradient of flash attention, the kernel's math over KV
    chunks: P = exp(scale q . k - lse) on kept pairs, D = rowsum(dO o O),
    dS = P (dO . v - D); dv = P^T dO, dk = scale dS^T q, dq = scale dS k,
    summed over each KV head's query heads. Products in fp32 with the
    scale on the fp32 product, P and dS rounded to the inputs' dtype as
    operands (the kernel's bf16 operands); -> (dq, dk, dv) in q's
    dtype."""
    b, hq, s, d = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    g = hq // n_kv
    dt = q.dtype
    scale = 1.0 / d ** 0.5
    qg = q.reshape(b, n_kv, g, s, d).float()
    dog = do.reshape(b, n_kv, g, s, d).float()
    lseg = lse.reshape(b, n_kv, g, s, 1)
    delta = (dog * o.reshape(b, n_kv, g, s, d).float()).sum(-1, keepdim=True)
    q_pos = (t - s) + torch.arange(s, device=q.device)
    dq = torch.zeros_like(qg)
    dk = torch.empty((b, n_kv, t, d), dtype=dt, device=q.device)
    dv = torch.empty_like(dk)
    for lo in range(0, t, chunk):
        hi = min(lo + chunk, t)
        kc, vc = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        k_pos = torch.arange(lo, hi, device=q.device)
        mask = torch.ones((s, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        sc = torch.einsum("bkgsd,bktd->bkgst", qg, kc) * scale
        p = torch.where(mask, torch.exp(sc - lseg), 0.0)
        dp = torch.einsum("bkgsd,bktd->bkgst", dog, vc)
        ds = (p * (dp - delta)).to(dt).float()
        dv[:, :, lo:hi] = torch.einsum("bkgst,bkgsd->bktd",
                                       p.to(dt).float(), dog).to(dt)
        dk[:, :, lo:hi] = (torch.einsum("bkgst,bkgsd->bktd", ds, qg)
                           * scale).to(dt)
        dq += torch.einsum("bkgst,bktd->bkgsd", ds, kc)
    return (dq * scale).reshape(b, hq, s, d).to(dt), dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int | None = None
                             ) -> tuple:
    """(dq, dk, dv) of flash attention on the card through the hand
    kernel (``csrc/flash_attention_bwd.cu``): q, k, v as
    :func:`flash_attention_cuda` takes them, o and do like q, lse the
    forward's fp32 (B, Hq, S) row log-sum-exp; all contiguous. Counts its
    calls (three launches each: the row dot products dO . O, then dK and
    dV, then dQ) in ``flash_attention_bwd_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    _check_operands(q, k, v)
    for name, arr in (("o", o), ("do", do)):
        if arr.shape != q.shape or arr.dtype != q.dtype or \
                arr.device != q.device or not arr.is_contiguous() or \
                arr.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous 16-byte aligned {q.dtype} tensor "
                             f"shaped like q {tuple(q.shape)}, got "
                             f"{arr.dtype} {tuple(arr.shape)}")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (b, hq, s) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"fp32 ({b}, {hq}, {s}) tensor, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if -(-t // 64) > _GRID_Y or b * hkv >= 2 ** 31:
        raise ValueError(f"flash_attention_bwd: shape {tuple(k.shape)} "
                         f"exceeds the launch grid")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = load_kernel("flash_attention_bwd")
    fn = getattr(lib, f"flash_attention_bwd_{_DTYPES[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * hq, hq, hkv,
                s, t, d, int(causal), int(window is not None),
                0 if window is None else int(window), 1.0 / d ** 0.5,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{rc}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
