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
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_cuda", "flash_attention_plain", "HEAD_DIMS"]

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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None
                         ) -> torch.Tensor:
    """(B, Hq, S, D) attention on the card through the hand kernel. q (B,
    Hq, S, D), k / v (B, Hkv, T, D), S <= T, Hq % Hkv == 0, D in
    :data:`HEAD_DIMS`, all contiguous, all bf16 or all fp32. ``window``
    None disables the window. Scores are scaled by 1 / sqrt(D). Counts its
    launches in ``flash_attention_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load_kernel("flash_attention")
    fn = getattr(lib, f"flash_attention_{_DTYPES[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * hq, hq, hkv, s, t, d, int(causal), int(window is not None),
                0 if window is None else int(window), 1.0 / d ** 0.5,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
