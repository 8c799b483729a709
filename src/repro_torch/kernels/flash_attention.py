"""Causal / sliding-window / non-causal flash attention with GQA (LM
prefill, and hubert's encoder): the hand-written CUDA kernel and its
plain PyTorch version. Every function
here takes ``meta_len``, the reference's attention sinks (hymba's meta
tokens): with a window, the first ``meta_len`` keys stay visible to
every later query. The kernels walk the sink tiles first, then the band
(:func:`flash_kv_walk`; ``csrc/flash_mask.cuh`` states it for both
kernels), and with ``meta_len`` 0 walk exactly the tiles they walked
before sinks.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the Hopper
replacement of the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``): queries aligned to the end of
the KV axis, online softmax in fp32, KV heads shared by ``Hq / Hkv``
query heads without repetition in memory, fully masked KV tiles skipped.
In bf16 one CTA owns one (batch x query head, 128-query tile) pair: a
producer warp stages Q, K and V with TMA into a ring of shared memory,
two warpgroups of 64 queries run both products on ``wgmma`` and keep the
accumulator and the softmax state in registers across the KV tiles it
keeps (tiles of 128 keys, 64 at D = 256, where Q and two stages of K
and V fill 192 KB of shared memory). D = 80 (hubert-xlarge, bf16 only)
runs at its true width in both kernels, as every head dim does: the
160-byte rows sit in shared memory as five 16-column atoms, the products
into O, dV, dK and dQ run N = 80, and the forward's two warpgroups take
turns at the tensor cores, one's products under the other's softmax. The
fp32 instance keeps a CUDA-core design (64 queries a CTA).
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
chunks. :func:`flash_bwd_instance` picks its instance: ``wgmma`` (bf16,
D 64, 80, 128 and 256, the main path: TMA ring, ``wgmma``, dK / dV and dQ
in registers; at D 256 the head dim split across the two warpgroups;
:func:`flash_bwd_tiles`, :func:`flash_bwd_dkdv_tiles`,
:func:`flash_bwd_dq_tiles` and :func:`flash_bwd_tile_test` state its
tile walk), ``wmma`` (bf16, D 32) or ``f32`` (D up to 128).
:func:`flash_bwd_row_floors` gives the rounding floor of each gradient
row for checks against an fp32 oracle. Head dims: :data:`HEAD_DIMS`, 80
for hubert-xlarge (bf16 only), 256 for gemma-7b.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_cuda", "flash_attention_plain",
           "flash_attention_plain_lse", "flash_attention_bwd_cuda",
           "flash_attention_bwd_plain", "flash_bwd_instance",
           "flash_kv_walk", "flash_fwd_turns", "flash_bwd_dkdv_tiles",
           "flash_bwd_dq_tiles", "flash_bwd_tile_test", "flash_bwd_tiles",
           "flash_bwd_row_floors", "HEAD_DIMS", "BF16_ONLY_DIMS",
           "BWD_INSTANCES", "FWD_INSTANCES"]

HEAD_DIMS = (32, 64, 80, 128, 256)     # the kernels' instances
BF16_ONLY_DIMS = (80,)                  # no fp32 instance (hubert-xlarge)
# backward instance -> C entry point of csrc/flash_attention_bwd.cu
BWD_INSTANCES = {"wgmma": "flash_attention_bwd_bf16_wgmma",
                 "wmma": "flash_attention_bwd_bf16",
                 "f32": "flash_attention_bwd_f32"}
# the wgmma backward's tiles at D 64 and 128 (flash_bwd_tiles): (keys a
# CTA, queries a ring stage) of the dK / dV kernel, (queries a CTA, keys a
# ring stage) of the dQ kernel; each CTA's rows are two warpgroups of 64
BWD_KV_TILE, BWD_Q_STEP, BWD_Q_TILE, BWD_KV_STEP = 128, 64, 128, 64
EPS32 = 2.0 ** -24
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# the forward's instance by dtype: bf16 the wgmma design, fp32 CUDA cores
FWD_INSTANCES = {torch.bfloat16: "wgmma", torch.float32: "f32"}
_Q_TILE, _GRID_Y = 64, 65_535


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          meta_len: int = 0) -> torch.Tensor:
    """Plain PyTorch flash attention: ``chunked_attention`` (KV chunks of
    1024 with a running max and sum, the reference's XLA route)."""
    from repro_torch.models.lm.attention import chunked_attention
    return chunked_attention(q, k, v, causal=causal, window=window,
                             meta_len=meta_len)


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None,
                              meta_len: int = 0) -> tuple:
    """:func:`flash_attention_plain` and the fp32 (B, Hq, S) row
    log-sum-exp of the scaled scores."""
    from repro_torch.models.lm.attention import chunked_attention
    return chunked_attention(q, k, v, causal=causal, window=window,
                             return_lse=True, meta_len=meta_len)


def _check_dtype_dim(what: str, dtype: torch.dtype, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not built ({HEAD_DIMS})")
    if dtype == torch.float32 and d in BF16_ONLY_DIMS:
        raise ValueError(f"{what}: fp32 at head dim {d} is not built: D "
                         f"{d} runs only the bf16 instance")


def _kept(kpos, qpos, t: int, causal: bool, window, meta_len: int):
    """The kernels' element mask on (broadcast) position tensors: key
    kpos kept for the query at qpos (``FlashMask::kept``)."""
    ok = kpos < t
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & ((kpos > qpos - window) | (kpos < meta_len))
    return ok


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
    _check_dtype_dim("flash_attention", q.dtype, d)
    if b * hq >= 2 ** 31 or -(-s // _Q_TILE) > _GRID_Y or t >= 2 ** 31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} exceeds "
                         f"the launch grid")


def _check_meta(meta_len) -> None:
    if int(meta_len) != meta_len or meta_len < 0:
        raise ValueError(f"flash_attention: meta_len must be an int >= 0, "
                         f"got {meta_len!r}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         return_lse: bool = False, meta_len: int = 0):
    """(B, Hq, S, D) attention on the card through the hand kernel. q (B,
    Hq, S, D), k / v (B, Hkv, T, D), S <= T, Hq % Hkv == 0, D in
    :data:`HEAD_DIMS` (80 in bf16 only), all contiguous, all bf16 or all
    fp32. ``causal`` False keeps every key (an encoder). ``window``
    None disables the window; with one, the first ``meta_len`` keys are
    sinks. Scores are scaled by 1 / sqrt(D). With
    ``return_lse`` -> (out, lse), lse the fp32 (B, Hq, S) row log-sum-exp
    of the scaled scores. Counts its launches in
    ``flash_attention_cuda.launches`` and by instance (:data:`FWD_INSTANCES`)
    in ``flash_attention_cuda.launches_by_instance``."""
    from repro_torch.kernels.build import load_kernel

    _check_operands(q, k, v)
    _check_meta(meta_len)
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
                0 if window is None else int(window), int(meta_len),
                1.0 / d ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_instance[FWD_INSTANCES[q.dtype]] += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_instance = dict.fromkeys(
    FWD_INSTANCES.values(), 0)


def flash_bwd_instance(dtype: torch.dtype, d: int) -> str:
    """The backward's instance for these operands, from dtype and head dim
    alone: ``wgmma`` for bf16 at D 64, 80, 128 and 256 (80 at its true
    width in 16-column atoms; at 256 the two consumer warpgroups split the head
    dim, each holding 128 columns of dK and dV), ``wmma`` for bf16 at D 32
    (only smoke configs use it), ``f32`` for fp32 at D 32, 64 and 128.
    Raises for fp32 at D 80 (bf16 only) and at D 256, where the CUDA-core
    instance's four padded 64 x 260 fp32 tiles take 260 KB of shared
    memory, above the 227 KB a block can use."""
    _check_dtype_dim("flash_attention_bwd", dtype, d)
    if dtype == torch.float32:
        if d > 128:
            raise ValueError(f"flash_attention_bwd: fp32 at head dim {d} "
                             f"is not built: the CUDA-core instance's four "
                             f"padded 64 x {d + 4} fp32 tiles take "
                             f"{4 * 64 * (d + 4) * 4 // 1024} KB of shared "
                             f"memory, above the 227 KB a block can use "
                             f"(bf16 takes it)")
        return "f32"
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd: q must be bf16 or fp32, "
                         f"got {dtype}")
    return "wmma" if d == 32 else "wgmma"


def flash_bwd_tiles(d: int) -> tuple:
    """The ``wgmma`` backward's tiles at head dim ``d``: (keys a CTA of the
    dK / dV kernel, queries a ring stage there, queries a CTA of the dQ
    kernel, keys a ring stage there). A CTA's rows are warpgroups of 64
    at D 64, 80 and 128; at D 256 one group of 64 whose columns the two
    warpgroups split."""
    if d == 256:
        return 64, 64, 64, 64
    return BWD_KV_TILE, BWD_Q_STEP, BWD_Q_TILE, BWD_KV_STEP


def flash_kv_walk(qlo: int, qhi: int, t: int, causal: bool,
                  window: int | None, bk: int, meta_len: int = 0) -> list:
    """The KV tiles of ``bk`` keys that queries at positions ``qlo ..
    qhi`` walk, in order (``FlashMask::kv_walk``, which the forward and
    the dQ kernels call): with a window, the sink tiles first (those
    below the band holding a key under ``meta_len`` that ``qhi`` may
    see), then the band the causal and window tests keep; no tile
    twice."""
    klo, khi = 0, t - 1
    if causal:
        khi = min(khi, qhi)
    if window is not None:
        klo = max(klo, qlo - window + 1)
    kt0 = klo // bk
    band = list(range(kt0, khi // bk + 1)) if khi >= klo else []
    n_sink = 0
    if window is not None and meta_len > 0 and khi >= 0:
        n_sink = -(-min(meta_len, khi + 1) // bk)
        if band:
            n_sink = min(n_sink, kt0)
    return list(range(n_sink)) + band


def flash_fwd_turns(n_tiles: int, wg: int) -> list:
    """The D 80 forward's schedule for consumer warpgroup ``wg`` (0 or 1)
    of a CTA that walks ``n_tiles`` KV tiles, in its order
    (``flash_attention_wgmma_d80_kernel``): ``("sync", b)`` /
    ``("arrive", b)`` on named barrier b (1 opens warpgroup 0's turn, 2
    warpgroup 1's), ``("s", i)`` S of tile i issued, ``("pv", i)`` P V
    of tile i issued, ``("softmax", i)`` tile i's softmax. Turn i waits
    for its own barrier, issues S of tile i and P V of tile i - 1, lets
    the other warpgroup go, waits for both products and runs tile i's
    softmax; warpgroup 1 lets warpgroup 0 go first, and its last turn
    lets no one go."""
    if n_tiles == 0:
        return []
    me, other = 1 + wg, 2 - wg
    ops = [("arrive", 1)] if wg == 1 else []
    for i in range(n_tiles + 1):
        ops.append(("sync", me))
        if i < n_tiles:
            ops.append(("s", i))
        if i > 0:
            ops.append(("pv", i - 1))
        if not (wg == 1 and i == n_tiles):
            ops.append(("arrive", other))
        if i < n_tiles:
            ops.append(("softmax", i))
    return ops


def flash_bwd_dkdv_tiles(s: int, t: int, k0: int, causal: bool,
                         window: int | None, d: int = 128,
                         meta_len: int = 0) -> range:
    """The query tiles (of the ring stage's rows) the dK / dV kernel's CTA
    at key ``k0`` walks at head dim ``d``, in its order (for each query
    head of the group): those holding a query that sees a key of the
    CTA's :func:`flash_bwd_tiles` keys from ``k0``; to S where the CTA
    holds a sink key (``FlashMask::q_walk``)."""
    kv_tile, step = flash_bwd_tiles(d)[:2]
    q_offset = t - s
    kmax = min(k0 + kv_tile, t) - 1
    ilo, ihi = 0, s - 1
    if causal:
        ilo = max(ilo, k0 - q_offset)
    if window is not None and k0 >= meta_len:
        ihi = min(ihi, kmax + window - 1 - q_offset)
    return range(ilo // step, ihi // step + 1) if ihi >= ilo else range(0)


def flash_bwd_dq_tiles(s: int, t: int, i0: int, causal: bool,
                       window: int | None, d: int = 128,
                       meta_len: int = 0) -> list:
    """The key tiles (of the ring stage's keys) the dQ kernel's CTA at
    query ``i0`` walks at head dim ``d``, in order: the forward's walk
    (:func:`flash_kv_walk`) over its :func:`flash_bwd_tiles` queries."""
    q_tile, step = flash_bwd_tiles(d)[2:]
    q_offset = t - s
    return flash_kv_walk(q_offset + i0, q_offset + min(i0 + q_tile, s) - 1,
                         t, causal, window, step, meta_len)


def flash_bwd_tile_test(k_lo: int, q_lo: int, q_hi: int, t: int,
                        causal: bool, window: int | None,
                        meta_len: int = 0) -> str:
    """What a group of 64 rows of the wgmma backward (a warpgroup's at D
    64 and 128, the CTA's at 256) does with its 64 keys from ``k_lo``
    against the queries at positions ``q_lo .. q_hi`` (the last real
    one): ``skip`` (no pair kept), ``mask`` (a pair is masked, or a key
    lies past T) or ``full`` (every pair kept, no mask applied). Rows past
    S need no mask: their LSE is +inf, so P = 0. A sink key (below
    ``meta_len``) is never out of the window (``FlashMask::skip`` and
    ``need_mask``)."""
    k_last = min(k_lo + 63, t - 1)
    if k_lo >= t or (causal and k_lo > q_hi) or \
            (window is not None and k_last <= q_lo - window
             and k_lo >= meta_len):
        return "skip"
    if k_lo + 63 >= t or (causal and k_lo + 63 > q_lo) or \
            (window is not None and
             max(k_lo, meta_len) <= min(k_lo + 63, q_hi - window)):
        return "mask"
    return "full"


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              chunk: int = 1024, meta_len: int = 0) -> tuple:
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
        mask = _kept(k_pos[None, :], q_pos[:, None], t, causal, window,
                     meta_len)
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


DS_ROUNDING_SIGMAS = 4.0   # c of flash_bwd_row_floors' dQ rounding term


def flash_bwd_row_floors(q, k, v, o, do, lse, *, causal=True,
                         window=None, chunk=1024, meta_len=0) -> tuple:
    """The rounding floor of each row of (dq, dk, dv) for the row check
    against an fp32 oracle: the row's largest element bound of (1) 2 D
    eps32 x its sum of absolute terms, with dS's cancelling difference
    dP_ij - D_i replaced by the size of what cancels, |dO_i|.|v_j| +
    |dO_i|.|O_i| (fp32 sums in another order), and (2) for dq from bf16
    inputs, c u sqrt(sum_j (dS_ij K_jd)^2) x scale, u = 2^-8 the unit
    roundoff of bf16 and c = :data:`DS_ROUNDING_SIGMAS`. The kernel and
    :func:`flash_attention_bwd_plain` both round dS to bf16 as an
    operand, each element by an independent error of at most u of itself
    (standard deviation at most u / sqrt 3), so that sum's rounding error
    has a standard deviation of at most u / sqrt 3 times the root of its
    squared terms: c = 4 is 6.9 of them. Only dq needs it: dS sums to
    zero over a query's row, so where the keys share a common part dq
    cancels to near zero while the rounding of its terms does not; dk's
    sums run over queries, which do not cancel so, and dv's operand P is
    positive. A row can also cancel in exact arithmetic (query 0 sees
    key 0 alone: P = 1 and dS = dO.v_0 - dO.O_0 = 0), and then the
    output differs from the oracle by these floors, not by a fraction of
    the row's own size."""
    b, hq, s, d = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    g = hq // n_kv
    scale = 1.0 / d ** 0.5
    unit = 0.0 if q.dtype == torch.float32 else torch.finfo(q.dtype).eps / 2
    qf = q.reshape(b, n_kv, g, s, d).float()
    dof = do.reshape(b, n_kv, g, s, d).float()
    of = o.reshape(b, n_kv, g, s, d).float()
    qa, doa = qf.abs(), dof.abs()
    deltaa = (doa * of.abs()).sum(-1, keepdim=True)
    delta = (dof * of).sum(-1, keepdim=True)
    lseg = lse.reshape(b, n_kv, g, s, 1)
    q_pos = (t - s) + torch.arange(s, device=q.device)
    mag_dq = torch.zeros_like(qa)
    sq_dq = torch.zeros_like(qa)           # sum_j (dS_ij K_jd)^2
    mag_dk = torch.empty((b, n_kv, t, d), device=q.device)
    mag_dv = torch.empty_like(mag_dk)
    for lo in range(0, t, chunk):
        hi = min(lo + chunk, t)
        kc, vc = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        k_pos = torch.arange(lo, hi, device=q.device)
        mask = _kept(k_pos[None, :], q_pos[:, None], t, causal, window,
                     meta_len)
        sc = torch.einsum("bkgsd,bktd->bkgst", qf, kc) * scale
        p = torch.where(mask, torch.exp(sc - lseg), 0.0)
        a = p * (torch.einsum("bkgsd,bktd->bkgst", doa, vc.abs()) + deltaa)
        mag_dq += torch.einsum("bkgst,bktd->bkgsd", a, kc.abs())
        mag_dk[:, :, lo:hi] = torch.einsum("bkgst,bkgsd->bktd", a, qa)
        mag_dv[:, :, lo:hi] = torch.einsum("bkgst,bkgsd->bktd", p, doa)
        if unit:
            ds = p * (torch.einsum("bkgsd,bktd->bkgst", dof, vc) - delta)
            sq_dq += torch.einsum("bkgst,bktd->bkgsd", ds.square(),
                                  kc.square())
    reorder = 2 * d * EPS32
    floor_dq = reorder * mag_dq + DS_ROUNDING_SIGMAS * unit * sq_dq.sqrt()
    return tuple(m.reshape(-1, d).amax(-1) * f
                 for m, f in ((floor_dq, scale), (reorder * mag_dk, scale),
                              (reorder * mag_dv, 1.0)))


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             meta_len: int = 0) -> tuple:
    """(dq, dk, dv) of flash attention on the card through the hand
    kernel (``csrc/flash_attention_bwd.cu``): q, k, v, the mask and
    ``meta_len`` as :func:`flash_attention_cuda` takes them, o and do like
    q, lse the
    forward's fp32 (B, Hq, S) row log-sum-exp; all contiguous. Counts its
    calls (three launches each: the row dot products dO . O, then dK and
    dV, then dQ) in ``flash_attention_bwd_cuda.launches`` and by
    :func:`flash_bwd_instance` in
    ``flash_attention_bwd_cuda.launches_by_instance``. A build or launch
    failure raises; no other instance is tried."""
    from repro_torch.kernels.build import load_kernel

    _check_operands(q, k, v)
    _check_meta(meta_len)
    inst = flash_bwd_instance(q.dtype, q.shape[3])
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
    fn = getattr(load_kernel("flash_attention_bwd"), BWD_INSTANCES[inst])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * hq, hq, hkv,
                s, t, d, int(causal), int(window is not None),
                0 if window is None else int(window), int(meta_len),
                1.0 / d ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed ({inst}): "
                           f"CUDA error {rc}")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_instance[inst] += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.launches_by_instance = dict.fromkeys(BWD_INSTANCES,
                                                              0)
