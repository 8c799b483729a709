"""Device-side fused k-hop sampling primitives: the hand-written CUDA
kernels, their plain PyTorch versions and the dispatchers.

Port of ``src/repro/kernels/sample.py``. Three per-hop primitives:

* :func:`segment_sample` — per-frontier-row neighbour *ranks* into a dense
  ``(F, width)`` table, from a counter-based stateless RNG: every draw is a
  pure integer hash of ``(seed, round, hop, node id, slot)`` (splitmix32
  avalanche, exact float32 bits-to-uniform). Without replacement it runs a
  partial virtual Fisher–Yates over ``[0, deg)`` with a ``width``-entry
  override table; with replacement, floored uniform draws. The draws are
  bit for bit the reference's, on the CPU and on the card.
* :func:`expand_indptr` — flat CSR positions ``start[row] + rank`` for
  valid slots, a static ``sentinel`` position elsewhere.
* :func:`flat_gather` — ``arr[pos]`` for a flat int32 or fp32 array and an
  ``(F, width)`` position table, positions clipped into range (the
  reference's XLA path takes ``mode="clip"``).

Each dispatcher chooses by the device of its tensors and by nothing else:
a CUDA tensor launches the kernel of ``csrc/sample.cu`` (which raises if
it cannot build or launch), a CPU tensor runs the plain version, any
other device raises. The round counter ``rnd`` is a host integer, so
nothing here reads the device.

The plain RNG cannot lean on torch's ``uint32`` (its operator coverage is
thin), so it works in int64 and masks to 32 bits after every step; each
32-bit multiply is split into 16-bit halves, so no product passes 2⁴⁹ and
no signed overflow happens. The same functions take Python ints.
"""
from __future__ import annotations

import torch

__all__ = ["segment_sample", "sample_valid_mask", "expand_indptr",
           "flat_gather", "segment_sample_cuda", "expand_indptr_cuda",
           "flat_gather_cuda", "segment_sample_plain", "expand_indptr_plain",
           "flat_gather_plain"]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_INT_MAX = 2 ** 31 - 1
# shared memory of one Hopper block, for the width > 32 override tables
_SMEM_BYTES = 232_448


# --------------------------------------------------------------------------
# Counter-based stateless RNG (int64 tensors or Python ints)
# --------------------------------------------------------------------------

def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``0 <= x < 2**32``, in 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """splitmix32-style avalanche on values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _u32(x):
    """The uint32 bit pattern of an int32 (two's complement), in int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _edge_bits(seed: int, rnd, hop: int, gid, slot):
    """uint32 hash (held in int64) of the draw counter (seed, round, hop,
    node, slot); ``gid`` and ``slot`` broadcast against each other."""
    h = _mix32(_u32(seed) ^ _GOLDEN)
    h = _mix32(h ^ _u32(rnd))
    h = _mix32(h ^ _u32(hop))
    h = _mix32(h ^ _u32(gid))
    return _mix32(h ^ _u32(slot))


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Exact [0, 1) float32 from the top 24 bits (every step is exact)."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def segment_sample_plain(deg: torch.Tensor, gid: torch.Tensor, rnd: int, *,
                         width: int, seed: int, hop: int,
                         replace: bool) -> torch.Tensor:
    """(F, width) int32 neighbour ranks with tensor ops — the reference's
    ``_select_ranks`` for a finite fanout, step for step."""
    deg = deg.to(torch.int32)
    f = deg.shape[0]
    iota = torch.arange(width, dtype=torch.int32,
                        device=deg.device).expand(f, width)
    if replace:
        u = _bits_to_uniform(_edge_bits(seed, rnd, hop, gid[:, None],
                                        iota))
        r = torch.floor(u * deg[:, None].to(torch.float32)).to(torch.int32)
        return torch.minimum(r, torch.clamp(deg[:, None] - 1, min=0))

    degf = deg.to(torch.float32)
    keys = torch.full((f, width), -1, dtype=torch.int32, device=deg.device)
    vals = torch.zeros((f, width), dtype=torch.int32, device=deg.device)
    out = iota.clone()
    for j in range(width):
        u = _bits_to_uniform(_edge_bits(seed, rnd, hop, gid, j))
        span = degf - float(j)
        r = j + torch.minimum(torch.floor(u * span).to(torch.int32),
                              torch.clamp(deg - j - 1, min=0))
        # overrides.get(r, r) / overrides.get(j, j): the latest slot
        # whose key matches
        slot_r = torch.where(keys == r[:, None], iota, -1).amax(dim=1)
        v_r = torch.where(slot_r >= 0, vals.gather(
            1, slot_r.clamp(min=0)[:, None].long())[:, 0], r)
        slot_j = torch.where(keys == j, iota, -1).amax(dim=1)
        v_j = torch.where(slot_j >= 0, vals.gather(
            1, slot_j.clamp(min=0)[:, None].long())[:, 0],
            torch.full_like(r, j))
        keys[:, j] = r
        vals[:, j] = v_j
        out[:, j] = v_r
    # rows with deg <= width keep all their edges (identity ranks)
    return torch.where(deg[:, None] > width, out, iota)


def sample_valid_mask(deg: torch.Tensor, *, width: int, fanout,
                      replace: bool = False) -> torch.Tensor:
    """(F, width) bool — which slots of the rank table are real draws: a
    pure function of the degrees (full-neighbour and without-replacement
    rows fill ``min(deg, width)`` leading slots; with-replacement rows
    fill all ``width`` slots whenever ``deg > 0``)."""
    f = deg.shape[0]
    if fanout is not None and replace:
        return (deg > 0)[:, None].expand(f, width)
    iota = torch.arange(width, dtype=torch.int32, device=deg.device)
    lim = deg if fanout is None else torch.clamp(deg, max=width)
    return iota[None, :] < lim[:, None]


def expand_indptr_plain(start: torch.Tensor, ranks: torch.Tensor,
                        valid: torch.Tensor, *, sentinel: int
                        ) -> torch.Tensor:
    pos = start.to(torch.int32)[:, None] + ranks
    return torch.where(valid, pos, torch.full_like(pos, sentinel))


def flat_gather_plain(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return arr[pos.clamp(0, arr.shape[0] - 1).long()]


# --------------------------------------------------------------------------
# CUDA wrappers (csrc/sample.cu)
# --------------------------------------------------------------------------

def _check(name: str, device: torch.device, **arrays) -> None:
    """Raise unless every array (``(tensor, dtypes)`` pairs) is a
    contiguous tensor on the CUDA ``device`` of one of its dtypes."""
    if device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {device}")
    for key, (t, dtypes) in arrays.items():
        if t.device != device or t.dtype not in dtypes or \
                not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous "
                             f"{'/'.join(map(str, dtypes))} on {device}, "
                             f"got {t.dtype} on {t.device}")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def segment_sample_cuda(deg: torch.Tensor, gid: torch.Tensor, rnd: int, *,
                        width: int, seed: int, hop: int,
                        replace: bool) -> torch.Tensor:
    """(F, width) int32 ranks on the card through the hand kernel, one
    thread per frontier row. Counts its launches in
    ``segment_sample_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    _check("segment_sample", deg.device, deg=(deg, (torch.int32,)),
           gid=(gid, (torch.int32,)))
    f = deg.shape[0]
    if gid.shape != deg.shape or deg.dim() != 1:
        raise ValueError(f"segment_sample: deg {tuple(deg.shape)} / gid "
                         f"{tuple(gid.shape)} must be equal (F,) vectors")
    if width < 1 or f * width > _INT_MAX:
        raise ValueError(f"segment_sample: width {width} x {f} rows")
    if not replace and width > 32 and 32 * width * 8 > _SMEM_BYTES:
        raise ValueError(f"segment_sample: width {width} needs more shared "
                         "memory than one block has for its override table")
    out = torch.empty((f, width), dtype=torch.int32, device=deg.device)
    if f == 0:
        return out
    lib = load_kernel("sample")
    with torch.cuda.device(deg.device):
        rc = lib.segment_sample_i32(
            deg.data_ptr(), gid.data_ptr(), out.data_ptr(), f, width,
            int(seed) & _M32, int(rnd) & _M32, int(hop) & _M32,
            int(bool(replace)), _stream(deg.device))
    _raise_on(rc, "segment_sample")
    segment_sample_cuda.launches += 1
    return out


def expand_indptr_cuda(start: torch.Tensor, ranks: torch.Tensor,
                       valid: torch.Tensor, *, sentinel: int
                       ) -> torch.Tensor:
    """(F, width) int32 flat positions on the card, one thread per slot.
    Counts its launches in ``expand_indptr_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    _check("expand_indptr", start.device, start=(start, (torch.int32,)),
           ranks=(ranks, (torch.int32,)), valid=(valid, (torch.bool,)))
    f, width = ranks.shape
    if start.shape != (f,) or valid.shape != ranks.shape:
        raise ValueError(f"expand_indptr: start {tuple(start.shape)}, "
                         f"ranks {tuple(ranks.shape)}, valid "
                         f"{tuple(valid.shape)} do not match")
    if f * width > _INT_MAX:
        raise ValueError("expand_indptr: table exceeds int32 indexing")
    out = torch.empty((f, width), dtype=torch.int32, device=start.device)
    if out.numel() == 0:
        return out
    lib = load_kernel("sample")
    with torch.cuda.device(start.device):
        rc = lib.expand_indptr_i32(start.data_ptr(), ranks.data_ptr(),
                                   valid.data_ptr(), out.data_ptr(), f,
                                   width, int(sentinel),
                                   _stream(start.device))
    _raise_on(rc, "expand_indptr")
    expand_indptr_cuda.launches += 1
    return out


def flat_gather_cuda(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``arr[clip(pos)]`` on the card for a 1-D int32 or fp32 ``arr``, one
    thread per position (a 32-bit word copy either way). Counts its
    launches in ``flat_gather_cuda.launches``."""
    from repro_torch.kernels.build import load_kernel

    _check("flat_gather", arr.device,
           arr=(arr, (torch.int32, torch.float32)), pos=(pos, (torch.int32,)))
    if arr.dim() != 1 or arr.shape[0] == 0:
        raise ValueError(f"flat_gather: arr must be a non-empty vector, got "
                         f"{tuple(arr.shape)}")
    if arr.shape[0] > _INT_MAX or pos.numel() > _INT_MAX:
        raise ValueError("flat_gather: exceeds int32 indexing")
    out = torch.empty(pos.shape, dtype=arr.dtype, device=arr.device)
    if out.numel() == 0:
        return out
    lib = load_kernel("sample")
    with torch.cuda.device(arr.device):
        rc = lib.flat_gather_b32(arr.data_ptr(), arr.shape[0],
                                 pos.data_ptr(), out.data_ptr(), pos.numel(),
                                 _stream(arr.device))
    _raise_on(rc, "flat_gather")
    flat_gather_cuda.launches += 1
    return out


segment_sample_cuda.launches = 0
expand_indptr_cuda.launches = 0
flat_gather_cuda.launches = 0


# --------------------------------------------------------------------------
# Dispatchers
# --------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no sampling implementation for device {t.device}")


def segment_sample(deg: torch.Tensor, gid: torch.Tensor, rnd: int, *,
                   width: int, fanout, seed: int = 0, hop: int = 0,
                   replace: bool = False) -> torch.Tensor:
    """(F, width) int32 per-row neighbour ranks. ``deg``/``gid`` are the
    frontier's in-degrees and global node ids, ``rnd`` the round counter
    (a host int), ``width`` the static slot count (the fanout, or the
    graph's max degree for ``fanout=None``, which draws nothing and
    returns identity ranks). Slots beyond :func:`sample_valid_mask` hold
    junk ranks: callers mask."""
    deg = deg.to(torch.int32)
    gid = gid.to(torch.int32)
    if fanout is None:
        return torch.arange(width, dtype=torch.int32,
                            device=deg.device).expand(deg.shape[0], width)
    fn = segment_sample_cuda if _on_cuda(deg) else segment_sample_plain
    return fn(deg, gid, rnd, width=width, seed=seed, hop=hop,
              replace=replace)


def expand_indptr(start: torch.Tensor, ranks: torch.Tensor,
                  valid: torch.Tensor, *, sentinel: int) -> torch.Tensor:
    """Flat CSR positions ``start[row] + rank`` for every valid slot;
    invalid slots route to ``sentinel`` (callers keep an inert entry
    there: id ``num_nodes``, value 0)."""
    start = start.to(torch.int32)
    if _on_cuda(start):
        return expand_indptr_cuda(start, ranks.to(torch.int32).contiguous(),
                                  valid.contiguous(), sentinel=sentinel)
    return expand_indptr_plain(start, ranks, valid, sentinel=sentinel)


def flat_gather(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``arr[pos]`` for a 1-D array and an (F, width) position table,
    positions clipped into range (the sampling path keeps them in range
    through the ``expand_indptr`` sentinel)."""
    if _on_cuda(arr):
        return flat_gather_cuda(arr, pos.contiguous())
    return flat_gather_plain(arr, pos)

