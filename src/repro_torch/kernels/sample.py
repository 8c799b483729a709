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

:func:`sample_hop` is the three composed over one hop of a
sentinel-extended CSR (the device sampler's hop): one launch of a fused
kernel on the card, the plain composition on the CPU, bit for bit the
same. The three standalone dispatchers stay as the counterparts of the
three TPU kernels and the public API that mirrors the reference's.

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
           "flat_gather", "sample_hop", "segment_sample_cuda",
           "expand_indptr_cuda", "flat_gather_cuda", "sample_hop_cuda",
           "segment_sample_plain", "expand_indptr_plain",
           "flat_gather_plain", "sample_hop_plain"]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_INT_MAX = 2 ** 31 - 1
# shared memory of one Hopper block, for a row's override table
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


def sample_hop_plain(indptr: torch.Tensor, indices: torch.Tensor,
                     val: torch.Tensor, frontier: torch.Tensor, rnd: int, *,
                     width: int, fanout, seed: int, hop: int,
                     replace: bool):
    """One hop as the composition of the four plain primitives: degrees
    from clipped ``indptr`` lookups (a ``num_nodes`` sentinel row reads
    ``indptr[N]`` twice: degree 0), the ranks, the valid mask, positions
    (``nse``, the inert sentinel edge, where invalid) and the two
    gathers. Returns ``(nbr, evals, valid)``, each (F, width)."""
    n, nse = indptr.shape[0] - 1, indices.shape[0] - 1
    start = indptr[frontier.clamp(0, n).long()]
    deg = indptr[(frontier + 1).clamp(0, n).long()] - start
    if fanout is None:
        ranks = torch.arange(width, dtype=torch.int32, device=deg.device
                             ).expand(deg.shape[0], width)
    else:
        ranks = segment_sample_plain(deg.to(torch.int32),
                                     frontier.to(torch.int32), rnd,
                                     width=width, seed=seed, hop=hop,
                                     replace=replace)
    valid = sample_valid_mask(deg, width=width, fanout=fanout,
                              replace=replace)
    pos = expand_indptr_plain(start, ranks, valid, sentinel=nse)
    return (flat_gather_plain(indices, pos), flat_gather_plain(val, pos),
            valid)


# --------------------------------------------------------------------------
# CUDA wrappers (csrc/sample.cu)
#
# Host cost matters here (a hop's device work is a few microseconds): each
# wrapper checks its arrays in one pass, keeps the library in a module
# global, reads the raw stream handle, and enters the device context only
# when the tensors are not on the current device.
# --------------------------------------------------------------------------

_LIB = None
_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load_kernel
        _LIB = load_kernel("sample")
    return _LIB


def _check(name: str, dev: torch.device, *arrays) -> None:
    """Raise unless every ``(key, tensor, dtypes)`` is a contiguous tensor
    on the CUDA device ``dev`` of one of its dtypes."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {dev}")
    idx = dev.index
    for key, t, dtypes in arrays:
        if not t.is_cuda or t.get_device() != idx or \
                t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous "
                             f"{'/'.join(map(str, dtypes))} on {dev}, "
                             f"got {t.dtype} on {t.device}")


def _call(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)``, the stream the current one of ``dev``, with
    ``dev`` current (the raw stream handle skips building a Stream
    object)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check_width(name: str, width: int, f: int, table: bool) -> None:
    if width < 1 or f * width > _INT_MAX:
        raise ValueError(f"{name}: width {width} x {f} rows")
    if table and 3 * 4 * width > _SMEM_BYTES:
        raise ValueError(f"{name}: width {width} needs more shared memory "
                         "than one block has for a row's override table")


def segment_sample_cuda(deg: torch.Tensor, gid: torch.Tensor, rnd: int, *,
                        width: int, seed: int, hop: int,
                        replace: bool) -> torch.Tensor:
    """(F, width) int32 ranks on the card through the hand kernel, one
    warp per frontier row. Counts its launches in
    ``segment_sample_cuda.launches``."""
    dev = deg.device
    _check("segment_sample", dev, ("deg", deg, (_I32,)),
           ("gid", gid, (_I32,)))
    f = deg.shape[0]
    if gid.shape != deg.shape or deg.dim() != 1:
        raise ValueError(f"segment_sample: deg {tuple(deg.shape)} / gid "
                         f"{tuple(gid.shape)} must be equal (F,) vectors")
    _check_width("segment_sample", width, f, not replace)
    out = torch.empty((f, width), dtype=_I32, device=dev)
    if f == 0:
        return out
    _raise_on(_call(dev, _lib().segment_sample_i32, deg.data_ptr(),
                    gid.data_ptr(), out.data_ptr(), f, width,
                    int(seed) & _M32, int(rnd) & _M32, int(hop) & _M32,
                    int(bool(replace))), "segment_sample")
    segment_sample_cuda.launches += 1
    return out


def expand_indptr_cuda(start: torch.Tensor, ranks: torch.Tensor,
                       valid: torch.Tensor, *, sentinel: int
                       ) -> torch.Tensor:
    """(F, width) int32 flat positions on the card, one thread per slot.
    Counts its launches in ``expand_indptr_cuda.launches``."""
    dev = start.device
    _check("expand_indptr", dev, ("start", start, (_I32,)),
           ("ranks", ranks, (_I32,)), ("valid", valid, (_BOOL,)))
    f, width = ranks.shape
    if start.shape != (f,) or valid.shape != ranks.shape:
        raise ValueError(f"expand_indptr: start {tuple(start.shape)}, "
                         f"ranks {tuple(ranks.shape)}, valid "
                         f"{tuple(valid.shape)} do not match")
    if f * width > _INT_MAX:
        raise ValueError("expand_indptr: table exceeds int32 indexing")
    out = torch.empty((f, width), dtype=_I32, device=dev)
    if f * width == 0:
        return out
    _raise_on(_call(dev, _lib().expand_indptr_i32, start.data_ptr(),
                    ranks.data_ptr(), valid.data_ptr(), out.data_ptr(), f,
                    width, int(sentinel)), "expand_indptr")
    expand_indptr_cuda.launches += 1
    return out


def flat_gather_cuda(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``arr[clip(pos)]`` on the card for a 1-D int32 or fp32 ``arr``, one
    thread per position (a 32-bit word copy either way). Counts its
    launches in ``flat_gather_cuda.launches``."""
    dev = arr.device
    _check("flat_gather", dev, ("arr", arr, (_I32, _F32)),
           ("pos", pos, (_I32,)))
    n_arr, n = arr.shape[0], pos.numel()
    if arr.dim() != 1 or n_arr == 0:
        raise ValueError(f"flat_gather: arr must be a non-empty vector, got "
                         f"{tuple(arr.shape)}")
    if n_arr > _INT_MAX or n > _INT_MAX:
        raise ValueError("flat_gather: exceeds int32 indexing")
    out = torch.empty(pos.shape, dtype=arr.dtype, device=dev)
    if n == 0:
        return out
    _raise_on(_call(dev, _lib().flat_gather_b32, arr.data_ptr(), n_arr,
                    pos.data_ptr(), out.data_ptr(), n), "flat_gather")
    flat_gather_cuda.launches += 1
    return out


def sample_hop_cuda(indptr: torch.Tensor, indices: torch.Tensor,
                    val: torch.Tensor, frontier: torch.Tensor, rnd: int, *,
                    width: int, fanout, seed: int, hop: int, replace: bool):
    """One whole hop on the card in one launch of ``sample_hop_kernel``
    (one warp per frontier row): ``(nbr, evals, valid)``, each (F,
    width), equal bit for bit to :func:`sample_hop_plain`. ``indptr``
    (N + 1,) int32; ``indices`` / ``val`` (nse + 1,) int32 / fp32 with
    the inert sentinel edge last; ``frontier`` (F,) int32. Raises on
    anything the kernel does not take; counts its launches in
    ``sample_hop_cuda.launches``."""
    dev = frontier.device
    _check("sample_hop", dev, ("indptr", indptr, (_I32,)),
           ("indices", indices, (_I32,)), ("val", val, (_F32,)),
           ("frontier", frontier, (_I32,)))
    f = frontier.shape[0]
    n, nse = indptr.shape[0] - 1, indices.shape[0] - 1
    if frontier.dim() != 1 or indptr.dim() != 1 or n < 0 or nse < 0 or \
            val.shape != indices.shape or indices.dim() != 1:
        raise ValueError(f"sample_hop: indptr {tuple(indptr.shape)}, "
                         f"indices {tuple(indices.shape)}, val "
                         f"{tuple(val.shape)}, frontier "
                         f"{tuple(frontier.shape)} do not form a graph and "
                         "a frontier")
    if n + 1 > _INT_MAX or nse + 1 > _INT_MAX:
        raise ValueError("sample_hop: graph exceeds int32 indexing")
    full = fanout is None
    _check_width("sample_hop", width, f, not (full or replace))
    nbr = torch.empty((f, width), dtype=_I32, device=dev)
    evals = torch.empty((f, width), dtype=_F32, device=dev)
    valid = torch.empty((f, width), dtype=_BOOL, device=dev)
    if f == 0:
        return nbr, evals, valid
    _raise_on(_call(dev, _lib().sample_hop_i32, indptr.data_ptr(), n,
                    indices.data_ptr(), val.data_ptr(), nse,
                    frontier.data_ptr(), f, width, int(full),
                    int(seed) & _M32, int(rnd) & _M32, int(hop) & _M32,
                    int(bool(replace)), nbr.data_ptr(), evals.data_ptr(),
                    valid.data_ptr()), "sample_hop")
    sample_hop_cuda.launches += 1
    return nbr, evals, valid


segment_sample_cuda.launches = 0
expand_indptr_cuda.launches = 0
flat_gather_cuda.launches = 0
sample_hop_cuda.launches = 0


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
        return flat_gather_cuda(
            arr, pos if pos.is_contiguous() else pos.contiguous())
    return flat_gather_plain(arr, pos)


def sample_hop(indptr: torch.Tensor, indices: torch.Tensor,
               val: torch.Tensor, frontier: torch.Tensor, rnd: int, *,
               width: int, fanout, seed: int = 0, hop: int = 0,
               replace: bool = False):
    """One whole sampling hop over a sentinel-extended CSR (``indices`` /
    ``val`` carry ``nse + 1`` entries, the last the inert edge): for each
    frontier id, ``width`` neighbour slots drawn as :func:`segment_sample`
    draws them. Returns ``(nbr, evals, valid)``, each (F, width): the
    neighbour ids and edge values (the sentinel edge's where invalid) and
    :func:`sample_valid_mask`. One kernel launch on the card; the plain
    composition of the four primitives on the CPU, bit for bit the same."""
    if frontier.dtype != _I32:
        frontier = frontier.to(_I32)
    if not frontier.is_contiguous():
        frontier = frontier.contiguous()
    fn = sample_hop_cuda if _on_cuda(frontier) else sample_hop_plain
    return fn(indptr, indices, val, frontier, rnd, width=width,
              fanout=fanout, seed=seed, hop=hop, replace=replace)

