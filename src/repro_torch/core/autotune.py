"""Auto-tuning mechanism (paper §3.2) for the port's kernels.

The reference probes a TPU and sweeps its Pallas kernels through an
analytic roofline model; the port keeps the same sweep, the same cost
formulas and the same persisted :class:`TuningDB`, and changes only the
hardware model:

* :func:`probe_hardware` returns an NVIDIA Hopper model (data-sheet
  constants: 3.35 TB/s, 80 GB, 132 SMs, 227 KB of shared memory a block).
* The three TPU rules stay driven by :class:`HardwareModel` fields, and the
  Hopper instance sets them to what the hand kernels need: ``lane = 1``
  (the 128-lane K gate becomes "any K" — the kernels take K = 602),
  ``sublane = 1`` (no (1, K)-tile penalty for ELL: a warp per row uses
  all of its lanes), and ``vmem_bytes`` = the shared-memory budget of a
  block for the tile check.
* The BSR kernel of the target is described by the model too: on the TPU
  model the Pallas kernel (double-buffered VMEM tiles at ``fk`` = K
  rounded to lanes, tile products on the matrix unit, as the reference);
  on Hopper ``csrc/bsr_spmm.cu`` (its widest K tile, which is also the
  plan's ``fk``, the ring of shared memory it stages,
  ``HardwareModel.bsr_smem``, and split-TF32 tile products on the tensor
  cores at ``bsr_flops``).
* ``measure=True`` times the candidates where they will run: on the
  card (``device="cuda"``, the default) the hand kernels with CUDA
  events, on the host (``device="cpu"``, asked for by name) their plain
  versions with the host clock. The candidates, their order and their
  gates are the reference's; what each callable runs is what
  ``core/spmm._forward`` runs for that plan on that device.

Module map
----------
``HardwareModel``/``probe_hardware``  roofline constants per chip
``GraphStats``/``graph_stats``        host-side sparsity fingerprint
``KernelPlan``                        the tuner's hashable decision
``estimate_plan_time``                analytic roofline cost per plan
``autotune``/``_measure_override``    analytic sweep + measured override
``tuning_curve``                      Fig. 2 sweep over K
``TuningDB``                          persisted decisions (JSON, schema 2;
                                      measured rows keyed per device kind)
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.sparse import _np, sell_slice_degrees

__all__ = [
    "HardwareModel",
    "KernelPlan",
    "GraphStats",
    "probe_hardware",
    "graph_stats",
    "estimate_plan_time",
    "autotune",
    "tuning_curve",
    "suggest_embedding_size",
    "device_tag",
    "TuningDB",
    "sell_sigma_candidates",
    "sell_candidates_from_degrees",
    "H100",
    "TPU_V5E",
]


# --------------------------------------------------------------------------
# Hardware model (the probe)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Roofline constants for the target chip. The defaults are the TPU
    v5e model of the reference, kept so that the port's tuner can be held
    against the reference's picks; :data:`H100` is the port's target."""

    name: str = "tpu-v5e"
    mxu_dim: int = 128                 # matrix-unit tile edge
    lane: int = 128                    # K alignment the kernels need
    sublane: int = 8                   # ELL per-row output-tile penalty
    vmem_bytes: int = 64 * 1024 * 1024  # on-chip tile budget
    hbm_bytes: int = 16 * 1024 * 1024 * 1024
    peak_flops: float = 197e12         # matrix-unit peak
    vpu_flops: float = 197e12 / 16     # non-matmul throughput
    hbm_bw: float = 819e9              # bytes/s
    ici_bw: float = 50e9               # bytes/s per link
    # the target's BSR kernel. bsr_k_tile = 0 is the reference's Pallas
    # kernel: K tile = K rounded to lanes, double-buffered tiles in VMEM.
    # Otherwise a kernel whose widest K tile is bsr_k_tile, built for the
    # tile heights bsr_rows and for bc a multiple of bsr_depth, whose
    # accumulator lives in registers. bsr_flops = 0: its tile products run
    # at peak_flops.
    bsr_k_tile: int = 0
    bsr_depth: int = 1
    bsr_rows: tuple = ()
    bsr_flops: float = 0.0

    def mxu_time(self, flops: float) -> float:
        return flops / self.peak_flops

    def vpu_time(self, flops: float) -> float:
        return flops / self.vpu_flops

    def mem_time(self, nbytes: float) -> float:
        return nbytes / self.hbm_bw

    def bsr_time(self, flops: float) -> float:
        return flops / (self.bsr_flops or self.peak_flops)

    def bsr_smem(self, br: int) -> int:
        """Shared memory a fixed-K-tile BSR kernel holds for tiles of ``br``
        rows: a ring of stages, each an fp32 (min(br, 128), bsr_depth) box
        of the tile and a (bsr_k_tile, bsr_depth) box of hᵀ, as many as fit
        (at most 4) beside two more hᵀ boxes (the TF32 lo parts of two
        steps), 1 KB to align them and one pair of 8-byte barriers a
        stage."""
        lo = 2 * 4 * self.bsr_depth * self.bsr_k_tile
        stage = 4 * self.bsr_depth * (min(br, 128) + self.bsr_k_tile)
        stages = min(4, (self.vmem_bytes - 1024 - 64 - lo) // stage)
        return stages * stage + lo + 1024 + 16 * stages


TPU_V5E = HardwareModel()

# NVIDIA H100 SXM data sheet: 80 GB at 3.35 TB/s, 132 SMs, 227 KB of
# shared memory a block, 989 TFLOP/s dense bf16 tensor cores (495 TF32),
# 67 TFLOP/s fp32 outside them, NVLink 450 GB/s each way. The BSR fields
# are csrc/bsr_spmm.cu's: K tiles up to 128 columns, 32 tile columns a
# stage, its row templates, and tile products in split TF32 (three TF32
# passes a product, so a third of the TF32 rate).
H100 = HardwareModel(
    name="h100-sxm", mxu_dim=64, lane=1, sublane=1,
    vmem_bytes=232_448, hbm_bytes=80 * 10 ** 9,
    peak_flops=989e12, vpu_flops=67e12, hbm_bw=3.35e12, ici_bw=450e9,
    bsr_k_tile=128, bsr_depth=32, bsr_rows=(32, 64, 128, 256),
    bsr_flops=495e12 / 3)


def probe_hardware() -> HardwareModel:
    """The H100 model, the port's only target: the analytic sweep needs
    only the model, and the measured pass (``autotune(measure=True)``)
    times the card itself. A card of another kind gets a warning."""
    import torch
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name()
        if "H100" not in name:
            warnings.warn(f"tuning for an H100 on a {name}", stacklevel=2)
    return H100


# --------------------------------------------------------------------------
# Graph statistics (host-side, cheap, computed once)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphStats:
    nrows: int
    ncols: int
    nse: int
    avg_deg: float
    max_deg: int
    p99_deg: int
    tile_counts: tuple       # ((br, bc, n_tiles), ...)
    sell_counts: tuple = ()  # ((c, sigma, n_steps), ...)

    def n_tiles(self, br: int, bc: int) -> int:
        for b_r, b_c, n in self.tile_counts:
            if (b_r, b_c) == (br, bc):
                return n
        raise KeyError((br, bc))

    def sell_steps(self, c: int, sigma: int) -> int:
        for cc, ss, n in self.sell_counts:
            if (cc, ss) == (c, sigma):
                return n
        raise KeyError((c, sigma))


_DEFAULT_TILES: tuple = ((128, 128), (256, 128), (128, 256), (64, 128), (32, 128))
_SELL_C_VALUES: tuple = (8, 16, 32)
_SELL_SIGMA_FALLBACK: tuple = (0, 256)
_SELL_SIGMA_MAX: int = 3


def sell_sigma_candidates(degrees: np.ndarray,
                          fallback: Sequence[int] = _SELL_SIGMA_FALLBACK
                          ) -> tuple:
    """SELL sort-window (σ) candidates from the degree histogram: {0
    (global sort), the Lorenz-curve knee window, 4x that window}, clipped
    to the row count and capped at ``_SELL_SIGMA_MAX``. No rows / no
    edges -> the static fallback; constant degrees -> ``(0,)``."""
    deg = np.asarray(degrees, np.int64)
    n = int(deg.shape[0])
    if n == 0 or deg.sum() == 0:
        return tuple(fallback)
    d = np.sort(deg)[::-1]
    if d[0] == d[-1]:
        return (0,)
    lorenz = np.cumsum(d) / d.sum()
    frac = np.arange(1, n + 1) / n
    knee = int(np.argmax(lorenz - frac)) + 1
    window = 1 << int(np.ceil(np.log2(max(knee, 8))))
    cands = {0}
    for w in (window, 4 * window):
        if w < n:
            cands.add(w)
    return tuple(sorted(cands))[:_SELL_SIGMA_MAX]


def sell_candidates_from_degrees(degrees: np.ndarray,
                                 c_values: Sequence[int] = _SELL_C_VALUES
                                 ) -> tuple:
    """(C, σ) sweep set: slice heights x histogram-derived sort windows."""
    return tuple((c, s) for c in c_values
                 for s in sell_sigma_candidates(degrees))


def graph_stats(a, tile_candidates: Sequence[tuple] = _DEFAULT_TILES,
                sell_candidates: Sequence[tuple] | None = None
                ) -> GraphStats:
    """``a`` is a COO. Host-side numpy pass."""
    row = _np(a.row)[: a.nse].astype(np.int64)
    col = _np(a.col)[: a.nse].astype(np.int64)
    deg = np.bincount(row, minlength=a.nrows)
    if sell_candidates is None:
        sell_candidates = sell_candidates_from_degrees(deg)
    counts = []
    for br, bc in tile_candidates:
        nbc = -(-a.ncols // bc)
        key = (row // br) * nbc + (col // bc)
        counts.append((br, bc, int(np.unique(key).size)))
    sells = []
    for c, sigma in sell_candidates:
        slice_deg, _ = sell_slice_degrees(deg, c, sigma)
        sells.append((c, sigma, int(slice_deg.sum())))
    return GraphStats(
        nrows=a.nrows, ncols=a.ncols, nse=a.nse,
        avg_deg=float(deg.mean()) if a.nrows else 0.0,
        max_deg=int(deg.max()) if a.nrows else 0,
        p99_deg=int(np.percentile(deg, 99)) if a.nrows else 0,
        tile_counts=tuple(counts),
        sell_counts=tuple(sells),
    )


# --------------------------------------------------------------------------
# Kernel plan — the tuner's (static, hashable) decision
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Which kernel serves a (graph, K) point, plus its tile shape.

    kind: 'bsr' (block-sparse tiles), 'ell' (row gather), 'sell'
    (SELL-C-σ sliced gather) — sum/mean only — or 'trusted' (gather +
    segment reduce, any semiring).
    """

    kind: str = "trusted"
    br: int = 128
    bc: int = 128
    fk: int = 256
    k_hint: int = 128
    sell_c: int = 8
    sell_sigma: int = 0
    est_generated_s: float = float("inf")
    est_trusted_s: float = float("inf")

    def __post_init__(self):
        assert self.kind in ("bsr", "ell", "sell", "trusted"), self.kind

    @property
    def wants_bsr(self) -> bool:
        return self.kind == "bsr"

    @property
    def wants_ell(self) -> bool:
        return self.kind == "ell"

    @property
    def wants_sell(self) -> bool:
        return self.kind == "sell"

    @property
    def predicted_speedup(self) -> float:
        if self.kind == "trusted" or self.est_generated_s == 0:
            return 1.0
        return self.est_trusted_s / self.est_generated_s

    @classmethod
    def trusted(cls, k_hint: int = 128) -> "KernelPlan":
        return cls(kind="trusted", k_hint=k_hint)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "KernelPlan":
        return cls(**d)


# --------------------------------------------------------------------------
# Analytic cost model
# --------------------------------------------------------------------------

def _bytes_of(dtype) -> int:
    return np.dtype(dtype).itemsize


def estimate_plan_time(stats: GraphStats, k: int, plan: KernelPlan,
                       hw: HardwareModel, dtype=np.float32) -> float:
    """Seconds for one SpMM under the roofline model: max(compute, memory)."""
    e = _bytes_of(dtype)
    if plan.kind == "bsr":
        nt = stats.n_tiles(plan.br, plan.bc)
        flops = 2.0 * nt * plan.br * plan.bc * k
        nbytes = nt * (plan.br * plan.bc * e + plan.bc * k * e) \
            + stats.nrows * k * e
        return max(hw.bsr_time(flops), hw.mem_time(nbytes))
    if plan.kind == "ell":
        md = max(stats.p99_deg, 1)
        flops = 2.0 * stats.nrows * md * k
        nbytes = stats.nrows * md * (4 + k * e) + stats.nrows * k * e
        return max(hw.vpu_time(flops * hw.sublane), hw.mem_time(nbytes))
    if plan.kind == "sell":
        steps = stats.sell_steps(plan.sell_c, plan.sell_sigma)
        slots = steps * plan.sell_c
        flops = 2.0 * slots * k
        nbytes = slots * (4 + k * e) + stats.nrows * k * e
        return max(hw.vpu_time(flops), hw.mem_time(nbytes))
    flops = 2.0 * stats.nse * k
    nbytes = stats.nse * (8 + 2 * k * e) + stats.nrows * k * e
    return max(hw.vpu_time(flops), hw.mem_time(nbytes))


def _vmem_ok(br: int, bc: int, fk: int, hw: HardwareModel,
             dtype=np.float32) -> bool:
    """TPU rule: A-tile + H-tile (double-buffered) + fp32 accumulator must
    fit the VMEM budget."""
    e = _bytes_of(dtype)
    need = 2 * (br * bc * e + bc * fk * e) + br * fk * 4
    return need <= hw.vmem_bytes * 0.8


def _bsr_k_tile(br: int, bc: int, k_hint: int,
                hw: HardwareModel) -> int | None:
    """The BSR kernel's K tile for a (br x bc) candidate on ``hw``, or None
    when the kernel cannot take that tile: a fixed-K-tile kernel must be
    built for the tile and fit its shared memory; the reference's kernel
    must fit its double-buffered tiles at K rounded to lanes."""
    if hw.bsr_k_tile:
        fits = (br in hw.bsr_rows and bc % hw.bsr_depth == 0
                and hw.bsr_smem(br) <= hw.vmem_bytes)
        return hw.bsr_k_tile if fits else None
    fk = min(256, max(128, ((k_hint + 127) // 128) * 128))
    return fk if _vmem_ok(br, bc, fk, hw) else None


# --------------------------------------------------------------------------
# The tuner
# --------------------------------------------------------------------------

def autotune(a, k_hint: int = 128, *, hw: HardwareModel | None = None,
             measure: bool = False, semiring_reduce: str = "sum",
             tile_candidates: Sequence[tuple] = _DEFAULT_TILES,
             sell_candidates: Sequence[tuple] | None = None,
             stats: GraphStats | None = None,
             device="cuda") -> KernelPlan:
    """Pick the kernel variant + tile shape for (graph ``a``, width
    ``k_hint``) by the analytic roofline sweep. Generated kernels serve
    only K that is a multiple of ``hw.lane`` and the sum/mean semiring;
    every other point takes the trusted kernel.

    ``measure=True`` then times candidates on ``device`` and keeps the
    fastest (:func:`_measure_override`): on the card unless the caller
    asks for ``"cpu"``; with no card it raises."""
    hw = hw or probe_hardware()
    stats = stats or graph_stats(a, tile_candidates, sell_candidates)

    trusted = KernelPlan.trusted(k_hint)
    t_trusted = estimate_plan_time(stats, k_hint, trusted, hw)
    evaluated: list = [("trusted", t_trusted)]

    lane_aligned = k_hint % hw.lane == 0
    mxu_semiring = semiring_reduce in ("sum", "mean")
    if not (lane_aligned and mxu_semiring):
        plan = dataclasses.replace(trusted, est_trusted_s=t_trusted,
                                   est_generated_s=float("inf"))
        _log_sweep(stats, k_hint, semiring_reduce, evaluated, plan,
                   gated="lane" if not lane_aligned else "semiring")
        if measure:     # a measured trusted row for this semiring
            plan = _measure_override(a, k_hint, plan, stats, hw=hw,
                                     semiring=semiring_reduce,
                                     device=device)
        return plan

    best: KernelPlan = dataclasses.replace(
        trusted, est_trusted_s=t_trusted, est_generated_s=float("inf"))
    best_t = t_trusted

    for br, bc in tile_candidates:
        fk = _bsr_k_tile(br, bc, k_hint, hw)
        if fk is None:
            continue
        cand = KernelPlan(kind="bsr", br=br, bc=bc, fk=fk, k_hint=k_hint)
        t = estimate_plan_time(stats, k_hint, cand, hw)
        evaluated.append((f"bsr{br}x{bc}", t))
        if t < best_t:
            best_t = t
            best = dataclasses.replace(cand, est_generated_s=t,
                                       est_trusted_s=t_trusted)

    # ELL candidate: only when padding is bounded (near-regular degree)
    if stats.max_deg <= max(4 * stats.avg_deg, 8):
        cand = KernelPlan(kind="ell", k_hint=k_hint)
        t = estimate_plan_time(stats, k_hint, cand, hw)
        evaluated.append(("ell", t))
        if t < best_t:
            best_t = t
            best = dataclasses.replace(cand, est_generated_s=t,
                                       est_trusted_s=t_trusted)

    for c, sigma, _ in stats.sell_counts:
        cand = KernelPlan(kind="sell", sell_c=c, sell_sigma=sigma,
                          k_hint=k_hint)
        t = estimate_plan_time(stats, k_hint, cand, hw)
        evaluated.append((f"sellc{c}s{sigma}", t))
        if t < best_t:
            best_t = t
            best = dataclasses.replace(cand, est_generated_s=t,
                                       est_trusted_s=t_trusted)

    _log_sweep(stats, k_hint, semiring_reduce, evaluated, best)
    if measure:
        best = _measure_override(a, k_hint, best, stats, hw=hw,
                                 semiring=semiring_reduce, device=device)
    return best


def _plan_label(plan: KernelPlan) -> str:
    if plan.kind == "bsr":
        return f"bsr{plan.br}x{plan.bc}"
    if plan.kind == "sell":
        return f"sellc{plan.sell_c}s{plan.sell_sigma}"
    return plan.kind


def _log_sweep(stats: GraphStats, k: int, semiring: str, evaluated: list,
               winner: KernelPlan, *, gated: str | None = None) -> None:
    """One ``tuning.sweep`` instant (every candidate's estimate and the
    pick) when tracing is on; always bumps the sweep counter."""
    from repro_torch import obs
    obs.metrics().counter("tuning.sweeps").inc()
    if not obs.enabled():
        return
    attrs = dict(
        graph=f"{stats.nrows}x{stats.ncols}nse{stats.nse}", k=k,
        semiring=semiring, winner=_plan_label(winner),
        candidates=[[name, float(t)] for name, t in evaluated])
    if gated:
        attrs["gated"] = gated
    obs.instant("tuning.sweep", **attrs)


# --------------------------------------------------------------------------
# The measured pass
# --------------------------------------------------------------------------

def _measure_device(device):
    """``device`` as a ``torch.device`` that a measured pass may time on.
    The card is the default and there is no fallback: asking for it with
    no card present raises; the host is timed only when named."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "measured tuning times the hand kernels on the card and no "
                "CUDA device is present; pass device='cpu' to time the "
                "plain versions on the host")
    elif dev.type != "cpu":
        raise ValueError(f"no measured tuning on device {dev}")
    return dev


def _time_callable(fn: Callable, *args, reps: int = 3) -> float:
    """Seconds a call of ``fn(*args)``, the mean of ``reps`` calls after
    one untimed call (which also builds the kernel on the card: the
    build never lands in the timed window). On the card: CUDA events
    around the ``reps`` calls on the current stream, the device
    synchronised before and after; on the host: the host clock."""
    import torch
    dev = next((x.device for x in args if isinstance(x, torch.Tensor)),
               torch.device("cpu"))
    with torch.no_grad():
        fn(*args)
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*args)
            return (time.perf_counter() - t0) / reps
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / reps


def _pack(a, plan: KernelPlan, packs: dict | None):
    """The host-packed operand of ``plan`` over ``a`` (BSR, ELL at its
    full max degree, or SELL), from ``packs`` when the caller keeps one
    packing a plan across calls."""
    from repro_torch.core import sparse as sp
    key = (plan.kind, plan.br, plan.bc, plan.sell_c, plan.sell_sigma)
    if packs is not None and key in packs:
        return packs[key]
    if plan.kind == "bsr":
        packed = sp.bsr_from_coo(a, br=plan.br, bc=plan.bc)
    elif plan.kind == "ell":
        packed = sp.ell_from_coo(a)
    elif plan.kind == "sell":
        packed = sp.sell_from_coo(a, c=plan.sell_c, sigma=plan.sell_sigma)
    else:
        raise ValueError(plan.kind)
    if packs is not None:
        packs[key] = packed
    return packed


def _measure_plan(a, plan: KernelPlan, h, sr, inv_deg,
                  packs: dict | None = None) -> float:
    """Time one generated candidate as ``core/spmm._forward`` runs it on
    ``h``'s device: ``kops.bsr_spmm`` / ``ell_spmm`` / ``sell_spmm``
    (the hand kernels on the card, the plain versions on the host), with
    the mean post-scale inside the timed callable. The operand is moved
    to the device for this candidate alone and freed after it.

    The reference times its ELL candidate through ``spmm_ell_ref`` (its
    XLA gather); the port times its ELL kernel, which is what the port's
    production path launches."""
    import torch
    from repro_torch.core import sparse as sp
    from repro_torch.kernels import ops as kops

    kernel = {"bsr": kops.bsr_spmm, "ell": kops.ell_spmm,
              "sell": kops.sell_spmm}[plan.kind]
    op = sp.to_device(_pack(a, plan, packs), h.device)
    nrows = a.nrows

    def run(hh):
        out = kernel(op, hh)[:nrows]
        return out * inv_deg[:, None] if sr.reduce == "mean" else out
    try:
        return _time_callable(run, h)
    finally:
        del op, run
        if h.device.type == "cuda":
            torch.cuda.empty_cache()


def _measure_trusted(a, h, sr, degrees) -> float:
    """Time the trusted path as ``core/spmm`` runs it: the segment reduce
    over A's edges, through the ordered segment sum on the card for sum /
    mean (the edges' stable sort by row computed before timing, as a
    ``CachedGraph`` caches it)."""
    import torch
    from repro_torch.core import sparse as sp
    from repro_torch.kernels.ref import coo_reduce
    from repro_torch.kernels.segment_sum import segment_order

    coo = sp.to_device(a, h.device)
    order = segment_order(coo.row[: coo.nse], coo.nrows)

    def run(hh):
        return coo_reduce(coo.row, coo.col, coo.val, coo.nse, coo.nrows, hh,
                          sr, degrees, order=order)
    try:
        return _time_callable(run, h)
    finally:
        del coo, order, run
        if h.device.type == "cuda":
            torch.cuda.empty_cache()


def _measure_override(a, k: int, plan: KernelPlan, stats: GraphStats, *,
                      hw: HardwareModel | None = None,
                      semiring: str = "sum", device="cuda",
                      packs: dict | None = None) -> KernelPlan:
    """Time trusted against one candidate per generated family (the
    analytic pick, the best SELL by estimate, ELL where degrees are
    bounded) on ``device`` and keep the fastest, its ``est_*`` fields
    holding measured seconds, as the reference does.

    ``semiring`` is the reduction the caller runs: the trusted path is
    timed with that semiring, and generated candidates include the mean
    post-scale. Max / min and K that is not a multiple of ``hw.lane``
    admit no generated candidate: their row is the trusted time alone.
    The probe input is the reference's (``default_rng(0)`` normals).
    ``a`` may hold tensors or numpy arrays (a sampled block's COO); its
    real entries are timed as int32 triplets, as ``coo_from_edges``
    builds them. ``packs`` keeps one host packing a plan across calls
    over ``a``."""
    import torch
    from repro_torch.core import sparse as sp
    from repro_torch.core.semiring import get_semiring

    dev = _measure_device(device)
    hw = hw or probe_hardware()
    a = sp.COO(row=torch.from_numpy(_np(a.row)[: a.nse].astype(np.int32)),
               col=torch.from_numpy(_np(a.col)[: a.nse].astype(np.int32)),
               val=torch.from_numpy(np.ascontiguousarray(_np(a.val)[: a.nse])),
               nrows=a.nrows, ncols=a.ncols, nse=a.nse)
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (a.ncols, k)).astype(np.float32)).to(dev)
    sr = get_semiring(semiring)
    degrees = sp.row_degrees(a).to(dev)
    inv_deg = 1.0 / torch.clamp(degrees, min=1.0)

    t_trusted = _measure_trusted(a, h, sr, degrees)

    candidates: list[KernelPlan] = []
    if sr.mxu_eligible and k % hw.lane == 0:
        if plan.kind != "trusted":
            candidates.append(plan)
        if not any(p.kind == "sell" for p in candidates) and \
                stats.sell_counts:
            candidates.append(min(
                (KernelPlan(kind="sell", sell_c=c, sell_sigma=s, k_hint=k)
                 for c, s, _ in stats.sell_counts),
                key=lambda p: estimate_plan_time(stats, k, p, hw)))
        ell_bounded = stats.max_deg <= max(4 * stats.avg_deg, 8)
        if ell_bounded and not any(p.kind == "ell" for p in candidates):
            candidates.append(KernelPlan(kind="ell", k_hint=k))

    timed: list = [("trusted", t_trusted)]
    best, best_t = None, float("inf")
    for cand in candidates:
        t = _measure_plan(a, cand, h, sr, inv_deg, packs)
        timed.append((_plan_label(cand), t))
        if t < best_t:
            best, best_t = cand, t

    if best is not None and best_t <= t_trusted:
        winner = dataclasses.replace(best, est_generated_s=best_t,
                                     est_trusted_s=t_trusted)
    else:
        winner = KernelPlan(kind="trusted", k_hint=k,
                            est_generated_s=best_t, est_trusted_s=t_trusted)
    estimated = [[_plan_label(p), estimate_plan_time(stats, k, p, hw)]
                 for p in [KernelPlan.trusted(k)] + candidates]
    _log_measured(stats, k, semiring, timed, winner, estimated=estimated,
                  analytic=_plan_label(plan), device=dev.type)
    return winner


def _log_measured(stats: GraphStats, k: int, semiring: str, timed: list,
                  winner: KernelPlan, **extra) -> None:
    """One ``tuning.measure`` instant (each timed candidate's measured
    seconds and the pick, beside ``extra``: the candidates' analytic
    estimates, the analytic pick and the device) when tracing is on;
    always bumps the ``tuning.measured`` counter."""
    from repro_torch import obs
    obs.metrics().counter("tuning.measured").inc()
    if not obs.enabled():
        return
    obs.instant(
        "tuning.measure",
        graph=f"{stats.nrows}x{stats.ncols}nse{stats.nse}", k=k,
        semiring=semiring, winner=_plan_label(winner),
        candidates=[[name, float(t)] for name, t in timed], **extra)


# --------------------------------------------------------------------------
# Tuning curve — the Fig. 2 reproduction
# --------------------------------------------------------------------------

def tuning_curve(a, ks: Sequence[int] = (16, 32, 64, 128, 256, 512, 1024),
                 *, hw: HardwareModel | None = None, measure: bool = False,
                 device="cuda") -> list[dict]:
    """Sweep embedding sizes; report generated-vs-trusted speedup per K
    (analytic, or measured on ``device``). The peak of this curve is the
    tuner's "ideal embedding size" (§3.2, Fig. 2). A measured curve packs
    each candidate plan once on the host and reuses the packing across
    Ks, which changes no result."""
    hw = hw or probe_hardware()
    stats = graph_stats(a)
    packs: dict = {}
    rows = []
    for k in ks:
        plan = autotune(a, k, hw=hw, stats=stats)
        if measure:
            plan = _measure_override(a, k, plan, stats, hw=hw,
                                     device=device, packs=packs)
        if measure and plan.est_generated_s != float("inf"):
            speedup = plan.est_trusted_s / plan.est_generated_s
        else:
            t_tr = estimate_plan_time(stats, k, KernelPlan.trusted(k), hw)
            gen = plan if plan.kind != "trusted" else None
            speedup = (t_tr / estimate_plan_time(stats, k, gen, hw)
                       if gen is not None else 1.0)
        rows.append(dict(k=k, kind=plan.kind, br=plan.br, bc=plan.bc,
                         speedup=float(speedup)))
    return rows


def suggest_embedding_size(curve: list[dict]) -> int:
    """The K with the best generated-vs-trusted speedup on a
    :func:`tuning_curve` sweep — the paper's "ideal embedding size"."""
    return max(curve, key=lambda r: r["speedup"])["k"]


# --------------------------------------------------------------------------
# Tuning DB — persisted tuner decisions
# --------------------------------------------------------------------------

def device_tag(device) -> str:
    """The device kind a measured plan holds for: ``cpu``, or the card's
    name (``torch.cuda.get_device_name``). Raises where ``device`` is the
    card and none is present."""
    import torch
    dev = _measure_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


class TuningDB:
    """JSON-file store of tuner decisions so repeated runs skip the sweep.

    On-disk format (schema 2): ``{"schema": 2, "plans": {...}}``; legacy
    flat dicts still load. A corrupt or incompatible-schema file is
    quarantined to ``<path>.corrupt`` with a warning. The caller names the
    file: the port reads and writes nothing it was not pointed at.

    Device rule: a measured plan holds only for the kind of device it was
    timed on, so a measured row is stored and looked up under its key
    plus ``@`` and :func:`device_tag` (``...k256@cpu``, ``...k256@NVIDIA
    H100 80GB HBM3``); a request that measures on one device kind never
    reads another's row. Rows without the suffix are analytic decisions,
    pinned plans or rows the reference wrote; only requests that measure
    nothing read them. :meth:`key` is the reference's, byte for byte, and
    each file loads in the other package."""

    _SCHEMA_VERSION = 2

    def __init__(self, path: str):
        self.path = str(path)
        self._db: dict[str, dict] = self._load(self.path)

    @classmethod
    def _load(cls, path: str) -> dict[str, dict]:
        if not os.path.exists(path):
            return {}
        try:
            if os.path.getsize(path) == 0:
                return {}
            with open(path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict):
                raise ValueError(f"expected a JSON object, got {type(raw)}")
            if "schema" in raw:
                if raw["schema"] != cls._SCHEMA_VERSION or \
                        not isinstance(raw.get("plans"), dict):
                    raise ValueError(
                        f"unsupported TuningDB schema {raw.get('schema')!r} "
                        f"(this build reads {cls._SCHEMA_VERSION})")
                return raw["plans"]
            return raw
        except (json.JSONDecodeError, ValueError, OSError) as exc:
            quarantine = path + ".corrupt"
            try:
                os.replace(path, quarantine)
                where = f"quarantined to {quarantine}"
            except OSError:
                where = "left in place"
            warnings.warn(
                f"TuningDB at {path} is unreadable ({exc}); {where}. "
                f"Starting with an empty DB.")
            return {}

    def __len__(self) -> int:
        return len(self._db)

    @staticmethod
    def key(a, k: int, semiring: str = "sum") -> str:
        """Structural fingerprint of (graph, K, semiring): sizes plus a CRC
        over the sorted edge list; sum keys carry no suffix."""
        import zlib
        row = _np(a.row)[: a.nse]
        col = _np(a.col)[: a.nse]
        order = np.lexsort((col, row))
        row = np.ascontiguousarray(row[order], np.int32)
        col = np.ascontiguousarray(col[order], np.int32)
        fp = zlib.crc32(col.tobytes(), zlib.crc32(row.tobytes()))
        sfx = "" if semiring == "sum" else f"sr{semiring}"
        return f"{a.nrows}x{a.ncols}nse{a.nse}fp{fp:08x}k{k}{sfx}"

    @staticmethod
    def measured_key(key: str, device) -> str:
        """The row of ``key`` measured on ``device``'s kind."""
        return f"{key}@{device_tag(device)}"

    def get(self, a, k: int, semiring: str = "sum", *,
            device=None) -> KernelPlan | None:
        """The row for (graph ``a``, ``k``, ``semiring``): measured on
        ``device``'s kind when ``device`` is given, else the unsuffixed
        row."""
        return self.get_key(self.key(a, k, semiring), device=device)

    def put(self, a, k: int, plan: KernelPlan, semiring: str = "sum", *,
            device=None) -> None:
        self.put_key(self.key(a, k, semiring), plan, device=device)

    def get_key(self, key: str, *, device=None) -> KernelPlan | None:
        if device is not None:
            key = self.measured_key(key, device)
        d = self._db.get(key)
        return KernelPlan.from_json(d) if d else None

    def put_key(self, key: str, plan: KernelPlan, *, device=None) -> None:
        if device is not None:
            key = self.measured_key(key, device)
        self._db[key] = plan.to_json()

    def save(self) -> None:
        """Atomically write the schema-2 envelope (tmp file + rename)."""
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": self._SCHEMA_VERSION, "plans": self._db},
                      f, indent=1)
        os.replace(tmp, self.path)
