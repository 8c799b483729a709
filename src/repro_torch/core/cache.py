"""CachedGraph — the cache-enabled backpropagation store (paper §3.3).

iSpLib's end-to-end win comes from computing graph-static intermediates
ONCE and reusing them every step:

  * the transposed adjacency (the backward operand) — ``coo_t`` and the
    plan's packed ``bsr_t`` / ``sell_t`` / ``ell_t``;
  * the GCN-normalized adjacency — built by
    :func:`repro_torch.core.sparse.gcn_normalize` before caching;
  * row degrees and inverse degrees (mean semiring);
  * the format conversion and the kernel plan (autotuner output).

Built on the host (numpy packing, CPU tensors); :meth:`CachedGraph.to`
moves every operand to the device that runs the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import sparse as sp
from repro_torch.core.autotune import KernelPlan, autotune

__all__ = ["CachedGraph", "build_cached_graph"]


@dataclasses.dataclass(frozen=True)
class CachedGraph:
    coo: sp.COO
    coo_t: sp.COO                 # cached transpose — §3.3
    bsr: Optional[sp.BSR]         # tiled-kernel format (None unless planned)
    bsr_t: Optional[sp.BSR]
    sell: Optional[sp.SELL]       # SELL-C-σ (None unless planned)
    sell_t: Optional[sp.SELL]
    ell: Optional[sp.ELL]         # ELLPACK (None unless planned)
    ell_t: Optional[sp.ELL]
    degrees: torch.Tensor         # real entries per row of A
    degrees_t: torch.Tensor       # per row of A^T
    inv_deg: torch.Tensor         # 1/max(deg, 1)  (mean semiring, cached)
    inv_deg_t: torch.Tensor
    plan: KernelPlan              # the autotuner's decision

    @property
    def shape(self):
        return self.coo.shape

    @property
    def nrows(self):
        return self.coo.nrows

    @property
    def ncols(self):
        return self.coo.ncols

    def to(self, device) -> "CachedGraph":
        """Every operand on ``device``."""
        return sp.to_device(self, device)


def build_cached_graph(a: sp.COO, *, k_hint: int = 128,
                       plan: KernelPlan | None = None,
                       tune: bool = True,
                       semiring_reduce: str = "sum") -> CachedGraph:
    """Host-side one-time preprocessing: transpose, degrees, BSR/SELL/ELL
    packing, kernel plan. ``k_hint`` is the embedding width the tuner
    optimizes for; a ``plan`` pins the decision."""
    a_t = sp.coo_transpose(a)
    deg = sp.row_degrees(a)
    deg_t = sp.row_degrees(a_t)

    from repro_torch import obs
    source = "caller"
    if plan is None:
        if tune:
            plan = autotune(a, k_hint, semiring_reduce=semiring_reduce)
            source = "sweep"
        else:
            plan = KernelPlan.trusted()
            source = "untuned"
    if obs.enabled():
        obs.instant("tuning.plan", site="build_cached_graph", source=source,
                    kind=plan.kind, k=k_hint, semiring=semiring_reduce,
                    graph=f"{a.nrows}x{a.ncols}nse{a.nse}")

    bsr = bsr_t = None
    if plan.wants_bsr:
        bsr = sp.bsr_from_coo(a, br=plan.br, bc=plan.bc)
        bsr_t = sp.bsr_from_coo(a_t, br=plan.br, bc=plan.bc)

    sell = sell_t = None
    if plan.wants_sell:
        sell = sp.sell_from_coo(a, c=plan.sell_c, sigma=plan.sell_sigma)
        sell_t = sp.sell_from_coo(a_t, c=plan.sell_c, sigma=plan.sell_sigma)

    ell = ell_t = None
    if plan.wants_ell:
        ell = sp.ell_from_coo(a)
        ell_t = sp.ell_from_coo(a_t)

    return CachedGraph(
        coo=a, coo_t=a_t, bsr=bsr, bsr_t=bsr_t, sell=sell, sell_t=sell_t,
        ell=ell, ell_t=ell_t,
        degrees=deg, degrees_t=deg_t,
        inv_deg=1.0 / torch.clamp(deg, min=1.0),
        inv_deg_t=1.0 / torch.clamp(deg_t, min=1.0),
        plan=plan,
    )
