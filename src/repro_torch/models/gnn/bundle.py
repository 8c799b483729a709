"""GraphBundle — everything a full-graph GNN needs about one graph, prebuilt.

Holds BOTH execution paths' operands so patch()/unpatch() can flip between
them without rebuilding anything:

* tuned path (iSpLib): a CachedGraph over the raw adjacency (SAGE/GIN
  aggregation) and one over the GCN-normalized adjacency — normalization
  cached per §3.3, kernel plan per §3.2. Built for one ``arch``, the
  bundle packs only the one that arch aggregates over (for GCN, Â and
  Âᵀ: at full scale each is tens of GB in BSR tiles);
* baseline path (PyTorch-equivalent): the raw COOs; normalization and
  degrees are recomputed inside the step.

Built on the host; :meth:`GraphBundle.to` moves it to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import sparse as sp
from repro_torch.core.autotune import KernelPlan, TuningDB
from repro_torch.core.cache import CachedGraph, build_cached_graph

__all__ = ["GraphBundle", "build_bundle"]


@dataclasses.dataclass(frozen=True)
class GraphBundle:
    tuned: Optional[CachedGraph]       # raw adjacency, tuned plan
    tuned_norm: Optional[CachedGraph]  # D^-1/2 (A+I) D^-1/2, cached (GCN)
    raw: sp.COO                        # baseline operand
    raw_sl: sp.COO                     # baseline operand incl. self loops

    @property
    def num_nodes(self) -> int:
        return self.raw.nrows

    def graph(self, arch: str) -> CachedGraph:
        """The cached graph ``arch`` aggregates over on the tuned path."""
        g = self.tuned_norm if arch == "gcn" else self.tuned
        if g is None:
            raise ValueError(f"this bundle was built for another arch than "
                             f"{arch!r}")
        return g

    def to(self, device) -> "GraphBundle":
        """Every operand on ``device``."""
        return sp.to_device(self, device)


def build_bundle(dataset, *, k_hint: int = 128, tune: bool = True,
                 measure: bool = False,
                 plan: Optional[KernelPlan] = None,
                 db: Optional[TuningDB] = None,
                 arch: Optional[str] = None, device="cuda") -> GraphBundle:
    """One-time host-side preprocessing for a GraphDataset. ``plan`` pins
    the cached graphs' kernel plan; ``arch`` builds only the cached graph
    that arch aggregates over (Â for ``gcn``, A otherwise) and leaves the
    other None, so only that graph is tuned. ``measure`` times the
    candidates on ``device`` (see :func:`build_cached_graph`); ``db``
    persists the decisions across runs — §3.2's one-time tuning on the
    training path."""
    def cached(a):
        return build_cached_graph(a, k_hint=k_hint, tune=tune,
                                  measure=measure, plan=plan, db=db,
                                  device=device)
    tuned = tuned_norm = None
    if arch != "gcn":
        tuned = cached(dataset.coo)
    if arch in (None, "gcn"):
        tuned_norm = cached(sp.gcn_normalize(dataset.coo,
                                             add_self_loops=True))
    return GraphBundle(
        tuned=tuned, tuned_norm=tuned_norm,
        raw=dataset.coo,
        raw_sl=dataset.coo_sl,
    )
