"""Two-layer GNN models — the paper's §4 benchmark set (+ dot-GAT extra).

``make_gnn(arch, ...)`` returns ``(init, apply)``: ``init(generator,
device="cuda")`` draws the params from a ``torch.Generator`` (layer keys
``l1``, ``l2``, and gat's input projection ``proj``, as the reference),
``apply(params, bundle, x) -> logits``. Architectures:
gcn | sage-sum | sage-mean | sage-max | gin | gat.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.gnn import layers as L

GNN_ARCHS = ("gcn", "sage-sum", "sage-mean", "sage-max", "gin", "gat")

__all__ = ["GNN_ARCHS", "make_gnn"]


def make_gnn(arch: str, in_dim: int, hidden: int, out_dim: int
             ) -> tuple[Callable, Callable]:
    if arch not in GNN_ARCHS:
        raise ValueError(f"unknown GNN arch {arch!r}; choose from {GNN_ARCHS}")
    if arch == "gat":
        def init(generator: torch.Generator, device="cuda") -> dict:
            return {"proj": L._glorot(generator, (in_dim, hidden), device),
                    "l1": L.init_gat(generator, hidden, hidden,
                                     device=device),
                    "l2": L.init_gat(generator, hidden, out_dim,
                                     device=device)}

        def apply(params, bundle, x: torch.Tensor) -> torch.Tensor:
            h = x @ params["proj"]
            h = torch.relu(L.dot_gat_conv(params["l1"], bundle, h))
            return L.dot_gat_conv(params["l2"], bundle, h)

        return init, apply

    if arch == "gcn":
        init_one, conv = L.init_gcn, L.gcn_conv
    elif arch == "gin":
        init_one, conv = L.init_gin, L.gin_conv
    else:
        aggr = arch.split("-")[1]
        init_one = L.init_sage

        def conv(p, bundle, h):
            return L.sage_conv(p, bundle, h, aggr=aggr)

    def init(generator: torch.Generator, device="cuda") -> dict:
        return {"l1": init_one(generator, in_dim, hidden, device=device),
                "l2": init_one(generator, hidden, out_dim, device=device)}

    def apply(params, bundle, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(conv(params["l1"], bundle, x))
        return conv(params["l2"], bundle, h)

    return init, apply
