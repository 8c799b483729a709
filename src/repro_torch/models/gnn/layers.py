"""GNN layers (GCN / GraphSAGE / GIN full-graph and over sampled blocks,
dot-product graph attention full-graph), patch-aware.

Functional, like the reference: ``init_*(generator, ...) -> params`` (a
dict of tensors), ``*_conv(params, bundle, h) -> h'`` over a whole graph
and ``*_conv_block(params, pb, h) -> h'`` over one sampled block; both
forms share the same params. Parameters keep the reference's layout
(``x @ w`` with ``w`` of shape (in, out)) and its layer-keyed structure,
so :func:`params_from_jax` hands weights across unchanged.

The aggregation resolves through the patch registry: ``spmm`` for a
whole graph (tuned = the CachedGraph's planned kernel with cached
normalization and transpose, baseline = the uncached trusted path with
GCN normalization in the step), ``fusedmm`` for attention (tuned = the
fused BSR kernel where the plan allows, with a recompute backward,
baseline = the unfused composition under plain autograd) and
``block_spmm`` for a block (tuned = the bucket plan's packed ELL/SELL
kernel, baseline = the trusted segment reduce).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.patch import is_patched, resolve
from repro_torch.kernels.ref import take_rows

__all__ = ["init_gcn", "gcn_conv", "init_sage", "sage_conv", "init_gin",
           "gin_conv", "sage_conv_block", "gin_conv_block", "init_gat",
           "dot_gat_conv", "params_from_jax"]


def _glorot(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Glorot-uniform, drawn on the CPU from ``generator`` (so a seed gives
    the same weights whatever the device) and then moved."""
    fan_in, fan_out = shape[0], shape[-1]
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    w = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (w * (2 * lim) - lim).to(device)


def init_gcn(generator: torch.Generator, in_dim: int, out_dim: int,
             device="cuda") -> dict:
    return {"w": _glorot(generator, (in_dim, out_dim), device),
            "b": torch.zeros((out_dim,), dtype=torch.float32, device=device)}


def init_sage(generator: torch.Generator, in_dim: int, out_dim: int,
              device="cuda") -> dict:
    return {"w_self": _glorot(generator, (in_dim, out_dim), device),
            "w_neigh": _glorot(generator, (in_dim, out_dim), device),
            "b": torch.zeros((out_dim,), dtype=torch.float32, device=device)}


def init_gin(generator: torch.Generator, in_dim: int, out_dim: int,
             hidden: int | None = None, device="cuda") -> dict:
    hidden = hidden or out_dim
    return {"eps": torch.zeros((), dtype=torch.float32, device=device),
            "w1": _glorot(generator, (in_dim, hidden), device),
            "b1": torch.zeros((hidden,), dtype=torch.float32, device=device),
            "w2": _glorot(generator, (hidden, out_dim), device),
            "b2": torch.zeros((out_dim,), dtype=torch.float32, device=device)}


def params_from_jax(params: dict, device="cuda") -> dict:
    """The reference's params (layer dicts such as ``{'l1': {'w_self':
    ...}}`` beside top-level arrays such as gat's ``'proj'``; leaves
    handed over as numpy arrays or anything ``np.asarray`` takes) as the
    port's: the same keys, fp32 tensors on ``device``."""
    def leaf(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)
                                ).to(device)
    return {key: {name: leaf(x) for name, x in p.items()}
            if hasattr(p, "items") else leaf(p)
            for key, p in params.items()}


# --------------------------------------------------------------------------
# Full-graph layers (a GraphBundle)
# --------------------------------------------------------------------------

def gcn_conv(params: dict, bundle, h: torch.Tensor) -> torch.Tensor:
    """GCN (Kipf & Welling): ``Â (h W) + b`` with Â = D^-1/2 (A+I) D^-1/2.
    Projects first, so the SpMM runs at the output width."""
    h = h @ params["w"]
    spmm_fn = resolve("spmm")
    if is_patched():
        out = spmm_fn(bundle.tuned_norm, h, "sum")       # cached Â — §3.3
    else:
        a_n = baselines.gcn_norm_in_step(bundle.raw_sl)   # per-step norm
        out = spmm_fn(a_n, h, "sum")
    return out + params["b"]


def sage_conv(params: dict, bundle, h: torch.Tensor,
              aggr: str = "mean") -> torch.Tensor:
    """GraphSAGE: ``h W_s + agg_{j in N(i)} h_j W_n + b``."""
    g = bundle.tuned if is_patched() else bundle.raw
    agg = resolve("spmm")(g, h, aggr)
    return h @ params["w_self"] + agg @ params["w_neigh"] + params["b"]


def gin_conv(params: dict, bundle, h: torch.Tensor) -> torch.Tensor:
    """GIN: ``MLP((1 + eps) h + sum_{j in N(i)} h_j)``."""
    g = bundle.tuned if is_patched() else bundle.raw
    s = resolve("spmm")(g, h, "sum")
    z = (1.0 + params["eps"]) * h + s
    z = torch.relu(z @ params["w1"] + params["b1"])
    return z @ params["w2"] + params["b2"]


def init_gat(generator: torch.Generator, in_dim: int, out_dim: int,
             device="cuda") -> dict:
    return {"wq": _glorot(generator, (in_dim, out_dim), device),
            "wk": _glorot(generator, (in_dim, out_dim), device),
            "wv": _glorot(generator, (in_dim, out_dim), device)}


def dot_gat_conv(params: dict, bundle, h: torch.Tensor) -> torch.Tensor:
    """Dot-product graph attention: ``out_i = Σ_{j in N(i)} softmax_j(q_i
    · k_j / sqrt(out_dim)) v_j`` with ``q, k, v = h W_q, h W_k, h W_v``.
    Both bindings take the raw adjacency's cached graph; the tuned one
    runs FusedMM (scores never reach device memory on the fused route),
    the baseline the unfused composition."""
    q = h @ params["wq"]
    k = h @ params["wk"]
    v = h @ params["wv"]
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    return resolve("fusedmm")(bundle.graph("gat"), q * scale, k, v,
                              edge_op="softmax")


# --------------------------------------------------------------------------
# Block layers (one sampled bipartite block)
# --------------------------------------------------------------------------

def _block_dst(pb, h: torch.Tensor) -> torch.Tensor:
    """Destination-row view of a block's source features: a ``dst_pos``
    gather (pad positions read zero rows)."""
    return take_rows(h, pb.dst_pos)


def sage_conv_block(params: dict, pb, h: torch.Tensor,
                    aggr: str = "mean") -> torch.Tensor:
    """GraphSAGE over one sampled bipartite block: ``h`` holds the block's
    source rows; the output has the block's (padded) dst rows."""
    agg = resolve("block_spmm")(pb, h, aggr)
    h_dst = _block_dst(pb, h)
    return h_dst @ params["w_self"] + agg @ params["w_neigh"] + params["b"]


def gin_conv_block(params: dict, pb, h: torch.Tensor) -> torch.Tensor:
    """GIN over one sampled bipartite block (operands as
    :func:`sage_conv_block`)."""
    s = resolve("block_spmm")(pb, h, "sum")
    z = (1.0 + params["eps"]) * _block_dst(pb, h) + s
    z = torch.relu(z @ params["w1"] + params["b1"])
    return z @ params["w2"] + params["b2"]
