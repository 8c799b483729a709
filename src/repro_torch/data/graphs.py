"""Synthetic graph registry mirroring the paper's Table 1.

Each entry is an R-MAT graph with the published shape statistics (node
count, edge count, feature width, class count) scaled by ``scale``;
``scale=1`` is the full Table-1 size. Generation is the same numpy code
as the reference package, so for one ``(name, scale, seed)`` both
packages build the same edges, features and labels bit for bit; this one
returns them as CPU tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sparse as sp

__all__ = ["GraphDataset", "DATASETS", "make_dataset", "rmat_edges",
           "dataset_names"]


@dataclasses.dataclass(frozen=True)
class TableRow:
    nodes: int
    edges: int
    feat: int
    classes: int


DATASETS: dict[str, TableRow] = {
    "reddit":        TableRow(nodes=232_965,   edges=11_606_919,  feat=602, classes=41),
    "reddit2":       TableRow(nodes=232_965,   edges=23_213_838,  feat=602, classes=41),
    "ogbn-mag":      TableRow(nodes=736_389,   edges=10_792_672,  feat=128, classes=349),
    "amazon":        TableRow(nodes=1_569_960, edges=264_339_468, feat=200, classes=107),
    "ogbn-products": TableRow(nodes=2_449_029, edges=61_859_140,  feat=100, classes=47),
    "ogbn-proteins": TableRow(nodes=132_534,   edges=39_561_252,  feat=8,   classes=112),
}


def dataset_names() -> list[str]:
    return list(DATASETS)


@dataclasses.dataclass(frozen=True)
class GraphDataset:
    name: str
    coo: sp.COO             # raw adjacency (message-passing orientation)
    coo_sl: sp.COO          # adjacency + self loops
    x: torch.Tensor         # (n, feat) float32 features, CPU
    y: torch.Tensor         # (n,) int32 labels
    train_mask: torch.Tensor
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return self.coo.nrows

    @property
    def num_features(self) -> int:
        return self.x.shape[1]


def rmat_edges(n: int, m: int, seed: int = 0,
               probs=(0.57, 0.19, 0.19, 0.05)) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized R-MAT over log2(n) bit levels for all m edges at once;
    duplicates are dropped, so the edge count is within a few % of m."""
    rng = np.random.default_rng(seed)
    levels = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    a, b, c, d = probs
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(levels):
        r = rng.random(m)
        right = (r >= a) & (r < a + b)          # quadrant B: dst bit 1
        down = (r >= a + b) & (r < a + b + c)   # quadrant C: src bit 1
        both = r >= a + b + c                   # quadrant D: both bits 1
        src = src * 2 + (down | both)
        dst = dst * 2 + (right | both)
    src %= n
    dst %= n
    key = src * n + dst
    _, keep = np.unique(key, return_index=True)
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def _with_self_loops(src: np.ndarray, dst: np.ndarray, n: int):
    eye = np.arange(n, dtype=np.int32)
    return np.concatenate([src, eye]), np.concatenate([dst, eye])


def make_dataset(name: str, scale: float = 1 / 32, seed: int = 0,
                 pad_edges_to_multiple: int = 1024) -> GraphDataset:
    """Instantiate a Table-1-shaped synthetic dataset at ``scale``."""
    row = DATASETS[name]
    n = max(int(row.nodes * scale), 64)
    m = max(int(row.edges * scale), 4 * n)
    src, dst = rmat_edges(n, m, seed=seed)

    def pad(x):
        return -(-x // pad_edges_to_multiple) * pad_edges_to_multiple

    coo = sp.coo_from_edges(src, dst, None, n, n, pad_to=pad(len(src)))
    src_sl, dst_sl = _with_self_loops(src, dst, n)
    coo_sl = sp.coo_from_edges(src_sl, dst_sl, None, n, n,
                               pad_to=pad(len(src_sl)))

    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, row.feat)).astype(np.float32)
    # labels follow R-MAT's id-local communities, perturbed by noise, and
    # the features carry the label signal
    comm = (np.arange(n) * row.classes // n).astype(np.int64)
    noise = rng.integers(0, row.classes, n)
    take_noise = rng.random(n) < 0.1
    y = np.where(take_noise, noise, comm).astype(np.int32)
    x[np.arange(n), y % row.feat] += 2.0

    idx = rng.permutation(n)
    n_tr, n_va = int(0.6 * n), int(0.2 * n)
    train_mask = np.zeros(n, bool)
    train_mask[idx[:n_tr]] = True
    val_mask = np.zeros(n, bool)
    val_mask[idx[n_tr:n_tr + n_va]] = True
    test_mask = np.zeros(n, bool)
    test_mask[idx[n_tr + n_va:]] = True

    return GraphDataset(
        name=name, coo=coo, coo_sl=coo_sl,
        x=torch.from_numpy(x), y=torch.from_numpy(y),
        train_mask=torch.from_numpy(train_mask),
        val_mask=torch.from_numpy(val_mask),
        test_mask=torch.from_numpy(test_mask), num_classes=row.classes)
