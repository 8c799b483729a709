"""Semiring definitions for generalized sparse-dense matmul (paper §3.4).

A semiring here is the pair (⊕ reduce, ⊗ combine) applied as

    out[i, :] = ⊕_{j : A_ij != 0}  (A_ij ⊗ H[j, :])

Supported reductions: 'sum', 'mean', 'min', 'max'. Supported combines:
'mul' (weighted messages, the default), 'add' and 'second' (ignore A's
value). Only sum (and mean = sum + inverse-degree scale) has hand-kernel
support; min/max always take the trusted ``index_add_``/``scatter_reduce``
path, as in the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Semiring", "get_semiring", "REDUCTIONS", "COMBINES"]

REDUCTIONS = ("sum", "mean", "max", "min")
COMBINES = ("mul", "add", "second")


def _combine(name: str) -> Callable:
    if name == "mul":
        return lambda a, h: a * h
    if name == "add":
        return lambda a, h: a + h
    if name == "second":
        return lambda a, h: h
    raise ValueError(f"unknown combine {name!r}")


@dataclasses.dataclass(frozen=True)
class Semiring:
    reduce: str           # ⊕
    combine: str = "mul"  # ⊗

    def __post_init__(self):
        if self.reduce not in REDUCTIONS:
            raise ValueError(f"reduce must be one of {REDUCTIONS}")
        if self.combine not in COMBINES:
            raise ValueError(f"combine must be one of {COMBINES}")

    @property
    def identity(self) -> float:
        return {"sum": 0.0, "mean": 0.0, "max": -float("inf"),
                "min": float("inf")}[self.reduce]

    @property
    def mxu_eligible(self) -> bool:
        """True iff the hand-written sum kernels compute this semiring
        (mean is the post-scaled sum). The name follows the reference's
        tuner vocabulary."""
        return self.reduce in ("sum", "mean") and self.combine == "mul"

    def apply_combine(self, a, h):
        return _combine(self.combine)(a, h)

    def reduce_into(self, out: torch.Tensor, data: torch.Tensor,
                    segment_ids: torch.Tensor) -> torch.Tensor:
        """The trusted reduce: ``out[segment_ids[i]] ⊕= data[i]``, returning
        the result. Start ``out`` at :attr:`identity`; empty max/min rows
        keep the ±inf identity until :meth:`finalize`. In place, except a
        max/min that autograd records: the backward of each scatter reads
        its own result, so chained chunks must not overwrite it."""
        ids = segment_ids.long()
        if self.reduce in ("sum", "mean"):
            return out.index_add_(0, ids, data)
        ids = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
        how = "amax" if self.reduce == "max" else "amin"
        if torch.is_grad_enabled() and (data.requires_grad
                                        or out.requires_grad):
            return out.scatter_reduce(0, ids, data, how, include_self=True)
        return out.scatter_reduce_(0, ids, data, how, include_self=True)

    def finalize(self, out: torch.Tensor, degrees=None) -> torch.Tensor:
        """Post-reduction fixups: mean-scaling and empty-row identities."""
        if self.reduce == "mean":
            assert degrees is not None, "mean reduction needs cached degrees"
            out = out * (1.0 / torch.clamp(degrees, min=1.0))[:, None]
        if self.reduce in ("max", "min"):
            # empty rows -> 0 (PyG convention)
            out = torch.where(torch.isinf(out), torch.zeros_like(out), out)
        return out


def get_semiring(reduce: str = "sum", combine: str = "mul") -> Semiring:
    return Semiring(reduce=reduce, combine=combine)
