"""Logical-axis sharding: rule sets, the active rules, resolution, and a
rank's slice of a tensor (``src/repro/dist/sharding.py``).

Model code never names mesh axes. A tensor's dims carry *logical* axes
(``("d_model", "d_ff")``); a :class:`Rules` table maps each logical axis
to an ordered tuple of candidate mesh axes, and :func:`resolve_spec`
intersects the candidates with a mesh, skipping, as the reference does,

* a candidate axis absent from the mesh (the same rules serve a
  ``('data', 'model')`` mesh and a ``('pod', 'data', 'model')`` one);
* a mesh axis already used by an earlier dim of the same tensor;
* a candidate whose size does not divide the dim (small configs
  replicate instead of failing).

The result is the counterpart of a ``PartitionSpec``: a tuple with one
entry a dim (None, an axis name, or a tuple of names), trailing Nones
dropped.

The reference hands the spec to GSPMD, which places the data. The port
has no compiler to do that: each rank holds its own slice of a split
tensor (:meth:`Sharding.local`; :meth:`Sharding.gather` rebuilds the
whole), and the LM layers ask :func:`split_axes` which of their dims are
split under the active mesh (``with mesh:``) and rules, and call the
collectives themselves. So :func:`shard_constraint`, the reference's
placement hint, is an identity here, and ``use_rules(Rules({}))`` turns
the sharding off everywhere at once, as in the reference's data-parallel
step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.dist.mesh import current_mesh

__all__ = ["Rules", "use_rules", "current_rules", "shard_constraint",
           "resolve_spec", "logical_sharding", "Sharding", "split_axes",
           "grid_axes"]


def _normalize(axes) -> tuple:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Immutable logical-axis -> candidate-mesh-axes table."""

    table: Mapping[str, tuple]

    def __post_init__(self):
        object.__setattr__(self, "table",
                           {k: _normalize(v) for k, v in self.table.items()})

    def axes_for(self, name: str) -> tuple:
        return self.table.get(name, ())

    def override(self, **kw) -> "Rules":
        """New rule set with the given logical axes remapped, e.g.
        ``LM_RULES.override(seq="model")``."""
        return Rules(table={**self.table, **kw})


# the rule sets entered with ``use_rules``: process-wide, as the active
# mesh is (``dist.mesh.current_mesh``), because the autograd engine runs a
# card tensor's backward on a thread of its own, and a layer recomputed
# there (``torch.utils.checkpoint``) must split its products as the
# forward did
_ACTIVE: list = []


def current_rules() -> Rules:
    """The innermost :func:`use_rules` rule set, by default ``LM_RULES``."""
    if _ACTIVE:
        return _ACTIVE[-1]
    from repro_torch.dist.partition import LM_RULES   # lazy: import cycle
    return LM_RULES


@contextlib.contextmanager
def use_rules(rules: Rules):
    """Make ``rules`` the active rule set inside the block."""
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def resolve_spec(logical_axes: Sequence[Optional[str]], mesh,
                 shape: Sequence[int], rules: Optional[Rules] = None
                 ) -> tuple:
    """Logical axes -> spec against ``mesh`` (anything with a ``shape``
    dict of axis sizes) under ``rules`` (default: the active ones). The
    three skips of the module docstring; the spec never repeats a mesh
    axis and always divides ``shape``."""
    rules = rules or current_rules()
    if len(logical_axes) != len(shape):
        raise ValueError(f"logical axes {tuple(logical_axes)} for a tensor "
                         f"of shape {tuple(shape)}")
    used: set = set()
    out: list = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            out.append(None)
            continue
        picked: list = []
        prod = 1
        for ax in rules.axes_for(name):
            size = mesh.shape.get(ax)
            if size is None or ax in used:
                continue
            if dim % (prod * size) != 0:
                continue
            picked.append(ax)
            prod *= size
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    while out and out[-1] is None:      # trailing Nones are implicit
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A spec on a mesh: the counterpart of ``NamedSharding``. Dim ``i``
    is cut into ``prod(sizes of spec[i]'s axes)`` blocks, the first axis
    major (the reference's tiling of a tuple entry); this rank holds the
    block of its coordinates."""

    mesh: object
    spec: tuple

    def dim_axes(self, i: int) -> tuple:
        return _normalize(self.spec[i]) if i < len(self.spec) else ()

    def shards(self, i: int) -> int:
        return math.prod(int(self.mesh.shape[a]) for a in self.dim_axes(i))

    def block(self, i: int) -> int:
        """This rank's block index along dim ``i``."""
        b = 0
        for a in self.dim_axes(i):
            b = b * int(self.mesh.shape[a]) + self.mesh.index(a)
        return b

    @property
    def is_split(self) -> bool:
        return any(self.shards(i) > 1 for i in range(len(self.spec)))

    def local_shape(self, shape: Sequence[int]) -> tuple:
        return tuple(int(n) // self.shards(i) for i, n in enumerate(shape))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view; contiguous where the
        split is on dim 0 only)."""
        out = full
        for i in range(len(self.spec)):
            n = self.shards(i)
            if n > 1:
                step = full.shape[i] // n
                out = out.narrow(i, self.block(i) * step, step)
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block: an all-gather over
        each split dim's axes (a collective: every rank of those axes
        calls it)."""
        from repro_torch.dist.collectives import gather_dim
        out = local
        for i in range(len(self.spec)):
            for a in reversed(self.dim_axes(i)):   # the minor axis first
                out = gather_dim(out, self.mesh, a, i)
        return out


def logical_sharding(mesh, logical_axes: Sequence[Optional[str]],
                     shape: Sequence[int],
                     rules: Optional[Rules] = None) -> Sharding:
    """The :class:`Sharding` of a tensor annotated with logical axes."""
    return Sharding(mesh, resolve_spec(logical_axes, mesh, shape, rules))


def split_axes(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
               dim: int) -> tuple:
    """The mesh axes dim ``dim`` of a tensor of ``shape`` with these
    logical axes is split over, under the active mesh and rules: () with
    no active mesh, on a one-rank mesh, or where the rules leave the dim
    whole. What the LM layers ask before a product over ``'model'``."""
    mesh = current_mesh()
    if mesh is None or mesh.size <= 1:
        return ()
    spec = resolve_spec(logical_axes, mesh, shape)
    axes = _normalize(spec[dim]) if dim < len(spec) else ()
    return tuple(a for a in axes if int(mesh.shape[a]) > 1)


def shard_constraint(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """The reference's placement hint: an identity in the port, where each
    rank already holds its slice (see the module docstring)."""
    del logical_axes
    return x


def grid_axes(mesh) -> tuple[str, str]:
    """The ``(row, col)`` mesh-axis pair the 2-D vertex-cut GNN path runs
    over: the literal ``('row', 'col')`` axes where the mesh has them
    (what :func:`~repro_torch.dist.mesh.make_grid_mesh` builds), else the
    mesh's first two axes in order (a ``('data', 'model')`` mesh runs the
    grid ``(data, model)``)."""
    names = tuple(mesh.shape)
    if "row" in names and "col" in names:
        return "row", "col"
    if len(names) < 2:
        raise ValueError(f"the 2-D partition needs a mesh of two axes or "
                         f"more, got {names}")
    return names[0], names[1]
