"""Mesh-axis resolution of the distributed GNN path
(``src/repro/dist/sharding.py``).

The reference's module holds the logical-axis sharding rules of the LM
side too; those wait for ROADMAP.md queue 1, item 5b. Here is the one
function the 2-D vertex-cut path needs.
"""
from __future__ import annotations

__all__ = ["grid_axes"]


def grid_axes(mesh) -> tuple[str, str]:
    """The ``(row, col)`` mesh-axis pair the 2-D vertex-cut GNN path runs
    over: the literal ``('row', 'col')`` axes where the mesh has them
    (what :func:`~repro_torch.dist.mesh.make_grid_mesh` builds), else the
    mesh's first two axes in order (a ``('data', 'model')`` mesh runs the
    grid ``(data, 1)``)."""
    names = tuple(mesh.shape)
    if "row" in names and "col" in names:
        return "row", "col"
    if len(names) < 2:
        raise ValueError(f"the 2-D partition needs a mesh of two axes or "
                         f"more, got {names}")
    return names[0], names[1]
