"""Shape buckets — a bounded set of shapes for per-batch graphs.

Every minibatch yields blocks with slightly different node/edge counts.
A geometric ladder pads counts up to the smallest ``base * growth^i``, so
the number of distinct shapes a workload can produce is logarithmic in
its range: the autotuner runs once per bucket, and the port keeps the
same shapes as the reference (the parity tests compare packed blocks),
which also bounds the shapes a later CUDA-graph capture would need.

``plan_buckets`` applies the ladder to a sampled block stack while
preserving the chaining invariant (layer i's padded dst count must equal
layer i+1's padded src count — the levels are bucketed once and shared by
the two blocks that meet there). Sampled blocks get their edge capacity
for free: fanout x padded-dst is already static, no edge ladder needed.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.sampling.sampler import Block

__all__ = ["round_bucket", "LayerBucket", "plan_buckets", "merge_buckets"]


def round_bucket(n: int, *, base: int = 128, growth: float = 2.0) -> int:
    """Smallest ``base * growth^i >= n`` (``n <= 0`` -> ``base``)."""
    if n <= base:
        return base
    steps = math.ceil(math.log(n / base, growth) - 1e-9)
    return int(round(base * growth ** steps))


@dataclasses.dataclass(frozen=True)
class LayerBucket:
    """Static sizes one packed block is padded to."""
    n_dst: int
    n_src: int
    nnz: int
    ell_width: int              # static neighbor-table width for ELL plans
    sell_steps: int | None      # static packed-step count for SELL plans

    @property
    def signature(self) -> tuple:
        return (self.n_dst, self.n_src, self.nnz, self.ell_width,
                self.sell_steps)


def plan_buckets(blocks: list[Block], *, batch_size: int,
                 fanouts=None, base: int = 128, growth: float = 2.0,
                 sell_step_base: int = 64) -> list[LayerBucket]:
    """Bucket sizes for one sampled block stack (outermost first).

    Node levels: level L (the seeds) is pinned to ``batch_size``; inner
    levels ride the ladder. Edge capacity per layer: ``fanout * n_dst``
    when the layer has a finite fanout (static by construction), else the
    ladder over the observed edge count. ``sell_steps`` here is a
    ladder-rounded *hint* — callers packing with a SELL plan re-round the
    actual packed step count (see ``sampling/blocks.pack_block``)."""
    fanouts = tuple(fanouts) if fanouts is not None else (None,) * len(blocks)
    assert len(fanouts) == len(blocks), (len(fanouts), len(blocks))

    # levels[i] = source count of blocks[i]; levels[-1] = seed count
    levels = [round_bucket(b.n_src, base=base, growth=growth)
              for b in blocks] + [batch_size]
    out = []
    for i, (blk, fanout) in enumerate(zip(blocks, fanouts)):
        n_dst, n_src = levels[i + 1], levels[i]
        if fanout is not None:
            nnz, width = n_dst * int(fanout), int(fanout)
        else:
            nnz = round_bucket(blk.nnz, base=base, growth=growth)
            width = round_bucket(int(blk.degrees().max()) if blk.n_dst
                                 else 1, base=8, growth=growth)
        steps = round_bucket(max(blk.nnz // 8, 1), base=sell_step_base,
                             growth=growth)
        out.append(LayerBucket(n_dst=n_dst, n_src=n_src, nnz=nnz,
                               ell_width=width, sell_steps=steps))
    return out


def merge_buckets(bucket_lists: list[list[LayerBucket]]) -> list[LayerBucket]:
    """Unify per-shard bucket stacks into one lockstep stack (field-wise
    max per layer).

    The data-parallel step runs the *same* compiled program on every
    shard, so all shards must pack to identical static shapes each step.
    Taking the max per field preserves the chaining invariant: each
    shard's ``outer.n_dst`` and ``inner.n_src`` derive from the same level
    value, so their shard-maxes agree too. Ladder values are closed under
    max, so the merged stack still takes log-many distinct signatures."""
    merged = []
    for layer in zip(*bucket_lists):
        steps = [b.sell_steps for b in layer if b.sell_steps is not None]
        merged.append(LayerBucket(
            n_dst=max(b.n_dst for b in layer),
            n_src=max(b.n_src for b in layer),
            nnz=max(b.nnz for b in layer),
            ell_width=max(b.ell_width for b in layer),
            sell_steps=max(steps) if steps else None))
    return merged
