"""repro_torch.sampling — neighbor-sampled blocks for training and serving.

    seed loader        repro_torch.sampling.loader        shuffled padded
        │                                                  batches, prefetch
        │                                                  (restarting)
    k-hop sampler      repro_torch.sampling.sampler       host, numpy
                       repro_torch.sampling.device_graph  device, hand kernels
        │
    bucket ladder      repro_torch.sampling.buckets       log-many shapes
        │
    plan-aware pack    repro_torch.sampling.blocks        ELL/SELL per autotuned
                                                          bucket plan

The block aggregation is registered as the ``block_spmm`` op of the patch
registry: patched -> plan-routed hand kernels, un-patched -> the trusted
segment reduce.
"""
from repro_torch.core.patch import register_baseline, register_tuned
from repro_torch.sampling.sampler import Block, NeighborSampler
from repro_torch.sampling.blocks import (BlockPlanCache, PackedBlock,
                                         block_spmm, block_spmm_baseline,
                                         block_spmm_global, gather_rows,
                                         pack_block)
from repro_torch.sampling.buckets import (LayerBucket, merge_buckets,
                                          plan_buckets, round_bucket)
from repro_torch.sampling.device_graph import (DeviceGraph, DeviceSampler,
                                               device_graph_from_csr)
from repro_torch.sampling.loader import (num_seed_batches, prefetch,
                                         resilient_prefetch, seed_batches,
                                         shard_seeds)

register_tuned("block_spmm", block_spmm)
register_baseline("block_spmm", block_spmm_baseline)

__all__ = [
    "Block",
    "NeighborSampler",
    "PackedBlock",
    "BlockPlanCache",
    "pack_block",
    "block_spmm",
    "block_spmm_baseline",
    "block_spmm_global",
    "gather_rows",
    "LayerBucket",
    "plan_buckets",
    "merge_buckets",
    "round_bucket",
    "DeviceGraph",
    "DeviceSampler",
    "device_graph_from_csr",
    "num_seed_batches",
    "seed_batches",
    "shard_seeds",
    "prefetch",
    "resilient_prefetch",
]
