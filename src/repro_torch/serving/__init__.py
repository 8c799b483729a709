"""repro_torch.serving — online GNN inference with micro-batching and a
device-resident feature cache.

    request -> MicroBatcher -> flush -> sample -> pack -> cache gather
            -> apply_blocks (ELL/SELL kernels) -> per-ticket logits
"""
from repro_torch.serving.batcher import Flush, MicroBatcher, Ticket
from repro_torch.serving.feature_cache import CacheStats, FeatureCache
from repro_torch.serving.server import SERVE_MODES, GNNServer

__all__ = [
    "Ticket",
    "Flush",
    "MicroBatcher",
    "FeatureCache",
    "CacheStats",
    "GNNServer",
    "SERVE_MODES",
]
