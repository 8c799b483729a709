"""repro_torch.core: sparse formats, semirings, the autotuner, the cached
graph, and the patch registry of the PyTorch port (the differentiable
SpMM is ``repro_torch.core.spmm.spmm``, SDDMM and FusedMM are
``repro_torch.core.sddmm.sddmm`` and ``repro_torch.core.fusedmm.fusedmm``;
their helpers ``masked_edge_scores`` and ``edge_weights`` are exported
here).

Functions named like their submodule (``patch``, ``autotune``) are
imported from that module (``from repro_torch.core.patch import
patched``): this package rebinds no submodule name.
"""
from repro_torch.core.sparse import (BSR, COO, CSR, ELL, SELL,
                                     bsr_from_coo, coo_from_edges,
                                     coo_transpose, csr_from_coo,
                                     ell_from_coo, gcn_normalize,
                                     row_degrees, sell_from_coo,
                                     sell_slice_degrees, to_device)
from repro_torch.core.semiring import Semiring, get_semiring
from repro_torch.core.autotune import (H100, HardwareModel, KernelPlan,
                                       TuningDB, probe_hardware)
from repro_torch.core.cache import CachedGraph, build_cached_graph
from repro_torch.core.sddmm import masked_edge_scores
from repro_torch.core.fusedmm import edge_weights

__all__ = [
    "COO", "CSR", "BSR", "ELL", "SELL", "coo_from_edges", "csr_from_coo",
    "bsr_from_coo", "ell_from_coo", "sell_from_coo", "sell_slice_degrees",
    "to_device", "coo_transpose", "row_degrees", "gcn_normalize",
    "Semiring", "get_semiring", "H100", "HardwareModel", "KernelPlan",
    "TuningDB", "probe_hardware", "CachedGraph", "build_cached_graph",
    "masked_edge_scores", "edge_weights",
]
