"""repro_torch.core: sparse formats, semirings, the autotuner and the
patch registry of the PyTorch port.

Functions named like their submodule (``patch``, ``autotune``) are
imported from that module (``from repro_torch.core.patch import
patched``): this package rebinds no submodule name.
"""
from repro_torch.core.sparse import (COO, CSR, ELL, SELL, coo_from_edges,
                                     csr_from_coo, ell_from_coo,
                                     sell_from_coo, sell_slice_degrees,
                                     to_device)
from repro_torch.core.semiring import Semiring, get_semiring
from repro_torch.core.autotune import (H100, HardwareModel, KernelPlan,
                                       TuningDB, probe_hardware)

__all__ = [
    "COO", "CSR", "ELL", "SELL", "coo_from_edges", "csr_from_coo",
    "ell_from_coo", "sell_from_coo", "sell_slice_degrees", "to_device",
    "Semiring", "get_semiring", "H100", "HardwareModel", "KernelPlan",
    "TuningDB", "probe_hardware",
]
