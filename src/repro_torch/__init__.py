"""repro_torch — the PyTorch/CUDA port of the iSpLib reproduction.

A second package beside the JAX reference ``repro``, module for module.
It imports ``torch`` and never ``jax`` or ``repro``. The TPU's Pallas
kernels become CUDA kernels written by hand for Hopper (``csrc/``), each
with a plain PyTorch version beside it; entry points run on ``cuda``
unless the caller passes ``device="cpu"``.

Ported so far: online serving (``repro_torch.serving.GNNServer``, modes
``sampled`` and ``full``) through the ELL and SELL SpMM kernels, and
full-graph training through ``patch()`` (``repro_torch.train.gnn.train_gnn``)
with cache-enabled backpropagation over the SELL, ELL and BSR kernels.
"""
