"""repro_torch.kernels — hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the device dispatch over them (:mod:`.ops`).

Sources live in ``repro_torch/csrc``; :mod:`.build` compiles them with
``nvcc`` at first use. Importing this package builds and loads nothing.
"""
