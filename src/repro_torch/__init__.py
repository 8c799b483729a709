"""repro_torch — the PyTorch/CUDA port of the iSpLib reproduction.

A second package beside the JAX reference ``repro``, module for module.
It imports ``torch`` and never ``jax`` or ``repro``. The TPU's Pallas
kernels become CUDA kernels written by hand for Hopper (``csrc/``), each
with a plain PyTorch version beside it; entry points run on ``cuda``
unless the caller passes ``device="cpu"``.

Ported so far:

- GNN serving (``repro_torch.serving.GNNServer``, modes ``sampled``,
  ``full`` and ``historical``, and ``offline_logits``) through the ELL and
  SELL SpMM kernels;
- full-graph training through ``patch()``
  (``repro_torch.train.gnn.train_gnn``) with cache-enabled
  backpropagation over the SELL, ELL and BSR kernels, and dot-product
  graph attention (``gat``) through the FusedMM kernel, with the block
  SDDMM kernel beside it;
- neighbour-sampled minibatch training with the host or the device
  sampler (``repro_torch.train.gnn_minibatch``; the three sampling
  kernels) and exact layer-wise inference;
- LM serving of the dense and MoE families
  (``repro_torch.models.lm.prefill`` / ``decode_step``) through the flash
  attention and ragged GEMM kernels, and their training
  (``repro_torch.train.lm.make_train_step``: AdamW, clipping,
  accumulation, int8 error feedback) through those kernels and their
  backwards (the flash attention backward kernel, the ragged GEMM's dX).

Still to port: the ssm / hybrid families and the audio / vlm front
ends, checkpointing and fault tolerance, distribution (ROADMAP queue 1).
"""
