"""repro_torch.models.gnn — GraphSAGE / GIN layers over sampled blocks."""
from repro_torch.models.gnn.layers import (gin_conv_block, init_gin,
                                           init_sage, params_from_jax,
                                           sage_conv_block)

__all__ = ["init_sage", "init_gin", "sage_conv_block", "gin_conv_block",
           "params_from_jax"]
