"""repro_torch.models.gnn — GCN / GraphSAGE / GIN layers, full-graph and
over sampled blocks, dot-product graph attention, and the two-layer
models of the paper's §4."""
from repro_torch.models.gnn.bundle import GraphBundle, build_bundle
from repro_torch.models.gnn.layers import (dot_gat_conv, gcn_conv,
                                           gin_conv, gin_conv_block,
                                           init_gat, init_gcn, init_gin,
                                           init_sage, params_from_jax,
                                           sage_conv, sage_conv_block)
from repro_torch.models.gnn.models import GNN_ARCHS, make_gnn

__all__ = ["GraphBundle", "build_bundle", "GNN_ARCHS", "make_gnn",
           "init_gcn", "init_sage", "init_gin", "gcn_conv", "sage_conv",
           "gin_conv", "sage_conv_block", "gin_conv_block", "init_gat",
           "dot_gat_conv", "params_from_jax"]
