"""repro_torch.dist — distribution over ``torch.distributed``.

The reference's ``repro.dist`` runs every rank in one process under
``shard_map``; the port runs one process a rank, and each rank holds only
its own shard: its band or tile of a distributed graph, its row shard of
the features. This package holds the data-parallel half (ROADMAP.md
queue 1, item 5a) and the distributed GNN half of item 5b:

* :mod:`~repro_torch.dist.mesh` — a rank's :class:`Mesh`: the
  ``('data', 'model')`` mesh of data parallelism and the ``('row',
  'col')`` grid of the 2-D vertex cut (:func:`make_grid_mesh`, a process
  group for each grid row and column); the backend rule (NCCL with a
  card a rank, gloo where ranks share a card or run on the CPU) and
  :func:`run_ranks`, which starts the ranks;
* :mod:`~repro_torch.dist.sharding` — :func:`grid_axes`;
* :mod:`~repro_torch.dist.collectives` — ``sync_grads`` (the fp32 wire
  and the int8 ``compressed_psum``), ``all_agree``, ``psum`` /
  ``pmean``, ``wire_bytes``, ``replicas_equal``; the GNN path's
  ``all_gather``, ``psum_scatter``, ``pmax``, ``axis_sum``,
  ``compressed_psum_scatter`` and ``ring_allgather_matmul``, with
  ``wire_stats``; the Megatron pair ``copy_to_axis`` /
  ``reduce_from_axis``, and ``gather_dim``;
* :mod:`~repro_torch.dist.gnn` — 1-D row bands (ELL or SELL) and the
  halo'd ``distributed_spmm``;
* :mod:`~repro_torch.dist.gnn2d` — the 2-D vertex-cut grid:
  ``distributed_spmm_2d``, ``distributed_sddmm_2d``,
  ``distributed_fusedmm_2d``.

The rest of item 5b waits: the manual expert-parallel MoE (5b.2), the
pipeline (5b.3), sharded restore and data-parallel resume (5b.4).
"""
from repro_torch.dist.collectives import (GLOO_STAGED, all_agree, all_gather,
                                          axis_size, axis_sum,
                                          compressed_psum,
                                          compressed_psum_scatter,
                                          copy_to_axis, gather_dim, pmax,
                                          pmean, psum, psum_scatter,
                                          reduce_from_axis, replicas_equal,
                                          reset_wire_stats,
                                          ring_allgather_matmul, sync_grads,
                                          wire_bytes, wire_stats)
from repro_torch.dist.gnn import (Band, Bands, DistGraph, build_band,
                                  build_dist_graph, comm_volume,
                                  distributed_spmm, shard_rows)
from repro_torch.dist.gnn2d import (Graph2D, Grid, build_tile, col_shard,
                                    comm_volume_2d, ell_tile_width,
                                    distributed_fusedmm_2d,
                                    distributed_sddmm_2d,
                                    distributed_spmm_2d, partition_2d,
                                    row_shard, scores_to_dense)
from repro_torch.dist.mesh import (Mesh, axis_shard_count, choose_backend,
                                   current_mesh, grid_shape, init_ranks,
                                   leading_axis_sharding, make_data_mesh,
                                   make_grid_mesh, make_local_mesh,
                                   make_production_mesh, replicated_device_put,
                                   replicated_sharding, run_ranks)
from repro_torch.dist.partition import (LM_RULES, batch_shardings,
                                        cache_shardings, gather_params,
                                        graph2d_shardings, param_logical_axes,
                                        param_shardings, shard_params,
                                        state_shardings)
from repro_torch.dist.sharding import (Rules, Sharding, current_rules,
                                       grid_axes, logical_sharding,
                                       resolve_spec, shard_constraint,
                                       split_axes, use_rules)

__all__ = [
    "Mesh", "axis_shard_count", "choose_backend", "make_data_mesh",
    "make_local_mesh", "make_grid_mesh", "make_production_mesh",
    "grid_shape", "grid_axes", "init_ranks", "run_ranks", "current_mesh",
    "replicated_sharding", "leading_axis_sharding", "replicated_device_put",
    "Rules", "use_rules", "current_rules", "resolve_spec",
    "logical_sharding", "Sharding", "split_axes", "shard_constraint",
    "LM_RULES", "param_logical_axes", "param_shardings", "state_shardings",
    "batch_shardings", "cache_shardings", "graph2d_shardings",
    "shard_params", "gather_params", "copy_to_axis", "reduce_from_axis",
    "gather_dim",
    "axis_size", "all_agree", "psum", "pmean", "compressed_psum",
    "sync_grads", "wire_bytes", "replicas_equal",
    "all_gather", "psum_scatter", "pmax", "axis_sum",
    "compressed_psum_scatter", "ring_allgather_matmul", "GLOO_STAGED",
    "wire_stats", "reset_wire_stats",
    "DistGraph", "Band", "Bands", "build_dist_graph", "build_band",
    "distributed_spmm",
    "comm_volume", "shard_rows",
    "Graph2D", "Grid", "partition_2d", "build_tile", "ell_tile_width",
    "distributed_spmm_2d",
    "distributed_sddmm_2d", "distributed_fusedmm_2d", "scores_to_dense", "comm_volume_2d",
    "row_shard", "col_shard",
]
