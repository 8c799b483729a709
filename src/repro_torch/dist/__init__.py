"""repro_torch.dist — data parallelism over ``torch.distributed``.

The reference's ``repro.dist`` runs every rank in one process under
``shard_map``; the port runs one process a rank. This slice holds the
data-parallel half (ROADMAP.md queue 1, item 5a):

* :mod:`~repro_torch.dist.mesh` — the ``('data', 'model')`` :class:`Mesh`
  of a rank, the backend rule (NCCL with a card a rank, gloo where ranks
  share a card or run on the CPU) and :func:`run_ranks`, which starts
  the ranks;
* :mod:`~repro_torch.dist.collectives` — ``sync_grads`` (the fp32 wire
  and the int8 ``compressed_psum``), ``all_agree``, ``psum`` / ``pmean``,
  ``wire_bytes``, ``replicas_equal``.

The other half (item 5b) waits: the 1-D and 2-D distributed SpMM, the
pipeline, the sharding rules, the expert-parallel MoE, sharded restore
and data-parallel resume.
"""
from repro_torch.dist.collectives import (all_agree, axis_size,
                                          compressed_psum, pmean, psum,
                                          replicas_equal, sync_grads,
                                          wire_bytes)
from repro_torch.dist.mesh import (Mesh, axis_shard_count, choose_backend,
                                   init_ranks, make_data_mesh,
                                   make_local_mesh, run_ranks)

__all__ = [
    "Mesh", "axis_shard_count", "choose_backend", "make_data_mesh",
    "make_local_mesh", "init_ranks", "run_ranks",
    "axis_size", "all_agree", "psum", "pmean", "compressed_psum",
    "sync_grads", "wire_bytes", "replicas_equal",
]
