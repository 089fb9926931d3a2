"""Several devices: process groups, meshes, collectives, graph partitioning,
data-parallel training and the mesh simulation chunks.

Port of ``chgnet_tpu.parallel`` over ``torch.distributed``, one process per
device (NCCL between cards, gloo on the CPU). Every rank calls an entry
point with the same arguments.
"""

from chgnet_tpu_torch.parallel.distributed import initialize, make_hybrid_mesh
from chgnet_tpu_torch.parallel.dp import (
    make_dp_train_step,
    make_single_device_train_step,
    stack_batches,
    stack_targets,
)
from chgnet_tpu_torch.parallel.graph_sharded import (
    HaloBatch,
    ShardedGraphBatch,
    compute_batch_sharded,
    compute_batch_sharded_halo,
    local_shard,
    make_graph_sharded_train_step,
    shard_batch,
    shard_batch_halo,
    shard_targets,
    unshard_atoms,
)
from chgnet_tpu_torch.parallel.md_sharded import md_chunk_sharded
from chgnet_tpu_torch.parallel.mesh import Mesh, make_mesh
from chgnet_tpu_torch.parallel.relax_sharded import fire_chunk_sharded

__all__ = [
    "HaloBatch",
    "Mesh",
    "ShardedGraphBatch",
    "compute_batch_sharded",
    "compute_batch_sharded_halo",
    "fire_chunk_sharded",
    "initialize",
    "local_shard",
    "make_dp_train_step",
    "make_graph_sharded_train_step",
    "make_hybrid_mesh",
    "make_mesh",
    "make_single_device_train_step",
    "md_chunk_sharded",
    "shard_batch",
    "shard_batch_halo",
    "shard_targets",
    "stack_batches",
    "stack_targets",
    "unshard_atoms",
]
