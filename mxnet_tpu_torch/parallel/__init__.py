"""Parallelism toolkit of the port (ref: the JAX package's parallel/): meshes
over the group's ranks, explicit collectives, shardings of local blocks,
SPMD training, ring attention, the pipeline, MoE, tables sharded over a
mesh (``sharded_embedding``) and the sparse embedding plane."""
from .mesh import (make_mesh, auto_mesh, local_devices, MeshScope,  # noqa
                   current_mesh, axis_size)
from .collectives import (allreduce, allgather, reduce_scatter,  # noqa
                          broadcast, ppermute_ring, all_to_all, barrier,
                          device_allreduce, measure_allreduce_bandwidth)
from .sharding import (P, named_sharding, shard_batch, replicate,  # noqa
                       ShardingPlan, MP_RULES_TRANSFORMER)
from .spmd import SPMDTrainer  # noqa: F401
from .ring_attention import attention, ring_attention  # noqa: F401
from .moe import init_moe_params, moe_param_specs, moe_ffn  # noqa: F401
from .pipeline import pipeline_apply  # noqa: F401
from .embedding_plane import (EmbeddingPlane, row_partition,  # noqa: F401
                              sparse_plane_requested, sparse_max_rows)
from .sharded_embedding import ShardedEmbedding  # noqa: F401
