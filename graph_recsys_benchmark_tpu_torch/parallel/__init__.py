"""Edge-parallel training over torch.distributed: the JAX package's
``parallel/`` for mode 'edge' (multihost.py, mesh.py, collectives.py,
edge_parallel.py, engine.py).  The row-sharded modes 'dp' and 'a2a' raise
NotImplementedError naming their ROADMAP item (mesh.ROW_SHARDED_ITEM)."""

from .collectives import all_reduce_grads, pmax, psum
from .edge_parallel import (
    make_edge_sharded_train_step,
    make_stream_edge_sharded_train_step,
    plan_channel_shards,
    shard_fused_graphs,
    shard_step_graph,
)
from .engine import ShardedPEATrainer, make_sharded_kg_trainer
from .mesh import ROW_SHARDED_ITEM, Mesh
from .multihost import (
    HostBatchFeed,
    global_batch,
    initialize_runtime,
    make_pod_mesh,
    process_local_rows,
)

__all__ = [
    "HostBatchFeed",
    "Mesh",
    "ROW_SHARDED_ITEM",
    "ShardedPEATrainer",
    "all_reduce_grads",
    "global_batch",
    "initialize_runtime",
    "make_edge_sharded_train_step",
    "make_pod_mesh",
    "make_sharded_kg_trainer",
    "make_stream_edge_sharded_train_step",
    "plan_channel_shards",
    "pmax",
    "process_local_rows",
    "psum",
    "shard_fused_graphs",
    "shard_step_graph",
]
