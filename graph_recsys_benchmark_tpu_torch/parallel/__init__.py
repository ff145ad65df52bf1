"""The parallel layer over torch.distributed: the JAX package's
``parallel/`` (multihost.py, mesh.py, collectives.py, edge_parallel.py,
spmd.py, sharded_embedding.py, a2a.py, engine.py) for the modes 'edge',
'dp' and 'a2a'."""

from .a2a import build_a2a_setup, make_a2a_parts, make_a2a_train_step
from .collectives import all_gather, all_reduce_grads, all_to_all, pmax, psum, psum_scatter
from .edge_parallel import (
    make_edge_sharded_train_step,
    make_stream_edge_sharded_train_step,
    plan_channel_shards,
    shard_fused_graphs,
    shard_step_graph,
)
from .engine import ShardedPEATrainer, make_sharded_kg_trainer
from .mesh import Mesh
from .multihost import (
    HostBatchFeed,
    global_batch,
    initialize_runtime,
    make_pod_mesh,
    process_local_rows,
)
from .sharded_embedding import build_static_plan, sharded_lookup, static_lookup
from .spmd import make_sharded_train_step, param_shardings

# JAX parallel/mesh.make_mesh: one process a rank, the world is the mesh
make_mesh = make_pod_mesh


__all__ = [
    "HostBatchFeed",
    "Mesh",
    "ShardedPEATrainer",
    "all_gather",
    "all_reduce_grads",
    "all_to_all",
    "build_a2a_setup",
    "build_static_plan",
    "global_batch",
    "initialize_runtime",
    "make_a2a_parts",
    "make_a2a_train_step",
    "make_edge_sharded_train_step",
    "make_mesh",
    "make_pod_mesh",
    "make_sharded_kg_trainer",
    "make_sharded_train_step",
    "make_stream_edge_sharded_train_step",
    "param_shardings",
    "plan_channel_shards",
    "pmax",
    "process_local_rows",
    "psum",
    "psum_scatter",
    "shard_fused_graphs",
    "shard_step_graph",
    "sharded_lookup",
    "static_lookup",
]
