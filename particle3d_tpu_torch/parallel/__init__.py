"""Multi-rank scale-out on torch.distributed: the 1-D mesh, ring all-pairs
and the slab domain decomposition with its halo exchange."""

from .mesh import Mesh, make_mesh
from .launch import cluster_env_configured, initialize_distributed
from .ring import (ring_forces, ring_forces_masked, shard_state,
                   sharded_simulate, sharded_step)
from .domain_sharded import (build_sharded_dense, gather_sharded_dense,
                             init_sharded_dense, sharded_dense_simulate,
                             sharded_dense_steps, sharded_exact_steps,
                             sharded_relayout)

__all__ = [
    "Mesh", "make_mesh", "cluster_env_configured", "initialize_distributed",
    "ring_forces", "ring_forces_masked", "shard_state", "sharded_simulate",
    "sharded_step", "build_sharded_dense", "gather_sharded_dense",
    "init_sharded_dense", "sharded_dense_simulate", "sharded_dense_steps",
    "sharded_exact_steps", "sharded_relayout",
]
