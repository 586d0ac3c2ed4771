"""Multi-rank scale-out on torch.distributed: the 1-D and 2-level meshes,
ring all-pairs, the column-slab cell list, the slab domain decomposition
with its halo exchange and adaptive driver. The multi-rank dry run is
``parallel.dryrun``."""

from .mesh import Mesh, Mesh2D, make_mesh, make_mesh_2d
from .launch import (auto_mesh_2d, cluster_env_configured,
                     initialize_distributed, mesh_shape_2level,
                     shard_state_2level, sharded_simulate_2level)
from .ring import (ring_forces, ring_forces_2level, ring_forces_masked,
                   shard_state, sharded_simulate, sharded_step)
from .domain import sharded_cell_simulate, sharded_dense_forces
from .domain_sharded import (build_sharded_dense, gather_sharded_dense,
                             init_sharded_dense, recap_sharded_dense,
                             sharded_dense_adaptive, sharded_dense_simulate,
                             sharded_dense_steps, sharded_exact_steps,
                             sharded_relayout)

__all__ = [
    "Mesh", "Mesh2D", "make_mesh", "make_mesh_2d", "auto_mesh_2d",
    "cluster_env_configured", "initialize_distributed", "mesh_shape_2level",
    "shard_state_2level", "sharded_simulate_2level", "ring_forces",
    "ring_forces_2level", "ring_forces_masked", "shard_state",
    "sharded_simulate", "sharded_step", "sharded_cell_simulate",
    "sharded_dense_forces", "build_sharded_dense", "gather_sharded_dense",
    "init_sharded_dense", "recap_sharded_dense", "sharded_dense_adaptive",
    "sharded_dense_simulate", "sharded_dense_steps", "sharded_exact_steps",
    "sharded_relayout",
]
