"""particle3d_tpu_torch: PyTorch + CUDA port of particle3d_tpu for NVIDIA
Hopper (H100).

The JAX package ``particle3d_tpu`` stays the reference; this package
imports torch and numpy only. It carries the exact particle-life main
path (the incrementally maintained dense cell layout, the overflow sidecar
and the column-sweep kernel K1, ``csrc/celllist_sweep.cu``, driven by
``engine.step.simulate_dense``), K1 on a frozen layout
(``simulate_cadenced``) and on a layout kept across calls
(``simulate_dense_carry``), and the all-pairs backends with their kernels
K2, K3 and K4 (``csrc/allpairs_sweep.cu``): ``allpairs_pallas``,
``allpairs_culled`` and the capacity ladder's culled rung
``simulate_culled``; ``python -m particle3d_tpu_torch run`` drives them.
``app`` is the interactive app (``SimulationApp``, the HTTP server of the
browser UI, headless GIF export) and ``render`` the splat renderer on the
card; ``serve``, ``replay`` and ``resume`` are their commands, and
``utils.checkpoint`` and ``utils.trajio`` read and write the JAX
package's file formats. ``parallel`` holds the slab domain decomposition
on ``torch.distributed`` (K1's halo mode) and the ring all-pairs; ``python
-m particle3d_tpu_torch slab`` runs it stay-sharded. ``utils`` holds the
metrics, the profiling helpers, the geometry tuner (``tune``), the npz
checkpoints and the step-indexed ``OrbaxCheckpointer`` (``torch.save``,
slab carries written rank by rank); ``native`` binds the C++ reference
engine; the step differentiates on the ``allpairs`` and ``celllist``
backends (``examples.learn_matrix``).
"""

from .config import (SimConfig, ConfigError, reference_config, from_jax_config,
                     FORCE_LAWS, INTEGRATORS, BOUNDARIES, NEIGHBOR_BACKENDS,
                     DEFAULT_ATTRACTION, DEFAULT_COLORS)
from .state import ParticleState, init_scene, from_numpy, from_jax_state, resize
from .engine.step import (step, simulate, trajectory, warmup, pair_accel,
                          simulate_dense,
                          simulate_dense_adaptive, simulate_dense_carry,
                          simulate_cadenced, simulate_culled)
from .models import make_scene, list_presets
from . import app, render
from .app import SimulationApp

__all__ = [
    "SimConfig", "ConfigError", "reference_config", "from_jax_config",
    "ParticleState", "init_scene", "from_numpy", "from_jax_state", "resize",
    "step", "simulate", "trajectory", "warmup", "pair_accel", "simulate_dense",
    "simulate_dense_adaptive", "simulate_dense_carry", "simulate_cadenced",
    "simulate_culled", "make_scene", "list_presets", "app", "render",
    "SimulationApp", "FORCE_LAWS", "INTEGRATORS", "BOUNDARIES",
    "NEIGHBOR_BACKENDS", "DEFAULT_ATTRACTION", "DEFAULT_COLORS",
]
