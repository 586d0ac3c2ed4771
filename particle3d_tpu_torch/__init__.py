"""particle3d_tpu_torch: PyTorch + CUDA port of particle3d_tpu for NVIDIA
Hopper (H100).

The JAX package ``particle3d_tpu`` stays the reference; this package
imports torch and numpy only. Its first slice is the exact particle-life
main path: the incrementally maintained dense cell layout, the overflow
sidecar and the hand-written column-sweep kernel (K1,
``csrc/celllist_sweep.cu``), driven by ``engine.step.simulate_dense`` and
``python -m particle3d_tpu_torch run``.
"""

from .config import SimConfig, reference_config, from_jax_config
from .state import ParticleState, init_scene, from_numpy, from_jax_state
from .engine.step import (step, simulate, trajectory, warmup, simulate_dense,
                          simulate_dense_adaptive)
from .models import make_scene, list_presets

__all__ = [
    "SimConfig", "reference_config", "from_jax_config",
    "ParticleState", "init_scene", "from_numpy", "from_jax_state",
    "step", "simulate", "trajectory", "warmup", "simulate_dense",
    "simulate_dense_adaptive", "make_scene", "list_presets",
]
