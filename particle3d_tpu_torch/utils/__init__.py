"""Aux subsystems: metrics, checkpoints (npz and the step-indexed
``OrbaxCheckpointer``), profiling and the geometry tuner, plus the CUDA
kernel build loader (``cuda_build``)."""

from .metrics import kinetic_energy, total_momentum, SimMetrics, measure_metrics
from .checkpoint import save_checkpoint, load_checkpoint
from .profiling import StepTimer, benchmark_steps, trace
from .orbax_ckpt import OrbaxCheckpointer

__all__ = [
    "OrbaxCheckpointer",
    "kinetic_energy",
    "total_momentum",
    "SimMetrics",
    "measure_metrics",
    "save_checkpoint",
    "load_checkpoint",
    "StepTimer",
    "benchmark_steps",
    "trace",
]
