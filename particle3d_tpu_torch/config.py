"""Simulation configuration (PyTorch port of ``particle3d_tpu.config``).

``SimConfig`` carries the same fields, defaults and validation as the JAX
package's config. Numeric fields are Python or numpy scalars and small
numpy float32 arrays; ``attraction_matrix`` may also be a ``torch.Tensor``,
one that requires grad included, to differentiate through the step
(``validate`` reads only its shape, ``ops.forces.pair_features`` keeps it
in the graph). Arithmetic on them that must agree
with the JAX package (which traces every numeric field as a float32 scalar)
goes through ``f32``, so host-side products such as ``coefficient * dt``
round exactly as the device would.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

FORCE_LAWS = ("particle_life", "lennard_jones", "gravity", "spring")
INTEGRATORS = ("euler", "velocity_verlet", "leapfrog")
BOUNDARIES = ("wrap", "clamp", "reflect")
NEIGHBOR_BACKENDS = ("allpairs", "allpairs_pallas", "allpairs_mxu",
                     "celllist", "celllist_pallas")
PRECISIONS = ("exact", "fast")

DEFAULT_COLORS = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [1.0, 1.0, 0.0],
        [1.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)

# The reference app's default attraction matrix; the 1.5 entry exceeds its
# UI's [-1, 1] clamp and is kept verbatim.
DEFAULT_ATTRACTION = np.array(
    [
        [0.5, 1.0, -0.5, 0.0, -1.0],
        [1.0, 1.0, 1.0, 0.0, -1.0],
        [0.0, 0.0, 0.5, 1.5, -1.0],
        [0.0, 0.0, 0.0, 0.0, -1.0],
        [1.0, 1.0, 1.0, 1.0, 0.5],
    ],
    dtype=np.float32,
)

_ARRAY_FIELDS = ("attraction_matrix", "colors", "acceleration")


class ConfigError(ValueError):
    """Raised for invalid simulation configs."""


def f32(x) -> np.float32:
    """A config scalar as float32: the precision the JAX package computes
    every traced config field in."""
    return np.float32(np.asarray(x, np.float32))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full simulation configuration; field for field the JAX package's."""

    world_size: Any = 10.0
    attraction_matrix: Any = None  # f32[K, K], row = self species
    colors: Any = None  # f32[K, 3]
    coefficient: Any = 0.97  # drag
    interaction_force: Any = 1.0
    min_pull_ratio: Any = 0.3
    particle_effect_radius: Any = 2.0
    acceleration: Any = None  # f32[3] global gravity vector

    lj_epsilon: Any = 1.0
    lj_sigma: Any = 0.1
    gravity_constant: Any = 1.0
    gravity_softening: Any = 0.05
    spring_stiffness: Any = 1.0
    spring_rest_length: Any = 0.5
    restitution: Any = 1.0

    id_count: int = 5
    cell_grid: int | None = None
    cell_capacity: int | None = None
    # overflow-sidecar budget: None = ops.celllist_dense.OCAP, 0 disables
    overflow_capacity: int | None = None
    ghost_capacity: int | None = None
    precision: str = "exact"
    force_law: str = "particle_life"
    integrator: str = "euler"
    boundary: str = "wrap"
    neighbor: str = "allpairs"
    # periodic force images even with solid walls (reference quirk Q3)
    wrap_forces: bool = True

    def __post_init__(self):
        k = self.id_count
        if self.attraction_matrix is None:
            m = DEFAULT_ATTRACTION.copy() if k == 5 else np.zeros((k, k), np.float32)
            object.__setattr__(self, "attraction_matrix", m)
        if self.colors is None:
            reps = -(-k // 5)
            object.__setattr__(
                self, "colors", np.tile(DEFAULT_COLORS, (reps, 1))[:k].copy())
        if self.acceleration is None:
            object.__setattr__(self, "acceleration", np.zeros(3, np.float32))

    @property
    def walls(self) -> bool:
        return self.boundary != "wrap"

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "SimConfig":
        if self.force_law not in FORCE_LAWS:
            raise ConfigError(f"unknown force_law {self.force_law!r}; one of {FORCE_LAWS}")
        if self.integrator not in INTEGRATORS:
            raise ConfigError(f"unknown integrator {self.integrator!r}; one of {INTEGRATORS}")
        if self.boundary not in BOUNDARIES:
            raise ConfigError(f"unknown boundary {self.boundary!r}; one of {BOUNDARIES}")
        if self.neighbor not in NEIGHBOR_BACKENDS:
            raise ConfigError(f"unknown neighbor backend {self.neighbor!r}; one of {NEIGHBOR_BACKENDS}")
        if self.precision not in PRECISIONS:
            raise ConfigError(f"unknown precision {self.precision!r}; one of {PRECISIONS}")
        if self.id_count < 1:
            raise ConfigError("id_count must be >= 1")
        if self.overflow_capacity is not None and self.overflow_capacity < 0:
            raise ConfigError("overflow_capacity must be >= 0 (0 disables "
                              "the overflow sidecar)")
        ws = float(np.asarray(self.world_size))
        r = float(np.asarray(self.particle_effect_radius))
        if ws < 2.0 * r:
            raise ConfigError(
                f"world_size ({ws}) must be >= 2 * particle_effect_radius "
                f"({r}) — required for the minimum-image neighbor sweep")
        # np.shape reads a tensor's shape without converting it
        am_shape = tuple(np.shape(self.attraction_matrix))
        if am_shape != (self.id_count, self.id_count):
            raise ConfigError(
                f"attraction_matrix shape {am_shape} != (id_count, id_count) "
                f"= ({self.id_count}, {self.id_count})")
        if np.asarray(self.colors).shape != (self.id_count, 3):
            raise ConfigError(f"colors shape {np.asarray(self.colors).shape} "
                              f"!= ({self.id_count}, 3)")
        if np.asarray(self.acceleration).shape != (3,):
            raise ConfigError("acceleration must have shape (3,)")
        return self


def reference_config(**overrides) -> SimConfig:
    """The reference app's default scene config: world 10, 5 species,
    radius 2, drag 0.97, force 1.0, min_pull 0.3, periodic box."""
    return SimConfig(**overrides).validate()


def from_jax_config(cfg) -> SimConfig:
    """Read a JAX ``particle3d_tpu.config.SimConfig`` without importing jax:
    the object is read duck-typed through ``dataclasses.fields``. Arrays and
    numeric law parameters cross as numpy float32; structural fields as
    they are."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in _ARRAY_FIELDS:
            v = np.array(np.asarray(v), np.float32)
        elif f.name in _NUMERIC_FIELDS:
            v = f32(v)
        kw[f.name] = v
    return SimConfig(**kw)


_NUMERIC_FIELDS = tuple(
    f.name for f in dataclasses.fields(SimConfig)
    if f.type == "Any" and f.name not in _ARRAY_FIELDS)
