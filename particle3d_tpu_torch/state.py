"""Particle state (PyTorch port of ``particle3d_tpu.state``).

Structure-of-arrays tensors in a frozen dataclass. ``init_scene`` draws from
an explicit CPU ``torch.Generator`` and then moves the scene to the
requested device, so one seed gives the same scene on the CPU and on the
card. It cannot give ``jax.random``'s numbers: parity tests build states
with numpy (``from_numpy``) or convert JAX states (``from_jax_state``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimConfig, f32


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """positions f32[N, 3], velocities f32[N, 3], species i64[N],
    masses f32[N], accel f32[N, 3] (cached accelerations)."""

    positions: torch.Tensor
    velocities: torch.Tensor
    species: torch.Tensor
    masses: torch.Tensor
    accel: torch.Tensor

    @property
    def n(self) -> int:
        return self.positions.shape[0]

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)


def init_scene(generator: torch.Generator, n: int, cfg: SimConfig,
               device) -> ParticleState:
    """Positions uniform in [-world/2, world/2]^3, zero velocities, species
    uniform in [0, id_count), unit masses, zero cached accelerations.
    ``generator`` must be a CPU generator."""
    half = float(f32(cfg.world_size) * np.float32(0.5))
    pos = torch.rand((n, 3), generator=generator, dtype=torch.float32)
    pos = pos * (2.0 * half) - half
    species = torch.randint(0, cfg.id_count, (n,), generator=generator)
    z = torch.zeros((n, 3), dtype=torch.float32)
    st = ParticleState(pos, z, species, torch.ones(n, dtype=torch.float32), z)
    return to_device(st, device)


def to_device(st: ParticleState, device) -> ParticleState:
    return ParticleState(*(getattr(st, f.name).to(device)
                           for f in dataclasses.fields(st)))


def from_numpy(positions, velocities, species, masses=None, accel=None,
               device="cpu") -> ParticleState:
    """Build a state from host arrays."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    pos = t(positions, torch.float32)
    n = pos.shape[0]
    return ParticleState(
        pos,
        t(velocities, torch.float32),
        t(species, torch.int64),
        t(np.ones(n) if masses is None else masses, torch.float32),
        t(np.zeros((n, 3)) if accel is None else accel, torch.float32))


def from_jax_state(st, device="cpu") -> ParticleState:
    """Convert a JAX ``particle3d_tpu.state.ParticleState`` (read through
    numpy, so the port never imports jax)."""
    return from_numpy(np.asarray(st.positions), np.asarray(st.velocities),
                      np.asarray(st.species), np.asarray(st.masses),
                      np.asarray(st.accel), device=device)
