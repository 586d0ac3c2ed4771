"""Particle state (PyTorch port of ``particle3d_tpu.state``).

Structure-of-arrays tensors in a frozen dataclass. ``init_scene`` draws from
an explicit CPU ``torch.Generator`` and then moves the scene to the
requested device, so one seed gives the same scene on the CPU and on the
card. It cannot give ``jax.random``'s numbers: parity tests build states
with numpy (``from_numpy``) or convert JAX states (``from_jax_state``).

Entry points default to the card (``device="cuda"``) and raise without
one; the plain torch path runs only when the caller asks for the CPU.
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


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when no card is
    present, so a default never falls back to the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is "
                           f"available (use device='cpu' to run the plain "
                           f"torch path)")
    return device


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
               device="cuda") -> ParticleState:
    """Build a state from host arrays, on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)

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


def resize(state: ParticleState, generator: torch.Generator, new_n: int,
           cfg: SimConfig) -> ParticleState:
    """Shrink by truncation, or grow by new particles drawn as
    ``init_scene`` draws them from the CPU ``generator`` (the reference
    app's live particle-count control)."""
    if new_n <= state.n:
        return ParticleState(*(getattr(state, f.name)[:new_n]
                               for f in dataclasses.fields(state)))
    extra = init_scene(generator, new_n - state.n, cfg, state.positions.device)
    return ParticleState(*(torch.cat([getattr(state, f.name),
                                      getattr(extra, f.name)])
                           for f in dataclasses.fields(state)))


def from_jax_state(st, device="cuda") -> ParticleState:
    """Convert a JAX ``particle3d_tpu.state.ParticleState`` (read through
    numpy, so the port never imports jax)."""
    return from_numpy(np.asarray(st.positions), np.asarray(st.velocities),
                      np.asarray(st.species), np.asarray(st.masses),
                      np.asarray(st.accel), device=device)
