"""Per-state physics diagnostics (port of ``particle3d_tpu.utils.metrics``):
kinetic energy, momentum, speed statistics and centre of mass, computed on
the state's device and read back once by ``as_dict``. ``kinetic_energy``
and ``total_momentum`` are device scalars; differentiable like the step."""

from __future__ import annotations

import dataclasses

import torch

from ..state import ParticleState


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(state.masses
                           * torch.sum(state.velocities ** 2, dim=-1))


def total_momentum(state: ParticleState) -> torch.Tensor:
    return torch.sum(state.masses[:, None] * state.velocities, dim=0)


@dataclasses.dataclass(frozen=True)
class SimMetrics:
    kinetic_energy: torch.Tensor
    momentum: torch.Tensor  # [3]
    max_speed: torch.Tensor
    mean_speed: torch.Tensor
    com: torch.Tensor  # [3]

    def as_dict(self):
        return {
            "kinetic_energy": float(self.kinetic_energy),
            "momentum": [float(x) for x in self.momentum.cpu()],
            "max_speed": float(self.max_speed),
            "mean_speed": float(self.mean_speed),
            "com": [float(x) for x in self.com.cpu()],
        }


def measure_metrics(state: ParticleState) -> SimMetrics:
    m = state.masses
    speed = torch.linalg.vector_norm(state.velocities, dim=-1)
    return SimMetrics(
        kinetic_energy=kinetic_energy(state),
        momentum=total_momentum(state),
        max_speed=torch.max(speed),
        mean_speed=torch.mean(speed),
        com=torch.sum(m[:, None] * state.positions, dim=0) / torch.sum(m),
    )
