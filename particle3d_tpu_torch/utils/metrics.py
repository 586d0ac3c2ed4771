"""Per-state physics diagnostics (port of ``particle3d_tpu.utils.metrics``):
kinetic energy, momentum, speed statistics and centre of mass, computed on
the state's device and read back once by ``as_dict``."""

from __future__ import annotations

import dataclasses

import torch

from ..state import ParticleState


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
    v = state.velocities
    m = state.masses
    speed = torch.linalg.vector_norm(v, dim=-1)
    return SimMetrics(
        kinetic_energy=0.5 * torch.sum(m * torch.sum(v ** 2, dim=-1)),
        momentum=torch.sum(m[:, None] * v, dim=0),
        max_speed=torch.max(speed),
        mean_speed=torch.mean(speed),
        com=torch.sum(m[:, None] * state.positions, dim=0) / torch.sum(m),
    )
