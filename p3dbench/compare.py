"""The comparisons that decide ``correct``: gaps between what the program
produced and what the plain reference computes from the same inputs."""

from __future__ import annotations

import torch


def position_gaps(got, want, world: float) -> torch.Tensor:
    """Per-particle distance [N] between two position sets under the
    minimum image of a periodic box, in float64."""
    d = got.double() - want.double()
    d = d - world * torch.round(d / world)
    return d.norm(dim=1)


def velocity_gap(got, want) -> float:
    """Largest per-particle velocity difference over the reference's
    largest speed."""
    d = (got.double() - want.double()).norm(dim=1).max()
    return float(d / want.double().norm(dim=1).max().clamp(min=1e-30))


def pixel_mismatch(got, want) -> float:
    """Share of pixels whose colour differs, of two uint8 [H, W, 3]
    images."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want)
    return float((got != want).any(-1).double().mean())
