"""Boundary handling (PyTorch port of ``particle3d_tpu.engine.boundaries``).

``wrap`` (periodic, single wrap per axis), ``clamp`` (the reference's walls:
clamp to the face, kill the escaping velocity component) and ``reflect``
(elastic walls with restitution). Branch-free elementwise selects.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, f32


def apply_boundary(positions, velocities, cfg: SimConfig):
    w = f32(cfg.world_size)
    hw = float(w * np.float32(0.5))
    over = positions > hw
    under = positions < -hw
    if cfg.boundary == "wrap":
        positions = torch.where(over, positions - float(w),
                                torch.where(under, positions + float(w), positions))
        return positions, velocities
    if cfg.boundary == "clamp":
        new_pos = torch.where(over, torch.full_like(positions, hw),
                              torch.where(under, torch.full_like(positions, -hw),
                                          positions))
        new_vel = torch.where(
            over, torch.clamp(velocities, max=0.0),
            torch.where(under, torch.clamp(velocities, min=0.0), velocities))
        return new_pos, new_vel
    if cfg.boundary == "reflect":
        e = float(f32(cfg.restitution))
        two_hw = float(np.float32(2.0) * np.float32(hw))
        new_pos = torch.where(over, two_hw - positions,
                              torch.where(under, -two_hw - positions, positions))
        hit = torch.logical_or(over, under)
        new_vel = torch.where(hit, -e * velocities, velocities)
        # a very fast particle could still be outside after one mirror
        new_pos = torch.clamp(new_pos, -hw, hw)
        return new_pos, new_vel
    raise ValueError(f"unknown boundary {cfg.boundary!r}")
