"""Pair-kernel parameters shared by the force kernels (PyTorch port of the
shared parts of ``particle3d_tpu.ops.pallas_allpairs``).

``pack_params`` builds the 14-float scalar vector every pair kernel reads
(the Pallas kernels' SMEM operand; a by-value kernel argument in
``csrc/pair_law.cuh``), computed in float32 as the JAX package does.
``gated_scale`` is the plain-torch form of the kernels' gated per-law
scale ``s = f(d)/d`` and matches ``csrc/pair_law.cuh`` operation for
operation, with an exact sqrt and divide.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, f32
from .forces import sdiv

# feature width of the rank-1 pair coefficient U.V
PAIR_P = 8

# packed scalar layout (same indices as the JAX package and pair_law.cuh)
PF_W, PF_INV_W, PF_M, PF_INV_M, PF_INV_1M, PF_C1M = 0, 1, 2, 3, 4, 5
PF_LJ24E, PF_LJ_S2, PF_G, PF_G_S2, PF_K, PF_L = 6, 7, 8, 9, 10, 11
PF_T2, PF_TC = 12, 13
PF_LEN = 14

LAW_IDS = {"particle_life": 0, "lennard_jones": 1, "gravity": 2, "spring": 3}


def pack_params(cfg: SimConfig) -> np.ndarray:
    """f32[14] scalar parameter vector, as a host array."""
    one = np.float32(1.0)
    w = f32(cfg.world_size)
    m = f32(cfg.min_pull_ratio)
    eps = f32(cfg.lj_epsilon)
    sig = f32(cfg.lj_sigma)
    soft = f32(cfg.gravity_softening)
    return np.array([
        w,
        one / w,
        m,
        one / m,
        one / (one - m),
        one + m,
        np.float32(24.0) * eps,
        sig * sig,
        f32(cfg.gravity_constant),
        soft * soft,
        f32(cfg.spring_stiffness),
        f32(cfg.spring_rest_length),
        np.float32(2.0) / (one - m),
        (one + m) / (one - m),
    ], dtype=np.float32)


def r2_gate(cfg: SimConfig) -> np.float32:
    """Squared cutoff; for particle-life min(r^2, 1), since that law is
    identically zero at raw distance >= 1 (reference quirk Q2)."""
    r = f32(cfg.particle_effect_radius)
    r2 = r * r
    if cfg.force_law == "particle_life":
        r2 = min(r2, np.float32(1.0))
    return np.float32(r2)


def gated_scale(law: str, d2, in_r, coef, pf):
    """The kernels' gated scale: ``s`` such that a pair adds ``delta * s``.

    particle-life parks out-of-gate pairs at d2 = 1, where its triangular
    branch is exactly 0, and clamps in-gate pairs at 1e-12 (self pairs have
    delta == 0, so their huge repulsion adds nothing). The other laws gate
    ``d2 > 0`` and zero the scale outside the gate.
    """
    p = [float(x) for x in pf]
    one = torch.ones_like(d2)
    if law == "particle_life":
        safe = torch.where(in_r, torch.clamp(d2, min=1e-12), one)
        d = torch.sqrt(safe)
        inv_d = sdiv(1.0, d)
        rep = p[PF_INV_M] - inv_d
        tri = coef * (torch.clamp(
            1.0 - torch.abs(d * p[PF_T2] - p[PF_TC]), min=0.0) * inv_d)
        return torch.where(d < p[PF_M], rep, tri)
    valid = torch.logical_and(d2 > 0.0, in_r)
    safe = torch.where(valid, d2, one)
    if law == "lennard_jones":
        inv_d2 = sdiv(1.0, safe)
        a = p[PF_LJ_S2] * inv_d2
        a3 = a * a * a
        s = coef * (p[PF_LJ24E] * inv_d2) * (a3 - 2.0 * a3 * a3)
    elif law == "gravity":
        inv = sdiv(1.0, torch.sqrt(safe + p[PF_G_S2]))
        s = coef * p[PF_G] * (inv * inv * inv)
    elif law == "spring":
        inv_d = sdiv(1.0, torch.sqrt(safe))
        s = coef * p[PF_K] * (1.0 - p[PF_L] * inv_d)
    else:
        raise ValueError(law)
    return torch.where(valid, s, torch.zeros_like(s))
