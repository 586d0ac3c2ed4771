"""Pairwise force laws (PyTorch port of ``particle3d_tpu.ops.forces``).

Every law has the canonical form ``force_on_i += unit(i -> j) *
magnitude(d_ij, coef_ij)`` with a rank-1 pair coefficient ``coef_ij =
U[i] . V[j]`` (see the JAX module for the derivation of U and V per law).

Config scalars enter as float32 values (``config.f32``). A Python scalar
combined with a float32 tensor is cast to float32 first, so ``t * c`` and
``t - c`` round as in the JAX package. ``c / t`` is not: torch computes it
as ``c * (1 / t)``. Such divisions go through ``sdiv``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, f32
from ..utils.profiling import host_sync


def scalar_like(c, like: torch.Tensor) -> torch.Tensor:
    """0-dim tensor on ``like``'s device, filled on the device (no host
    copy, no synchronisation)."""
    return torch.full((), float(c), dtype=like.dtype, device=like.device)


def sdiv(c, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` as a true float32 division."""
    return scalar_like(c, t) / t


def tdiv(t: torch.Tensor, c) -> torch.Tensor:
    """``t / c`` as a true float32 division. CUDA divides by a host scalar
    as a multiply by its reciprocal; a device scalar avoids that."""
    return t / scalar_like(c, t)


def pair_coef(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """coef[..., i, j] = u[..., i, :] . v[..., j, :] in full float32: the
    features hold species one-hots and split masses, which TF32's 10-bit
    mantissa would round."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(u, v.transpose(-1, -2))


def pair_features(state, cfg: SimConfig):
    """Return (U, V) with coef_ij = dot(U[i], V[j]): ``id_count`` columns
    for particle life, 2 for gravity, 1 for the other laws."""
    n = state.positions.shape[0]
    dev = state.positions.device
    f32t = torch.float32
    if cfg.force_law == "particle_life":
        a = cfg.attraction_matrix
        if isinstance(a, torch.Tensor):  # kept in the graph
            a = a.to(dev, torch.float32)
        else:
            # a blocking copy from the host: it waits for the card's queue
            with host_sync("sync.features"):
                a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
        u = a[state.species]  # U[i] = A[species_i, :] (= onehot @ A)
        v = torch.nn.functional.one_hot(state.species, cfg.id_count).to(f32t)
    elif cfg.force_law == "gravity":
        # bf16-exact high part + residual (see the JAX module)
        m = state.masses.to(f32t)
        m_hi = m.to(torch.bfloat16).to(f32t)
        u = torch.ones((n, 2), dtype=f32t, device=dev)
        v = torch.stack([m_hi, m - m_hi], dim=1)
    else:
        u = torch.ones((n, 1), dtype=f32t, device=dev)
        v = torch.ones((n, 1), dtype=f32t, device=dev)
    return u, v


def pad_features(*feats):
    """Zero-pad feature matrices [., P] to the next multiple of 8 columns,
    the widths the force kernels take (K1: 8; K2-K4: 8 or 16). Zero
    columns leave every U . V unchanged."""
    width = -(-max(f.shape[1] for f in feats) // 8) * 8
    return tuple(torch.nn.functional.pad(f.to(torch.float32),
                                         (0, width - f.shape[1])).contiguous()
                 for f in feats)


# -- force magnitudes f(d, coef), positive = attraction --------------------

def particle_life_magnitude(d, coef, min_pull_ratio):
    m = f32(min_pull_ratio)
    repel = tdiv(d, m) - 1.0
    tri = coef * (1.0 - tdiv(torch.abs(2.0 * d - 1.0 - float(m)),
                             np.float32(1.0) - m))
    mid = torch.logical_and(d > float(m), d < 1.0)
    return torch.where(d < float(m), repel,
                       torch.where(mid, tri, torch.zeros_like(tri)))


def lennard_jones_magnitude(d, coef, epsilon, sigma):
    inv = sdiv(f32(sigma), d)
    i6 = inv * inv * inv
    i6 = i6 * i6
    return coef * sdiv(np.float32(24.0) * f32(epsilon), d) * (i6 - 2.0 * i6 * i6)


def gravity_magnitude(d, coef, g_const, softening):
    s = f32(softening)
    d2 = d * d + float(s * s)
    return coef * float(f32(g_const)) * d / (d2 * torch.sqrt(d2))


def spring_magnitude(d, coef, stiffness, rest_length):
    return coef * float(f32(stiffness)) * (d - float(f32(rest_length)))


# -- scale functions s(d2, coef) = f(d) / d --------------------------------

def particle_life_scale(d2, coef, min_pull_ratio):
    d = torch.sqrt(d2)
    return particle_life_magnitude(d, coef, min_pull_ratio) / d


def lennard_jones_scale(d2, coef, epsilon, sigma):
    s = f32(sigma)
    a = sdiv(s * s, d2)
    a3 = a * a * a
    return coef * sdiv(np.float32(24.0) * f32(epsilon), d2) * (a3 - 2.0 * a3 * a3)


def gravity_scale(d2, coef, g_const, softening):
    s = f32(softening)
    dd2 = d2 + float(s * s)
    return coef * float(f32(g_const)) / (dd2 * torch.sqrt(dd2))


def spring_scale(d2, coef, stiffness, rest_length):
    d = torch.sqrt(d2)
    return coef * float(f32(stiffness)) * (d - float(f32(rest_length))) / d


def scale_fn(cfg: SimConfig):
    """Return g(d2, coef) -> f/d for the configured law."""
    law = cfg.force_law
    if law == "particle_life":
        return lambda d2, c: particle_life_scale(d2, c, cfg.min_pull_ratio)
    if law == "lennard_jones":
        return lambda d2, c: lennard_jones_scale(d2, c, cfg.lj_epsilon, cfg.lj_sigma)
    if law == "gravity":
        return lambda d2, c: gravity_scale(d2, c, cfg.gravity_constant, cfg.gravity_softening)
    if law == "spring":
        return lambda d2, c: spring_scale(d2, c, cfg.spring_stiffness, cfg.spring_rest_length)
    raise ValueError(f"unknown force law {law!r}")


def magnitude_fn(cfg: SimConfig):
    """Return f(d, coef) -> magnitude for the configured law."""
    law = cfg.force_law
    if law == "particle_life":
        return lambda d, c: particle_life_magnitude(d, c, cfg.min_pull_ratio)
    if law == "lennard_jones":
        return lambda d, c: lennard_jones_magnitude(d, c, cfg.lj_epsilon, cfg.lj_sigma)
    if law == "gravity":
        return lambda d, c: gravity_magnitude(d, c, cfg.gravity_constant, cfg.gravity_softening)
    if law == "spring":
        return lambda d, c: spring_magnitude(d, c, cfg.spring_stiffness, cfg.spring_rest_length)
    raise ValueError(f"unknown force law {law!r}")


def kick_scale(cfg: SimConfig) -> np.float32:
    """Scale turning the accumulated force sum into an acceleration."""
    if cfg.force_law == "particle_life":
        return f32(cfg.interaction_force) * f32(cfg.particle_effect_radius)
    return f32(cfg.interaction_force)


def min_image(delta, world_size):
    """Minimum-image displacement wrap."""
    w = f32(world_size)
    return delta - float(w) * torch.round(tdiv(delta, w))
