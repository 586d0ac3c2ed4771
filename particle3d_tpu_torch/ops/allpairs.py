"""Dense O(N^2) all-pairs forces in plain torch (port of
``particle3d_tpu.ops.allpairs``).

The ``allpairs`` backend, and the oracle every faster path is held
against. A pair counts iff 0 < d^2 < radius^2 (minimum image when
``cfg.wrap_forces``); blocked over receivers so peak memory is
O(block_i * N_src).
"""

from __future__ import annotations

import torch

from ..config import SimConfig, f32
from . import forces as F


def _tile_forces(pos_i, u_i, pos_j, v_j, cfg: SimConfig, scale, ok_j=None):
    """Forces on receivers [TI, 3] from sources [TJ, 3]."""
    delta = pos_j[None, :, :] - pos_i[:, None, :]  # i -> j
    if cfg.wrap_forces:
        delta = F.min_image(delta, cfg.world_size)
    d2 = torch.sum(delta * delta, dim=-1)
    r = f32(cfg.particle_effect_radius)
    valid = torch.logical_and(d2 > 0.0, d2 < float(r * r))
    if ok_j is not None:
        valid = torch.logical_and(valid, ok_j[None, :])
    coef = F.pair_coef(u_i, v_j)
    s = torch.where(valid, scale(torch.where(valid, d2, torch.ones_like(d2)), coef),
                    torch.zeros_like(d2))
    return torch.einsum("ijc,ij->ic", delta, s)


def allpairs_forces(positions, u, v, cfg: SimConfig, block_i: int = 1024,
                    src_positions=None, src_v=None, src_valid=None):
    """Accumulated pair forces [N, 3] (``src_*`` select a rectangular
    sweep against another source set; ``src_valid`` masks phantom rows)."""
    if src_positions is None:
        src_positions, src_v = positions, v
    scale = F.scale_fn(cfg)
    out = [_tile_forces(positions[i:i + block_i], u[i:i + block_i],
                        src_positions, src_v, cfg, scale, ok_j=src_valid)
           for i in range(0, positions.shape[0], block_i)]
    return torch.cat(out, dim=0)


def allpairs_accel(state, cfg: SimConfig, block_i: int = 1024):
    """Force sum scaled into an acceleration (src/lib.rs:246-247)."""
    u, v = F.pair_features(state, cfg)
    f = allpairs_forces(state.positions, u, v, cfg, block_i=block_i)
    return f * float(F.kick_scale(cfg))
