"""Static-shape cell list in plain torch: the ``celllist`` backend (port of
``particle3d_tpu.ops.celllist``).

Particles are binned by exact cell id (floor on the shifted box), sorted by
it, and given a fixed-capacity slot block per cell. Every supercell of
``group``^3 cells sweeps its receivers against the (group + 2)^3 cells of
its neighbourhood with the minimum-image wrap in the pair math, in chunks
of ``cell_batch`` cells (a Python loop in place of the JAX package's
``lax.map``). Particles past a cell's capacity are dropped from both sides:
size the capacity generously (``default_capacity``: 3x the mean
occupancy), or check ``celllist_stats``. The JAX module is XLA gathers with
no Pallas kernel, so this port is plain torch too.

Needs >= 3 cells per axis (the neighbourhood would double count through
the wrap); smaller grids fall back to the plain all-pairs sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, f32
from . import forces as F


def grid_dims(world_size: float, radius: float) -> int:
    """Cells per axis: floor(world / radius) keeps cells >= radius wide."""
    return max(int(world_size // radius), 1)


def default_capacity(n: int, nc: int, slack: float = 3.0) -> int:
    mean = n / max(nc ** 3, 1)
    cap = int(-(-slack * mean // 8) * 8)
    return max(cap, 8)


def _cell_ids(positions, cfg: SimConfig, nc: int):
    """Raveled cell id per particle, int64 [N]."""
    w = f32(cfg.world_size)
    cellw = w / np.float32(nc)
    shifted = positions + float(w * np.float32(0.5))
    idx = torch.clamp(torch.floor(F.tdiv(shifted, cellw)).to(torch.int64),
                      0, nc - 1)
    return (idx[:, 0] * nc + idx[:, 1]) * nc + idx[:, 2]


def _supercell_tables(nc: int, g: int, wrap: bool, device="cpu"):
    """Supercell tables: ``group``^3 cells form one supercell, whose
    receivers sweep the (g + 2)^3 cells around it (g = 1 is the classic
    27-cell neighbourhood). Returns (own [S, g^3], nbr [S, (g+2)^3],
    nbr_valid) of raveled cell ids, int64 / bool on ``device``."""
    if nc % g:
        raise ValueError(f"group {g} does not divide the grid {nc}")
    ns = nc // g
    axes = np.meshgrid(np.arange(ns), np.arange(ns), np.arange(ns),
                       indexing="ij")
    base = np.stack(axes, -1).reshape(-1, 3) * g
    intra = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    own = base[:, None, :] + intra[None, :, :]
    halo = np.stack(np.meshgrid(*[np.arange(-1, g + 1)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    nbr = base[:, None, :] + halo[None, :, :]
    if wrap:
        nbr_m = nbr % nc
        valid = np.ones(nbr.shape[:2], bool)
    else:
        valid = np.all((nbr >= 0) & (nbr < nc), axis=-1)
        nbr_m = np.clip(nbr, 0, nc - 1)

    def ravel(a):
        return torch.as_tensor((a[..., 0] * nc + a[..., 1]) * nc + a[..., 2],
                               dtype=torch.int64, device=device)

    return ravel(own), ravel(nbr_m), torch.as_tensor(valid, device=device)


def _neighbor_table(nc: int, wrap: bool, device="cpu"):
    """[C, 27] neighbour cell ids and their validity (the g = 1 tables)."""
    _, nbr, valid = _supercell_tables(nc, 1, wrap, device)
    return nbr, valid


def build_cell_list(positions, cfg: SimConfig, nc: int, capacity: int):
    """Bin the particles: (slot_idx [C, CAP] particle indices with -1 on
    empty slots, order [N] the sort permutation)."""
    n = positions.shape[0]
    c = nc ** 3
    dev = positions.device
    cid = _cell_ids(positions, cfg, nc)
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    # rank within the cell: position among equal ids
    starts = torch.searchsorted(cid_sorted, torch.arange(c, device=dev))
    rank = torch.arange(n, device=dev) - starts[cid_sorted]
    flat = torch.where(rank < capacity, cid_sorted * capacity + rank,
                       c * capacity)
    slot_idx = torch.full((c * capacity + 1,), -1, dtype=torch.int64,
                          device=dev)
    slot_idx[flat] = order  # overflow lands on the dropped last row
    return slot_idx[:-1].reshape(c, capacity), order


def celllist_stats(positions, cfg: SimConfig, nc: int | None = None,
                   capacity: int | None = None):
    """Host-side diagnostics: (max occupancy, overflow bool, cells/axis)."""
    n = positions.shape[0]
    if nc is None:
        nc = grid_dims(float(cfg.world_size), float(cfg.particle_effect_radius))
    if capacity is None:
        capacity = default_capacity(n, nc)
    counts = torch.bincount(_cell_ids(positions, cfg, nc), minlength=nc ** 3)
    mx = int(counts.max())
    return mx, mx > capacity, nc


def celllist_forces(positions, u, v, cfg: SimConfig,
                    nc: int | None = None, capacity: int | None = None,
                    cell_batch: int = 512, group: int | None = None):
    """Accumulated pair forces [N, 3] through the cell list: the same
    pairs as all-pairs for world >= 2 * radius (every pair in range is
    within one cell of its receiver), minus the capacity overflow."""
    n = positions.shape[0]
    dev = positions.device
    if nc is None:
        nc = cfg.cell_grid
    if capacity is None:
        capacity = cfg.cell_capacity
    if nc is None:
        nc = grid_dims(float(cfg.world_size), float(cfg.particle_effect_radius))
    if nc < 3:
        from .allpairs import allpairs_forces

        return allpairs_forces(positions, u, v, cfg)
    if capacity is None:
        capacity = default_capacity(n, nc)
    scale = F.scale_fn(cfg)
    r = f32(cfg.particle_effect_radius)
    r2 = float(r * r)
    w = f32(cfg.world_size)
    wrap = bool(cfg.wrap_forces)

    if group is None:
        group = 2 if nc % 2 == 0 and nc >= 4 else 1
    while nc % group:
        group -= 1
    g3 = group ** 3
    nrec = g3 * capacity
    nsrc = (group + 2) ** 3 * capacity

    slot_idx, _ = build_cell_list(positions, cfg, nc, capacity)  # [C, CAP]
    present = slot_idx >= 0
    safe_idx = torch.where(present, slot_idx, 0)
    cell_pos = positions[safe_idx]  # [C, CAP, 3]
    cell_u = u[safe_idx]
    cell_v = v[safe_idx]
    own_ids, nb_ids, nb_valid = _supercell_tables(nc, group, wrap, dev)

    def one_batch(own, nb, nbv):
        b = own.shape[0]
        rec_pos = cell_pos[own].reshape(b, nrec, 3)
        rec_u = cell_u[own].reshape(b, nrec, -1)
        rec_present = present[own].reshape(b, nrec)
        src_pos = cell_pos[nb].reshape(b, nsrc, 3)
        src_v = cell_v[nb].reshape(b, nsrc, -1)
        src_present = (present[nb] & nbv[..., None]).reshape(b, nsrc)

        def axis_delta(c):
            d = src_pos[:, None, :, c] - rec_pos[:, :, None, c]  # [B, R, S]
            return F.min_image(d, w) if wrap else d

        dx, dy, dz = axis_delta(0), axis_delta(1), axis_delta(2)
        d2 = dx * dx + dy * dy + dz * dz
        valid = ((d2 > 0.0) & (d2 < r2) & src_present[:, None, :]
                 & rec_present[:, :, None])
        coef = F.pair_coef(rec_u, src_v)
        s = torch.where(valid, scale(torch.where(valid, d2, 1.0), coef), 0.0)
        return torch.stack([(dx * s).sum(-1), (dy * s).sum(-1),
                            (dz * s).sum(-1)], dim=-1)  # [B, R, 3]

    batch = max(1, cell_batch // g3)  # supercells per chunk
    forces_cells = torch.cat([
        one_batch(own_ids[s0:s0 + batch], nb_ids[s0:s0 + batch],
                  nb_valid[s0:s0 + batch])
        for s0 in range(0, own_ids.shape[0], batch)])

    # the per-slot forces back in particle order (each particle owns at
    # most one slot; empty slots go to a dropped row)
    out = torch.zeros((n + 1, 3), dtype=positions.dtype, device=dev)
    flat_idx = torch.where(present[own_ids].reshape(-1),
                           slot_idx[own_ids].reshape(-1), n)
    out[flat_idx] = forces_cells.reshape(-1, 3).to(positions.dtype)
    return out[:n]
