"""Exact overflow sidecar (port of ``particle3d_tpu.ops.overflow``,
neighbourhood form).

Rows that do not fit their cell ("misplaced": capacity overflow living in a
wrong slot with r2 = -1, invisible to the grid kernel) get exact forces
from bounded sweeps over their 27 neighbour cells, so the cell capacity
can follow the mean occupancy rather than the Poisson tail. Every ordered
pair is computed exactly once across {grid kernel, these sweeps}:

  * mis <- aligned: each misplaced row's 27 neighbour cells (of its fresh
    position), sources gated to aligned rows;
  * mis <- mis: a dense [M, M] block;
  * aligned <- mis: reverse forces added onto the gathered slots (the
    laws are directional, so this is f(j <- i), not -f(i <- j)).

Needs nsc >= 3 (periodic neighbour cells must be distinct). The
``sidecar_sweeps`` / ``rect_forces`` path for smaller grids is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, f32
from . import forces as F
from .compaction import index_add_rows
from .params import r2_gate


def neighborhood_sweeps(positions, u_all, v_all, src_ok, mpos, mu, mv, mvalid,
                        cfg: SimConfig, nsc: int, cap: int):
    """Returns ``(f_mis [M, 3], f_from [S, 3])``: forces on the M misplaced
    rows, and reverse forces from them onto aligned slots (receiver-gated
    through ``src_ok``)."""
    if nsc < 3:
        raise ValueError("neighbourhood sweeps need nsc >= 3")
    s = positions.shape[0]
    m = mpos.shape[0]
    dev = positions.device
    scale = F.scale_fn(cfg)
    r2 = float(r2_gate(cfg))
    wrap = bool(cfg.wrap_forces)
    w = f32(cfg.world_size)
    mpos, mu, mv = mpos.float(), mu.float(), mv.float()

    # fresh-position cell coordinates of each misplaced row (as bin_sid)
    cellw = w / np.float32(nsc)
    c3 = torch.clamp(torch.floor(F.tdiv(mpos + float(w * np.float32(0.5)),
                                        cellw)).to(torch.int64), 0, nsc - 1)
    o = torch.arange(-1, 2, device=dev)
    offs = torch.stack(torch.meshgrid(o, o, o, indexing="ij"), -1).reshape(27, 3)
    nb = c3[:, None, :] + offs[None]
    if wrap:
        nb = torch.remainder(nb, nsc)
        cell_ok = torch.ones((m, 27), dtype=torch.bool, device=dev)
    else:
        cell_ok = torch.all((nb >= 0) & (nb < nsc), dim=-1)
        nb = torch.clamp(nb, 0, nsc - 1)
    cell = (nb[..., 0] * nsc + nb[..., 1]) * nsc + nb[..., 2]  # [m, 27]
    k = 27 * cap
    k_cells = nsc ** 3
    ok_cell = cell_ok[:, :, None].expand(m, 27, cap).reshape(m, k)

    def cells(a):  # whole cell windows of ``cap`` contiguous slots
        return a.reshape(k_cells, cap, -1)[cell].reshape(m, k, -1)

    pj = cells(positions).float()
    uj = cells(u_all).float()
    vj = cells(v_all).float()
    okj = cells(src_ok)[..., 0] & ok_cell

    delta = pj - mpos[:, None, :]  # i -> j
    if wrap:
        delta = F.min_image(delta, w)
    d2 = torch.sum(delta * delta, dim=-1)
    gate = (d2 > 0.0) & (d2 < r2)
    one = torch.ones_like(d2)
    zero = torch.zeros_like(d2)
    safe = torch.where(gate, d2, one)

    # mis <- aligned
    ok1 = gate & okj
    coef1 = F.pair_coef(mu[:, None, :], vj)[:, 0, :]
    s1 = torch.where(ok1, scale(safe, coef1), zero)
    f_mis = (delta * s1[..., None]).sum(1)

    # mis <- mis
    dmm = mpos[None, :, :] - mpos[:, None, :]
    if wrap:
        dmm = F.min_image(dmm, w)
    d2mm = torch.sum(dmm * dmm, dim=-1)
    gmm = (d2mm > 0.0) & (d2mm < r2) & mvalid[None, :]
    smm = torch.where(gmm, scale(torch.where(gmm, d2mm, torch.ones_like(d2mm)),
                                 F.pair_coef(mu, mv)), torch.zeros_like(d2mm))
    f_mis = f_mis + (dmm * smm[..., None]).sum(1)

    # aligned <- mis, added per whole cell block (receivers gated by okj)
    ok2 = gate & mvalid[:, None] & okj
    coef2 = F.pair_coef(uj, mv[:, None, :])[..., 0]
    s2 = torch.where(ok2, scale(safe, coef2), zero)
    contrib = (-delta * s2[..., None]).reshape(m * 27, cap, 3)
    f_from = index_add_rows(
        torch.zeros((k_cells, cap, 3), dtype=torch.float32, device=dev),
        cell.reshape(-1), contrib, (cell_ok & mvalid[:, None]).reshape(-1))
    return f_mis, f_from.reshape(s, 3)


def neighborhood_apply(f, positions, u_all, v_all, src_ok, mis, cfg: SimConfig,
                       nsc: int, cap: int):
    """Add both sidecar terms to the slot forces ``f`` [S, 3]. ``mis`` is
    the [ocap] worklist of misplaced slot indices, padded with S; padded
    entries contribute exact zeros."""
    s_total = positions.shape[0]
    mvalid = mis < s_total
    msafe = torch.clamp(mis, max=s_total - 1)
    f_mis, f_from = neighborhood_sweeps(
        positions, u_all, v_all, src_ok,
        positions[msafe], u_all[msafe], v_all[msafe], mvalid, cfg, nsc, cap)
    return index_add_rows(f + f_from, msafe, f_mis, mvalid)
