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

``slab_neighborhood_sweeps`` is the slab decomposition's form, per rank
over the halo-extended planes. Both need nsc >= 3 (periodic neighbour cells
must be distinct); smaller grids take ``sidecar_sweeps``, which sweeps the
misplaced rows against every slot. ``rect_forces`` is the plain blocked
sweep of receivers against a masked source set.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, f32
from . import forces as F
from .compaction import index_add_rows
from .params import r2_gate


def _blocks(n: int, b: int):
    return [(i, min(i + b, n)) for i in range(0, n, b)]


def _pair_scale(delta, ok, coef, scale, r2: float):
    """The pair scale s [..] of displacements ``delta`` [.., 3]: 0 < d^2 <
    r2 and ``ok``; 0 elsewhere."""
    d2 = torch.sum(delta * delta, dim=-1)
    valid = (d2 > 0.0) & (d2 < r2) & ok
    safe = torch.where(valid, d2, torch.ones_like(d2))
    return torch.where(valid, scale(safe, coef), torch.zeros_like(d2))


def rect_forces(pos_i, u_i, pos_j, v_j, valid_j, cfg: SimConfig,
                block_i: int = 65536, block_j: int = 65536):
    """Accumulated forces [NI, 3] on receivers i from sources j.
    ``valid_j`` masks phantom source rows (empty slots hold stale finite
    values); receiver rows are not masked (callers gate or scatter the
    output). Blocked over both axes: peak memory O(block_i * block_j)."""
    scale = F.scale_fn(cfg)
    r2 = float(r2_gate(cfg))
    w = f32(cfg.world_size)
    pos_i, u_i = pos_i.float(), u_i.float()
    pos_j, v_j = pos_j.float(), v_j.float()
    out = []
    for i0, i1 in _blocks(pos_i.shape[0], block_i):
        acc = torch.zeros((i1 - i0, 3), dtype=torch.float32,
                          device=pos_i.device)
        for j0, j1 in _blocks(pos_j.shape[0], block_j):
            delta = pos_j[None, j0:j1] - pos_i[i0:i1, None]  # i -> j
            if cfg.wrap_forces:
                delta = F.min_image(delta, w)
            s = _pair_scale(delta, valid_j[None, j0:j1],
                            F.pair_coef(u_i[i0:i1], v_j[j0:j1]), scale, r2)
            acc = acc + torch.einsum("ijc,ij->ic", delta, s)
        out.append(acc)
    if not out:
        return pos_i.new_zeros((0, 3))
    return torch.cat(out)


def sidecar_sweeps(positions, u_all, v_all, src_ok, mpos, mu, mv, mvalid,
                   cfg: SimConfig, block: int = 65536):
    """Both sidecar sweeps in one pass over the S slot rows, sharing the
    pair geometry: ``(f_mis [M, 3], f_from [S, 3])``, the forces on the M
    misplaced rows from every valid slot (``src_ok``), and the forces from
    the valid misplaced rows (``mvalid``) onto every slot (callers gate
    them to aligned receivers). The laws are directional, so each direction
    has its own coefficient and scale. For any grid; cost O(M * S)."""
    scale = F.scale_fn(cfg)
    r2 = float(r2_gate(cfg))
    w = f32(cfg.world_size)
    mpos, mu, mv = mpos.float(), mu.float(), mv.float()
    f_mis = torch.zeros((mpos.shape[0], 3), dtype=torch.float32,
                        device=positions.device)
    f_from = []
    for b0, b1 in _blocks(positions.shape[0], block):
        ps = positions[b0:b1].float()
        delta = mpos[None, :, :] - ps[:, None, :]  # [b, m, 3], slot -> mis
        if cfg.wrap_forces:
            delta = F.min_image(delta, w)
        # forces on the slots from the misplaced rows
        s2 = _pair_scale(delta, mvalid[None, :],
                         F.pair_coef(u_all[b0:b1].float(), mv), scale, r2)
        f_from.append(torch.einsum("smc,sm->sc", delta, s2))
        # forces on the misplaced rows from the valid slots
        s1 = _pair_scale(delta, src_ok[b0:b1, None],
                         F.pair_coef(v_all[b0:b1].float(), mu), scale, r2)
        f_mis = f_mis - torch.einsum("smc,sm->mc", delta, s1)
    if not f_from:
        return f_mis, positions.new_zeros((0, 3))
    return f_mis, torch.cat(f_from)


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


def slab_neighborhood_sweeps(ext, u_all, mpos, mu, mv, mvalid, cfg: SimConfig,
                             nsc: int, planes_local: int, cap: int, me: int,
                             self_ring: bool = False):
    """The slab decomposition's sidecar (port of the JAX function of this
    name): ``neighborhood_sweeps`` for one rank, with sources read from the
    halo-extended plane pack the force kernel already exchanged.

    ``ext`` f32[(planes_local + 2) * nsc, cs, 3 + P + 1] holds the source
    planes [pos | V | r2] with one halo plane at each x end (wraparound
    halos shifted or killed as the kernel saw them); ``u_all`` f32[s_loc, P]
    the rank's receiver features; ``mpos/mu/mv/mvalid`` the combined
    misplaced rows: the rank's own worklist first, then each neighbour's
    payload once. Positions are raw: displacements use the minimum image
    when periodic, and each row's x plane maps into the extended grid by
    its distance from the slab start, mod nsc.

    Terms, receiver-centric as in ``neighborhood_sweeps``: A, mis <-
    aligned, from ``ext`` windows (only the local prefix of the output is
    complete); B, mis <- mis over the combined set; C, local aligned
    receivers <- mis, dropping window cells in halo planes (the neighbour
    owns them), except on a ``self_ring`` (one rank, periodic: the rank is
    its own neighbour and ships nothing), where halo cells map back onto
    their wrapped local planes. Returns ``(f_mis [M, 3], f_from [s_loc,
    3])``, f_from receiver-gated."""
    if nsc < 3:
        raise ValueError("neighbourhood sweeps need nsc >= 3")
    m = mpos.shape[0]
    p = mu.shape[1]
    dev = ext.device
    scale = F.scale_fn(cfg)
    r2 = float(r2_gate(cfg))
    wrap = bool(cfg.wrap_forces)
    w = f32(cfg.world_size)
    k_loc = planes_local * nsc * nsc
    s_loc = k_loc * cap
    n_ext = planes_local + 2
    k_ext = n_ext * nsc * nsc
    mpos, mu, mv = mpos.float(), mu.float(), mv.float()

    cellw = w / np.float32(nsc)
    c3 = torch.clamp(torch.floor(F.tdiv(mpos + float(w * np.float32(0.5)),
                                        cellw)).to(torch.int64), 0, nsc - 1)
    prel = c3[:, 0] - me * planes_local
    if wrap:
        prel = torch.remainder(prel, nsc)
        prel = torch.where(prel > planes_local, prel - nsc, prel)
    px = prel + 1
    o = torch.arange(-1, 2, device=dev)
    offs = torch.stack(torch.meshgrid(o, o, o, indexing="ij"), -1).reshape(27, 3)
    pxw = px[:, None] + offs[None, :, 0]
    cyw = c3[:, 1:2] + offs[None, :, 1]
    czw = c3[:, 2:3] + offs[None, :, 2]
    ok_x = (pxw >= 0) & (pxw < n_ext)
    if wrap:
        cyw = torch.remainder(cyw, nsc)
        czw = torch.remainder(czw, nsc)
        ok_yz = torch.ones_like(ok_x)
    else:
        ok_yz = (cyw >= 0) & (cyw < nsc) & (czw >= 0) & (czw < nsc)
        cyw = torch.clamp(cyw, 0, nsc - 1)
        czw = torch.clamp(czw, 0, nsc - 1)
    cell_ok = ok_x & ok_yz
    pxw_c = torch.clamp(pxw, 0, n_ext - 1)
    cell_ext = (pxw_c * nsc + cyw) * nsc + czw         # [m, 27]
    k = 27 * cap
    ok_cell = cell_ok[:, :, None].expand(m, 27, cap).reshape(m, k)

    win = ext.reshape(k_ext, cap, ext.shape[-1])[cell_ext].reshape(m, k, -1)
    pj = win[..., :3]
    vj = win[..., 3:3 + p]
    r2j = win[..., 3 + p]
    okj = (r2j > 0.0) & ok_cell                          # aligned sources

    delta = pj - mpos[:, None, :]                        # i -> j
    if wrap:
        delta = F.min_image(delta, w)
    d2 = torch.sum(delta * delta, dim=-1)
    gate = (d2 > 0.0) & (d2 < r2)
    zero = torch.zeros_like(d2)
    safe = torch.where(gate, d2, torch.ones_like(d2))

    # term A: mis <- aligned
    coef1 = F.pair_coef(mu[:, None, :], vj)[:, 0, :]
    s1 = torch.where(gate & okj, scale(safe, coef1), zero)
    f_mis = (delta * s1[..., None]).sum(1)

    # term B: mis <- mis over the combined set
    dmm = mpos[None, :, :] - mpos[:, None, :]
    if wrap:
        dmm = F.min_image(dmm, w)
    d2mm = torch.sum(dmm * dmm, dim=-1)
    gmm = (d2mm > 0.0) & (d2mm < r2) & mvalid[None, :]
    smm = torch.where(gmm, scale(torch.where(gmm, d2mm, torch.ones_like(d2mm)),
                                 F.pair_coef(mu, mv)), torch.zeros_like(d2mm))
    f_mis = f_mis + (dmm * smm[..., None]).sum(1)

    # term C: local aligned receivers <- mis (a window's 3 x-planes are
    # consecutive and nsc >= 3 keeps them distinct mod nsc, so no local
    # plane is hit twice)
    if self_ring and wrap:
        lx = torch.remainder(pxw - 1, planes_local)
        loc_ok = ok_yz
    else:
        lx = pxw_c - 1
        loc_ok = (pxw >= 1) & (pxw <= planes_local) & ok_yz
    cell_loc = (lx * nsc + cyw) * nsc + czw
    # receiver rows of each window cell, gathered straight from the
    # (possibly strided) feature columns
    rows = (torch.clamp(cell_loc, 0, k_loc - 1)[..., None] * cap
            + torch.arange(cap, device=dev))
    uj = u_all[rows.reshape(-1)].reshape(m, k, p).float()
    loc_ok_k = loc_ok[:, :, None].expand(m, 27, cap).reshape(m, k)
    ok2 = gate & (r2j > 0.0) & loc_ok_k & mvalid[:, None]
    coef2 = F.pair_coef(uj, mv[:, None, :])[..., 0]
    s2 = torch.where(ok2, scale(safe, coef2), zero)
    contrib = (-delta * s2[..., None]).reshape(m * 27, cap * 3)
    f_from = index_add_rows(
        torch.zeros((k_loc, cap * 3), dtype=torch.float32, device=dev),
        cell_loc.reshape(-1), contrib, (loc_ok & mvalid[:, None]).reshape(-1))
    return f_mis, f_from.reshape(s_loc, 3)
