"""Incrementally maintained dense cell layout: the exact production path
(port of ``particle3d_tpu.ops.celllist_dense``).

The simulation state lives in the flat slot layout for the whole run
(S = nsc^3 * cap slots, ``cap`` per supercell). After each step only the
movers (occupants whose supercell changed) are reassigned:

  1. bin the integrated positions,
  2. extract the movers (``masked_indices``, bounded by ``mcap``),
  3. stable-sort them by target cell and rank them per cell,
  4. give each the r-th currently free slot of its target cell,
  5. move their rows.

Movers whose target cell is full, and movers beyond ``mcap``, stay in
their old slot as misplaced rows (r2 = -1, invisible to the grid kernel);
up to ``ocap`` of them are served exactly by the overflow sidecar, the
rest are frozen and counted. The layout is exactly what a full rebuild
would give, so no drift budget applies.

The JAX package runs the mover pipeline at one of {mcap/4, mcap/2, mcap}
behind ``lax.cond`` and scatters back with unique-index forms; both work
around TPU costs and are not carried over (the pipeline runs at mcap).
Dropped writes go to an extra row that is sliced off; no index is ever
out of range.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SimConfig
from . import forces as F
from .celllist_sweep import (bin_sid, column_sweep_forces, fold_to_cells,
                             ghost_columns)
from .compaction import masked_indices
from .params import PAIR_P, pack_params, r2_gate

# Default overflow-sidecar capacity (see ops/overflow.py); cfg.overflow_capacity
# overrides it.
OCAP = 512

# data rows [pos(3) | vel(3) | acc(3)]; feat rows [U(P) | V(P)]
_POS = slice(0, 3)
_VEL = slice(3, 6)
_ACC = slice(6, 9)
_FU = slice(0, PAIR_P)
_FV = slice(PAIR_P, 2 * PAIR_P)


@dataclasses.dataclass(frozen=True)
class DenseSim:
    """Simulation state in the flat slot layout.

    data f32[S, 9] dynamics rows; feat f32[S, 2P] layout-constant pair
    features (moved only by ``rebind``); pid i64[S] particle id or -1;
    r2 f32[S] radius gate: the law's r^2 for a correctly binned occupant,
    -1 for empty or misplaced slots.
    """

    data: torch.Tensor
    feat: torch.Tensor
    pid: torch.Tensor
    r2: torch.Tensor

    @property
    def pos(self):
        return self.data[:, _POS]

    @property
    def vel(self):
        return self.data[:, _VEL]

    @property
    def acc(self):
        return self.data[:, _ACC]

    @property
    def u(self):
        return self.feat[:, _FU]

    @property
    def v(self):
        return self.feat[:, _FV]

    def replace(self, **kw) -> "DenseSim":
        return dataclasses.replace(self, **kw)


def default_mover_capacity(n: int) -> int:
    """Static bound on movers per step (~N/16)."""
    return max(1024, -(-(n // 16) // 128) * 128)


def _set_drop(a: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``a.at[idx].set(vals, mode="drop")`` for idx in [0, len(a)]: index
    len(a) lands on an extra row that is sliced off."""
    buf = torch.cat([a, a[:1]])
    buf[idx] = vals
    return buf[:-1]


def build_dense(state, cfg: SimConfig, nsc: int, cap: int,
                ocap: int = OCAP) -> DenseSim:
    """Full (sorting) build of the layout from particle-order state.

    Capacity overflow (cell rank >= cap) is parked, one row per cell,
    emptiest cells first, as misplaced rows for the sidecar; overflow
    beyond ``ocap`` gets no slot (callers count it as masked)."""
    n = state.positions.shape[0]
    dev = state.positions.device
    u, v = F.pair_features(state, cfg, pad_p=PAIR_P)
    sid = bin_sid(state.positions, cfg, nsc)
    order = torch.argsort(sid, stable=True)
    sid_s = sid[order]
    k_cells = nsc ** 3
    s_total = k_cells * cap
    starts = torch.searchsorted(sid_s, torch.arange(k_cells, device=dev))
    rank = torch.arange(n, device=dev) - starts[sid_s]
    keep = rank < cap
    flat = torch.where(keep, sid_s * cap + rank, s_total)
    pid = _set_drop(torch.full((s_total,), -1, dtype=torch.int64, device=dev),
                    flat, order)
    if ocap:
        oc = min(ocap, k_cells)
        free = (pid < 0).reshape(k_cells, cap)
        free_count = free.sum(1)
        host_cells = torch.argsort(-free_count, stable=True)[:oc]
        first_free = torch.argmax(free.to(torch.int8), dim=1)
        free_idx = torch.where(free_count[host_cells] > 0,
                               host_cells * cap + first_free[host_cells],
                               s_total)
        of_rank = torch.cumsum((~keep).to(torch.int64), 0) - 1
        of_dst = torch.where(~keep & (of_rank < oc),
                             free_idx[torch.clamp(of_rank, 0, oc - 1)], s_total)
        pid = _set_drop(pid, of_dst, order)
    present = pid >= 0
    safe = torch.where(present, pid, 0)
    packed = torch.cat([state.positions.float(), state.velocities.float(),
                        state.accel.float(), u.float(), v.float()], dim=1)
    rows = torch.where(present[:, None], packed[safe], torch.zeros((), device=dev))
    data = rows[:, :9].contiguous()
    feat = rows[:, 9:].contiguous()
    # grid visibility is alignment, not presence: a parked overflow row in a
    # wrong cell stays kernel-invisible (the sidecar serves it)
    cell_of_slot = torch.arange(s_total, device=dev) // cap
    aligned = present & (bin_sid(data[:, _POS], cfg, nsc) == cell_of_slot)
    return DenseSim(data=data, feat=feat, pid=pid,
                    r2=torch.where(aligned, float(r2_gate(cfg)), -1.0))


def sidecar_indices(ds: DenseSim, ocap: int = OCAP):
    """Ascending slot indices of misplaced rows (pid >= 0, r2 <= 0),
    padded to ``ocap`` with S."""
    s_total = ds.pid.shape[0]
    return masked_indices((ds.pid >= 0) & (ds.r2 <= 0.0), ocap,
                          fill_value=s_total)


def scatter_back(ds: DenseSim, state):
    """Write the dense state back to particle order. Particles that never
    got a slot keep their values from ``state``."""
    n = state.positions.shape[0]
    s_total = ds.pid.shape[0]
    dev = ds.pid.device
    inv = torch.full((n + 1,), s_total, dtype=torch.int64, device=dev)
    inv[torch.where(ds.pid >= 0, ds.pid, n)] = torch.arange(s_total, device=dev)
    inv = inv[:n]
    placed = inv < s_total
    rows = ds.data[torch.clamp(inv, max=s_total - 1)]
    init = torch.cat([state.positions.float(), state.velocities.float(),
                      state.accel.float()], dim=1)
    out = torch.where(placed[:, None], rows, init)
    return state.replace(
        positions=out[:, _POS].to(state.positions.dtype),
        velocities=out[:, _VEL].to(state.velocities.dtype),
        accel=out[:, _ACC].to(state.accel.dtype))


def sweep_operands(pos_flat, ds: DenseSim, cfg: SimConfig, nsc: int, cap: int):
    """K1's operands (pos_d, u_d, post_g, vt_g, r2_g) for positions in the
    current slot layout: positions, features and the r2 gate are ghosted
    on every call, since the layout changes every step."""
    ncol = nsc * nsc
    cs = nsc * cap
    pos_r = pos_flat.reshape(ncol, cs, 3).float()
    if cfg.wrap_forces:
        # fold wrap-crossers back next to their cell (column-level images)
        pos_r = fold_to_cells(pos_r, cfg.world_size, nsc, cap)
    post_g, vt_g, r2_g = ghost_columns(
        pos_r, ds.v.reshape(ncol, cs, PAIR_P), ds.r2.reshape(ncol, cs), cfg, cap)
    pos_d = pos_r.permute(0, 2, 1).contiguous()
    u_d = ds.u.reshape(ncol, cs, PAIR_P).permute(0, 2, 1).contiguous()
    return pos_d, u_d, post_g, vt_g, r2_g


def dense_forces_fresh(pos_flat, ds: DenseSim, cfg: SimConfig, nsc: int,
                       cap: int):
    """K1 forces [S, 3] for positions in the current slot layout. Rows of
    empty slots are garbage by design."""
    out = column_sweep_forces(*sweep_operands(pos_flat, ds, cfg, nsc, cap),
                              pack_params(cfg), cfg.force_law,
                              bool(cfg.wrap_forces), nsc, cap)
    return out.permute(0, 2, 1).reshape(-1, 3)


def rebind(ds: DenseSim, cfg: SimConfig, nsc: int, cap: int, mcap: int,
           ocap: int = OCAP):
    """Repair the slot layout after one integration step. Returns (new
    layout, mover count, misplaced count, mis_idx): ``mis_idx`` is the
    [ocap] sidecar worklist (slots of movers that failed placement this
    step, S-padded). Misplaced rows beyond it, and movers beyond mcap, are
    frozen; ``misplaced count - valid(mis_idx)`` counts them."""
    s_total = ds.pid.shape[0]
    dev = ds.pid.device
    k_cells = nsc ** 3

    occupied = ds.pid >= 0
    sid_new = bin_sid(ds.pos, cfg, nsc)
    cell_of_slot = torch.arange(s_total, device=dev) // cap
    moved = occupied & (sid_new != cell_of_slot)
    n_movers = moved.sum()
    idx_m = masked_indices(moved, mcap, fill_value=s_total)

    # only CURRENTLY empty slots are free: a mover that fails placement
    # stays in its slot, which must not be handed to another mover
    free = ~occupied.reshape(k_cells, cap)
    free_count = free.sum(1)
    # column of the r-th free slot per cell (free first, stable)
    free_order = torch.argsort((~free).to(torch.int8), dim=1, stable=True)

    m = idx_m.shape[0]
    valid_m = idx_m < s_total
    tgt = torch.where(valid_m, sid_new[torch.clamp(idx_m, max=s_total - 1)],
                      k_cells)
    order = torch.argsort(tgt, stable=True)
    idx_s, tgt, valid_s = idx_m[order], tgt[order], valid_m[order]
    # arrival rank within the target cell: distance to the segment start
    iota = torch.arange(m, device=dev)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           tgt[1:] != tgt[:-1]])
    rank = iota - torch.cummax(torch.where(seg_start, iota, 0), 0).values
    tgt_safe = torch.clamp(tgt, max=k_cells - 1)
    can = valid_s & (rank < free_count[tgt_safe])
    dst = torch.where(
        can, tgt_safe * cap + free_order[tgt_safe, torch.clamp(rank, 0, cap - 1)],
        s_total)
    src = torch.where(can, torch.clamp(idx_s, max=s_total - 1), s_total)
    src_safe = torch.clamp(src, max=s_total - 1)

    # vacated data rows stay stale on purpose: pid = -1 and r2 = -1 make
    # them dead, and a new occupant overwrites the whole row
    data = _set_drop(ds.data, dst, ds.data[src_safe])
    feat = _set_drop(ds.feat, dst, ds.feat[src_safe])
    pid = _set_drop(_set_drop(ds.pid, src, -1), dst, ds.pid[src_safe])
    if ocap:
        # movers that failed placement stay misplaced at idx_s
        mpos = masked_indices(valid_s & ~can, ocap, fill_value=m)
        mis = torch.where(mpos < m, idx_s[torch.clamp(mpos, max=m - 1)], s_total)
    else:
        mis = torch.zeros((0,), dtype=torch.int64, device=dev)

    # r2 from scratch: live iff occupied and binned into the slot's cell
    aligned = (pid >= 0) & (bin_sid(data[:, _POS], cfg, nsc) == cell_of_slot)
    r2 = torch.where(aligned, float(r2_gate(cfg)), -1.0)
    n_misplaced = ((pid >= 0) & ~aligned).sum()
    return DenseSim(data=data, feat=feat, pid=pid, r2=r2), n_movers, n_misplaced, mis
