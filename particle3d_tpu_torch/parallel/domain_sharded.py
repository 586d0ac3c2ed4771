"""State-sharded cell list: slab domain decomposition with halo exchange
(port of ``particle3d_tpu.parallel.domain_sharded``).

The supercell grid's x-planes are split into contiguous slabs, one per
rank, and each rank OWNS the dense slot rows of its slab, so per-rank
state memory is O(N/D). One process per rank (``parallel.launch``); the
ranks talk through the collectives of ``parallel.mesh.Mesh``.

  * **Forces**: each step the two edge x-planes of every slab go to the
    ring neighbours (one exchange of packed [nsc, cs, pos|V|r2] planes per
    direction), and the column sweep K1 runs in halo mode
    (``ops.celllist_sweep``, ``halo=True``): x neighbours are local offsets
    into the halo-extended sources, y and z stay periodic locally, and
    global x periodicity IS the ring, so the wraparound halo planes arrive
    shifted by a whole box. Walled boxes kill the two edge slabs'
    wraparound halo planes through the r2 channel. With three or more
    planes per slab and more than one rank, the interior planes' K1 call
    runs while the halo exchange is in flight; only the two edge-plane
    calls wait for it.
  * **Rebind**: movers are classified by target slab. In-slab movers take
    a currently-free slot of their target cell. Slab-crossers go into
    fixed-size left/right outboxes, one ring hop toward their target per
    step (multi-hop rows transit through the intermediate ranks' limbo),
    and are placed on arrival; arrivals that find their cell full wait in
    a per-rank LIMBO buffer and retry every step.
  * **Overflow sidecar**: misplaced slot rows and limbo rows of the slab
    go on a per-rank worklist of up to ``ocap`` and get exact forces from
    ``ops.overflow.slab_neighborhood_sweeps``, with the worklist payloads
    exchanged with the ring neighbours so cross-slab pairs are served on
    both sides. ``max_masked``/``max_limbo`` count only rows the sidecar
    could not serve; ``lost`` counts rows dropped past ``limbocap``.

The carry is PER RANK: ``(data, pid, limbo_data, limbo_pid, lost)`` holds
this rank's slab rows only (``data`` f32[s_loc, 9 + 2P] = pos | vel | acc
| U | V, ``pid`` i64[s_loc], and the limbo rows), not a globally shaped
sharded array as in the JAX package. Every rank calls every function with
its own carry; the diagnostics come back reduced over the mesh.

Static capacities (``mcap``, ``migcap``, ``limbocap``, ``ocap``) fix every
shape of the step, so it never synchronises with the device: the mover
pipeline runs at ``mcap`` every step. The JAX package's half-size branch
behind ``lax.cond`` (a TPU cost workaround with identical results) is not
carried over, and neither is its Mosaic VMEM gate.

Usage::

    out, diag = sharded_dense_simulate(state, cfg, dt, steps, mesh)

or, stay-sharded over several windows::

    carry = build_sharded_dense(state, cfg, mesh)   # or init_sharded_dense
    for _ in range(windows):
        carry, diag = sharded_dense_steps(carry, cfg, dt, k, mesh, n=n)
    state = gather_sharded_dense(carry, state, mesh)

or with the capacity ladder and its exact terminal rung, which rewind any
window that would commit rows without their pair forces::

    carry, cap, history = sharded_dense_adaptive(carry, cfg, dt, steps,
                                                 mesh, n=n)

``recap_sharded_dense`` grows a carry's capacity in place (the ladder's
rung) and ``sharded_exact_steps`` is the capacity-free terminal rung.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimConfig, f32
from ..engine.step import step as _step
from ..ops import forces as F
from ..ops.celllist_dense import OCAP, _set_drop
from ..ops.celllist_sweep import (bin_sid, check_cell_width,
                                  column_sweep_forces, fold_to_cells,
                                  ghost_columns)
from ..ops.compaction import index_add_rows, masked_indices
from ..ops.overflow import slab_neighborhood_sweeps
from ..ops.params import pack_params, r2_gate
from ..state import ParticleState
from .mesh import Mesh, balanced_counts

_POS = slice(0, 3)
_VEL = slice(3, 6)
_ACC = slice(6, 9)


def _feat(width: int):
    """(U, V) column slices of a carry row of ``width`` columns."""
    p = (width - 9) // 2
    return slice(9, 9 + p), slice(9 + p, 9 + 2 * p)


@dataclasses.dataclass(frozen=True)
class _Geom:
    """Static slab geometry (python ints only)."""

    d: int
    nsc: int
    cap: int
    planes_local: int
    cols_local: int
    cs: int
    s_loc: int
    k_loc: int
    k_glob: int
    mcap: int
    migcap: int
    limbocap: int
    ocap: int
    wrap: bool


def _geometry(cfg: SimConfig, mesh: Mesh, n: int, nsc, cap, mcap, migcap,
              limbocap, ocap=None) -> _Geom:
    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None or cap is None:
        raise ValueError("slab decomposition needs cfg.cell_grid / "
                         "cfg.cell_capacity")
    d = mesh.size
    if nsc % d:
        raise ValueError(f"nsc={nsc} must divide by mesh size {d}")
    check_cell_width(cfg, nsc)
    planes_local = nsc // d
    cols_local = planes_local * nsc
    cs = nsc * cap
    if mcap is None:
        mcap = max(512, -(-max(n // (8 * d), 1) // 128) * 128)
    if migcap is None:
        migcap = max(256, mcap // 2)
    if limbocap is None:
        limbocap = migcap
    if ocap is None:
        ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity
    if nsc < 3:  # the neighbourhood sweep needs distinct window cells
        ocap = 0
    return _Geom(d=d, nsc=nsc, cap=cap, planes_local=planes_local,
                 cols_local=cols_local, cs=cs, s_loc=cols_local * cs,
                 k_loc=cols_local * nsc, k_glob=nsc ** 3, mcap=mcap,
                 migcap=migcap, limbocap=limbocap, ocap=int(ocap),
                 wrap=bool(cfg.wrap_forces))


def _assign_slots(pid, tgt_local, valid, k_loc: int, cap: int):
    """Rank rows per target cell and pick the r-th currently-free slot.

    Returns (order, dst, can): ``order`` sorts the rows by target cell;
    ``dst[i]`` is the slot for sorted row i (s_loc when unplaceable);
    ``can`` marks placed sorted rows. Only currently empty slots are free:
    a mover that fails placement keeps its slot."""
    m = tgt_local.shape[0]
    s_loc = pid.shape[0]
    dev = pid.device
    key = torch.where(valid, tgt_local, k_loc)
    order = torch.argsort(key, stable=True)
    key = key[order]
    valid_s = valid[order]
    iota = torch.arange(m, device=dev)
    seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                     key[1:] != key[:-1]])
    rank = iota - torch.cummax(torch.where(seg, iota, 0), 0).values
    free = (pid < 0).reshape(k_loc, cap)
    free_count = free.sum(1)
    free_order = torch.argsort((~free).to(torch.int8), dim=1, stable=True)
    kc = torch.clamp(key, max=k_loc - 1)
    can = valid_s & (rank < free_count[kc])
    dst = torch.where(
        can, kc * cap + free_order[kc, torch.clamp(rank, 0, cap - 1)], s_loc)
    return order, dst, can


def _local_build(state: ParticleState, cfg: SimConfig, g: _Geom, me: int):
    """This rank's slab rows of ``state``: (data, pid, limbo_data,
    limbo_pid, lost0). Rows of other slabs are skipped; rows past a full
    cell start in limbo, and rows past ``limbocap`` are counted lost."""
    n = state.n
    dev = state.positions.device
    cell_lo = me * g.k_loc
    u, v = F.pad_features(*F.pair_features(state, cfg))
    packed = torch.cat([state.positions.float(), state.velocities.float(),
                        state.accel.float(), u, v], dim=1)
    sid = bin_sid(state.positions, cfg, g.nsc)
    mine = sid // (g.planes_local * g.nsc * g.nsc) == me
    key = torch.where(mine, sid, g.k_glob)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    starts = torch.searchsorted(key_s, torch.arange(g.k_glob + 1, device=dev))
    rank = torch.arange(n, device=dev) - starts[torch.clamp(key_s, max=g.k_glob)]
    keep = (key_s < g.k_glob) & (rank < g.cap)
    flat = torch.where(keep, (key_s - cell_lo) * g.cap + rank, g.s_loc)
    pid = _set_drop(torch.full((g.s_loc,), -1, dtype=torch.int64, device=dev),
                    flat, order)
    present = pid >= 0
    zero = torch.zeros((), device=dev)
    data = torch.where(present[:, None], packed[torch.where(present, pid, 0)],
                       zero)

    unplaced = (key_s < g.k_glob) & (rank >= g.cap)
    li = masked_indices(unplaced, g.limbocap, fill_value=n)
    l_ok = li < n
    l_src = torch.where(l_ok, order[torch.clamp(li, max=n - 1)], 0)
    limbo_data = torch.where(l_ok[:, None], packed[l_src], zero)
    limbo_pid = torch.where(l_ok, l_src, -1)
    lost0 = torch.clamp(unplaced.sum() - l_ok.sum(), min=0)
    return data, pid, limbo_data, limbo_pid, lost0


def _initial_worklist(data, pid, limbo_data, limbo_pid, cfg, g: _Geom, me: int):
    """Sidecar worklist of a freshly entered carry: combined indices (slots
    [0, s_loc), limbo [s_loc, s_loc + limbocap)) of misplaced in-slab slot
    rows and in-slab limbo rows, ascending, padded with s_loc + limbocap."""
    dev = pid.device
    if not g.ocap:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    cell_lo = me * g.k_loc
    cell_of_slot = cell_lo + torch.arange(g.s_loc, device=dev) // g.cap
    sid = bin_sid(data[:, _POS], cfg, g.nsc)
    tloc = sid - cell_lo
    mis_slot = (pid >= 0) & (sid != cell_of_slot) & (tloc >= 0) & (tloc < g.k_loc)
    lt = torch.where(limbo_pid >= 0,
                     bin_sid(limbo_data[:, _POS], cfg, g.nsc) - cell_lo, -1)
    mis_lim = (lt >= 0) & (lt < g.k_loc)
    return masked_indices(torch.cat([mis_slot, mis_lim]), g.ocap,
                          fill_value=g.s_loc + g.limbocap)


def slab_pack(pos_flat, dat, r2, cfg: SimConfig, g: _Geom, me: int):
    """This rank's receiver and source planes for K1 in halo mode:
    ``(pos_d [cols, cs, 3], u_d [cols, cs, P], pack [cols, cs, 4 + P])``,
    the pack holding [pos | V | r2] per slot. Periodic positions are folded
    next to their cell (x centres at global plane indices)."""
    cols, cs = g.cols_local, g.cs
    fu, fv = _feat(dat.shape[1])
    p = fu.stop - fu.start
    pos_d = pos_flat.reshape(cols, cs, 3).float()
    if g.wrap:
        pos_d = fold_to_cells(pos_d, f32(cfg.world_size), g.nsc, g.cap,
                              col0_x=me * g.planes_local)
    pack = torch.cat([pos_d, dat[:, fv].reshape(cols, cs, p),
                      r2.reshape(cols, cs, 1)], dim=-1)
    return pos_d, dat[:, fu].reshape(cols, cs, p), pack


def fix_halos(from_left, from_right, cfg: SimConfig, d: int, me: int):
    """The halo planes rank ``me`` of ``d`` received, as the kernel must
    see them. Walled: the ring's wraparound planes are not neighbours, so
    the edge ranks kill them through r2 = -1 (the last channel). Periodic:
    they are images a box away, so their x shifts by -+w (halo mode
    applies no x image shift in the kernel)."""
    w = f32(cfg.world_size)

    def kill(t):
        return torch.cat([t[..., :-1], torch.full_like(t[..., -1:], -1.0)], -1)

    def shift(t, dx):
        return torch.cat([t[..., :1] + dx, t[..., 1:]], -1)

    wrap = bool(cfg.wrap_forces)
    if me == 0:
        from_left = shift(from_left, float(-w)) if wrap else kill(from_left)
    if me == d - 1:
        from_right = shift(from_right, float(w)) if wrap else kill(from_right)
    return from_left, from_right


def halo_call_operands(recv_pos, recv_u, ext, cfg: SimConfig, cap: int):
    """K1's halo-mode operands for receiver planes ``recv_pos``/``recv_u``
    [ncol, cs, 3|P] and source planes ``ext`` [ncol + 2 nsc, cs, 4 + P]
    (one plane leading and one trailing the receivers')."""
    p = recv_u.shape[-1]
    post_g, vt_g, r2_g = ghost_columns(ext[..., :3], ext[..., 3:3 + p],
                                       ext[..., 3 + p], cfg, cap)
    return (recv_pos.permute(0, 2, 1).contiguous(),
            recv_u.permute(0, 2, 1).contiguous(), post_g, vt_g, r2_g)


def _halo_forces(pos_flat, dat, r2, cfg: SimConfig, g: _Geom, mesh: Mesh,
                 want_ext: bool):
    """K1 halo-mode forces [s_loc, 3] on this rank's slots, and the
    halo-extended source pack the sidecar reads (None unless
    ``want_ext``)."""
    me, nsc, cols = mesh.rank, g.nsc, g.cols_local
    pos_d, u_d, pack = slab_pack(pos_flat, dat, r2, cfg, g, me)
    pending = mesh.exchange_start(to_right=[pack[cols - nsc:]],
                                  to_left=[pack[:nsc]])
    params = pack_params(cfg)

    def halos():
        (from_left,), (from_right,) = pending.wait()
        return fix_halos(from_left, from_right, cfg, g.d, me)

    def run_call(recv_pos, recv_u, ext):
        out = column_sweep_forces(
            *halo_call_operands(recv_pos, recv_u, ext, cfg, g.cap), params,
            cfg.force_law, g.wrap, nsc, g.cap, halo=True)
        return out.permute(0, 2, 1)

    if g.d == 1 or g.planes_local < 3:
        from_left, from_right = halos()
        ext = torch.cat([from_left, pack, from_right], 0)
        return run_call(pos_d, u_d, ext).reshape(-1, 3), ext
    # two phases: the interior planes' sources are all local, so their call
    # runs while the exchange is in flight; the edge calls consume the halos
    out_int = run_call(pos_d[nsc:cols - nsc], u_d[nsc:cols - nsc], pack)
    from_left, from_right = halos()
    out_l = run_call(pos_d[:nsc], u_d[:nsc],
                     torch.cat([from_left, pack[:2 * nsc]], 0))
    out_r = run_call(pos_d[cols - nsc:], u_d[cols - nsc:],
                     torch.cat([pack[cols - 2 * nsc:], from_right], 0))
    ext = torch.cat([from_left, pack, from_right], 0) if want_ext else None
    return torch.cat([out_l, out_int, out_r], 0).reshape(-1, 3), ext


def _make_step_body(cfg: SimConfig, dt, g: _Geom, mesh: Mesh,
                    move_only: bool = False):
    """The per-step function: halo forces (+ overflow sidecar) + integrate
    + rebind/migration. ``move_only`` skips forces and integration: a pure
    layout-repair pass (``sharded_relayout``)."""
    me, d = mesh.rank, g.d
    dev = mesh.device
    nsc, cap = g.nsc, g.cap
    s_loc, k_loc, k_glob = g.s_loc, g.k_loc, g.k_glob
    mcap, migcap, limbocap, ocap = g.mcap, g.migcap, g.limbocap, g.ocap
    cell_lo = me * k_loc
    cell_of_slot = cell_lo + torch.arange(s_loc, device=dev) // cap
    sent = s_loc + limbocap            # worklist sentinel / drop index
    n_int = s_loc + (limbocap if ocap else 0)
    dummy_species = torch.zeros((n_int,), dtype=torch.int64, device=dev)
    dummy_masses = torch.zeros((n_int,), dtype=torch.float32, device=dev)
    r2v = float(r2_gate(cfg))
    kick = float(F.kick_scale(cfg))
    slab_cells = g.planes_local * nsc * nsc
    lim_iota = torch.arange(limbocap, device=dev)

    def sidecar_terms(data, limbo_data, mis, pos_slot, pos_limbo, ext):
        """Exact forces ON the worklist rows (local prefix) and their
        reverse forces onto local aligned receivers, from the combined
        payloads of this rank and its ring neighbours (positions fresh at
        the force evaluation). Returns (f_mis [ocap, 3], f_from [s_loc, 3],
        slot_dst, lim_dst)."""
        fu, fv = _feat(data.shape[1])
        msafe = torch.clamp(mis, max=sent - 1)
        mval = mis < sent
        is_lim = msafe >= s_loc
        li = torch.clamp(msafe - s_loc, 0, limbocap - 1)
        si = torch.clamp(msafe, max=s_loc - 1)
        rows = torch.where(is_lim[:, None], limbo_data[li], data[si])
        mpos = torch.where(is_lim[:, None], pos_limbo[li], pos_slot[si])
        pay = torch.cat([mpos, rows[:, fu], rows[:, fv],
                         mval[:, None].float()], dim=1)
        if d == 1:
            comb = pay
        elif d == 2:  # one neighbour both ways: ship once
            comb = torch.cat([pay, mesh.ppermute([pay], 1)[0]])
        else:
            (fl,), (fr,) = mesh.exchange_start([pay], [pay]).wait()
            comb = torch.cat([pay, fl, fr])
        p = fu.stop - fu.start
        f_mis, f_from = slab_neighborhood_sweeps(
            ext, data[:, fu], comb[:, :3], comb[:, 3:3 + p],
            comb[:, 3 + p:3 + 2 * p], comb[:, -1] > 0.0, cfg, nsc,
            g.planes_local, cap, me, self_ring=(d == 1))
        slot_dst = torch.where(mval & ~is_lim, msafe, s_loc)
        lim_dst = torch.where(mval & is_lim, msafe - s_loc, limbocap)
        return f_mis[:ocap], f_from, slot_dst, lim_dst

    def add_rows(f, dst, vals):
        return index_add_rows(f, dst, vals, dst < f.shape[0])

    def integrate(data, limbo_data, mis, r2):
        # forces of empty and misplaced rows are selected away, never
        # multiplied by 0: a stale row under a singular law can hold an
        # infinite force (see engine.step.dense_pair_forces)
        keep = r2 > 0.0
        if ocap and cfg.integrator == "euler":
            # Euler evaluates forces once, at the pre-step state: kernel +
            # sidecar terms once, then the slot rows and the small limbo
            # set integrate separately with those accelerations
            fk, ext = _halo_forces(data[:, _POS], data, r2, cfg, g, mesh, True)
            f_mis, f_from, slot_dst, lim_dst = sidecar_terms(
                data, limbo_data, mis, data[:, _POS], limbo_data[:, _POS], ext)
            f_slot = add_rows(torch.where(keep[:, None], fk, 0.0) + f_from,
                              slot_dst, f_mis) * kick
            f_lim = add_rows(torch.zeros((limbocap, 3), device=dev), lim_dst,
                             f_mis) * kick
            ps = _step(ParticleState(data[:, _POS], data[:, _VEL],
                                     dummy_species[:s_loc], dummy_masses[:s_loc],
                                     data[:, _ACC]),
                       cfg, dt, accel_fn=lambda p_, s_, c_: f_slot)
            data = torch.cat([ps.positions, ps.velocities, ps.accel,
                              data[:, 9:]], 1)
            pl_ = _step(ParticleState(limbo_data[:, _POS], limbo_data[:, _VEL],
                                      dummy_species[:limbocap],
                                      dummy_masses[:limbocap],
                                      limbo_data[:, _ACC]),
                        cfg, dt, accel_fn=lambda p_, s_, c_: f_lim)
            limbo_data = torch.cat([pl_.positions, pl_.velocities, pl_.accel,
                                    limbo_data[:, 9:]], 1)
            return data, limbo_data
        if ocap:
            # non-Euler integrators evaluate forces at mid-step positions:
            # the sidecar runs inside accel_fn on the slot + limbo state
            def accel_fn(positions, st, c):
                f, ext = _halo_forces(positions[:s_loc], data, r2, c, g, mesh,
                                      True)
                f = torch.where(keep[:, None], f, 0.0)
                f_mis, f_from, slot_dst, lim_dst = sidecar_terms(
                    data, limbo_data, mis, positions[:s_loc],
                    positions[s_loc:], ext)
                f = torch.cat([
                    add_rows(f + f_from, slot_dst, f_mis),
                    add_rows(torch.zeros((limbocap, 3), device=dev), lim_dst,
                             f_mis)])
                return f * kick

            ps = _step(ParticleState(
                torch.cat([data[:, _POS], limbo_data[:, _POS]]),
                torch.cat([data[:, _VEL], limbo_data[:, _VEL]]),
                dummy_species, dummy_masses,
                torch.cat([data[:, _ACC], limbo_data[:, _ACC]])),
                cfg, dt, accel_fn=accel_fn)
            data = torch.cat([ps.positions[:s_loc], ps.velocities[:s_loc],
                              ps.accel[:s_loc], data[:, 9:]], 1)
            limbo_data = torch.cat([ps.positions[s_loc:], ps.velocities[s_loc:],
                                    ps.accel[s_loc:], limbo_data[:, 9:]], 1)
            return data, limbo_data

        def accel_fn(positions, st, c):
            f, _ = _halo_forces(positions, data, r2, c, g, mesh, False)
            return torch.where(keep[:, None], f * kick, 0.0)

        ps = _step(ParticleState(data[:, _POS], data[:, _VEL], dummy_species,
                                 dummy_masses, data[:, _ACC]),
                   cfg, dt, accel_fn=accel_fn)
        data = torch.cat([ps.positions, ps.velocities, ps.accel, data[:, 9:]], 1)
        return data, limbo_data

    def move_phase(data, pid, limbo_data, limbo_pid, sid_new, moved, tgt_l):
        """Mover extraction, outbox migration and placement at the static
        bounds mcap / migcap."""
        idx_m = masked_indices(moved, mcap, fill_value=s_loc)
        ok_m = idx_m < s_loc
        idx_ms = torch.clamp(idx_m, max=s_loc - 1)
        tgt_m = torch.where(ok_m, sid_new[idx_ms], k_glob)
        rows_m = data[idx_ms]
        pid_m = torch.where(ok_m, pid[idx_ms], -1)

        all_tgt = torch.cat([tgt_m, tgt_l])
        all_rows = torch.cat([rows_m, limbo_data])
        all_pid = torch.cat([pid_m, limbo_pid])
        all_ok = all_pid >= 0
        tslab = torch.clamp(all_tgt, max=k_glob - 1) // slab_cells
        in_slab = all_ok & (tslab == me)
        # one ring hop toward the shorter direction; multi-hop rows transit
        # through the intermediate ranks' limbo
        dl = (me - tslab) % d
        dr = (tslab - me) % d
        out = all_ok & ~in_slab
        go_left = out & (dl <= dr)
        go_right = out & (dr < dl)

        def pack_box(mask):
            n_all = mask.shape[0]
            bi = masked_indices(mask, migcap, fill_value=n_all)
            ok = bi < n_all
            bis = torch.clamp(bi, max=n_all - 1)
            box_d = torch.where(ok[:, None], all_rows[bis],
                                torch.zeros((), device=dev))
            box_p = torch.where(ok, all_pid[bis], -1)
            sel = _set_drop(torch.zeros(n_all, dtype=torch.bool, device=dev),
                            bi, True)
            return box_d, box_p, sel

        box_ld, box_lp, sel_l = pack_box(go_left)
        box_rd, box_rp, sel_r = pack_box(go_right)
        sel_ship = sel_l | sel_r
        n_ship = (box_lp >= 0).sum() + (box_rp >= 0).sum()
        pending = mesh.exchange_start(to_right=[box_rd, box_rp],
                                      to_left=[box_ld, box_lp])

        # free the slots of shipped movers (the first mcap rows are movers);
        # a vacated row stays stale: pid -1 makes it dead
        pid2 = _set_drop(pid, torch.where(sel_ship[:mcap], idx_m, s_loc), -1)

        # pass A: place in-slab movers
        tgt_loc_m = torch.where(in_slab[:mcap], all_tgt[:mcap] - cell_lo, -1)
        order_a, dst_a, can_a = _assign_slots(pid2, tgt_loc_m, in_slab[:mcap],
                                              k_loc, cap)
        src_a = torch.where(can_a, idx_m[order_a], s_loc)
        pid2 = _set_drop(pid2, src_a, -1)
        data2 = _set_drop(data, dst_a, rows_m[order_a])
        pid2 = _set_drop(pid2, dst_a, torch.where(can_a, pid_m[order_a], -1))
        if ocap:
            # in-slab movers that failed placement stay misaligned in their
            # old slot: the sidecar serves them next step
            fail_a = in_slab[:mcap][order_a] & ~can_a
            mis_slot = torch.where(fail_a, idx_m[order_a], sent)

        # pass B: place arrivals and retryable limbo rows
        (in_ld, in_lp), (in_rd, in_rp) = pending.wait()
        limbo_keep = (limbo_pid >= 0) & ~sel_ship[mcap:]
        arr_d = torch.cat([in_ld, in_rd, limbo_data])
        arr_p = torch.cat([in_lp, in_rp, torch.where(limbo_keep, limbo_pid, -1)])
        arr_tgt = torch.where(arr_p >= 0,
                              bin_sid(arr_d[:, _POS], cfg, nsc) - cell_lo, -1)
        arr_valid = (arr_p >= 0) & (arr_tgt >= 0) & (arr_tgt < k_loc)
        order_b, dst_b, can_b = _assign_slots(pid2, arr_tgt, arr_valid, k_loc,
                                              cap)
        data2 = _set_drop(data2, dst_b, arr_d[order_b])
        pid2 = _set_drop(pid2, dst_b, torch.where(can_b, arr_p[order_b], -1))

        # new limbo: unplaced arrivals, out-of-slab leftovers included
        left_p = torch.where(can_b, -1, arr_p[order_b])
        left_d = arr_d[order_b]
        n_left = left_p.shape[0]
        li2 = masked_indices(left_p >= 0, limbocap, fill_value=n_left)
        l_ok2 = li2 < n_left
        lis = torch.clamp(li2, max=n_left - 1)
        limbo_data2 = torch.where(l_ok2[:, None], left_d[lis],
                                  torch.zeros((), device=dev))
        limbo_pid2 = torch.where(l_ok2, left_p[lis], -1)
        n_limbo = (limbo_pid2 >= 0).sum()
        lost_inc = torch.clamp((left_p >= 0).sum() - n_limbo, min=0)
        if ocap:
            lt2 = torch.where(limbo_pid2 >= 0,
                              bin_sid(limbo_data2[:, _POS], cfg, nsc) - cell_lo,
                              -1)
            mis_lim = torch.where((lt2 >= 0) & (lt2 < k_loc), s_loc + lim_iota,
                                  sent)
            cand = torch.cat([mis_slot, mis_lim])
            cl = cand.shape[0]
            ci = masked_indices(cand < sent, ocap, fill_value=cl)
            mis2 = torch.where(ci < cl, cand[torch.clamp(ci, max=cl - 1)], sent)
        else:
            mis2 = torch.zeros((0,), dtype=torch.int64, device=dev)
        return (data2, pid2, limbo_data2, limbo_pid2, n_ship, n_limbo,
                lost_inc, mis2)

    def body(carry):
        (data, pid, limbo_data, limbo_pid, mis, mx_mov, mx_mask, mx_limbo,
         lost, shipped) = carry
        if not move_only:
            aligned = (pid >= 0) & (bin_sid(data[:, _POS], cfg, nsc)
                                    == cell_of_slot)
            r2 = torch.where(aligned, r2v, -1.0)
            data, limbo_data = integrate(data, limbo_data, mis, r2)

        sid_new = bin_sid(data[:, _POS], cfg, nsc)
        moved = (pid >= 0) & (sid_new != cell_of_slot)
        n_mov = moved.sum()
        tgt_l = torch.where(limbo_pid >= 0,
                            bin_sid(limbo_data[:, _POS], cfg, nsc), k_glob)
        (data, pid, limbo_data, limbo_pid, n_ship, n_limbo, lost_inc,
         mis) = move_phase(data, pid, limbo_data, limbo_pid, sid_new, moved,
                           tgt_l)
        n_mask = ((pid >= 0) & (bin_sid(data[:, _POS], cfg, nsc)
                                != cell_of_slot)).sum()
        if ocap:
            # served rows are exact: count only the unserved ones
            n_mask = n_mask - (mis < s_loc).sum()
            n_limbo = n_limbo - ((mis >= s_loc) & (mis < sent)).sum()
        return (data, pid, limbo_data, limbo_pid, mis,
                torch.maximum(mx_mov, n_mov), torch.maximum(mx_mask, n_mask),
                torch.maximum(mx_limbo, n_limbo), lost + lost_inc,
                shipped + n_ship)

    return body


def _window(data, pid, limbo_data, limbo_pid, cfg, dt, num_steps: int,
            g: _Geom, mesh: Mesh, lost0=None, move_only: bool = False):
    """``num_steps`` step bodies on this rank's carry. Returns the rows and
    the local (unreduced) diagnostics (max_movers, max_masked, max_limbo,
    lost, shipped)."""
    if pid.shape[0] != g.s_loc or limbo_pid.shape[0] != g.limbocap:
        raise ValueError(f"carry of {pid.shape[0]} slots / "
                         f"{limbo_pid.shape[0]} limbo rows does not fit the "
                         f"geometry ({g.s_loc} / {g.limbocap})")
    body = _make_step_body(cfg, dt, g, mesh, move_only=move_only)
    z = torch.zeros((), dtype=torch.int64, device=pid.device)
    carry = (data, pid, limbo_data, limbo_pid,
             _initial_worklist(data, pid, limbo_data, limbo_pid, cfg, g,
                               mesh.rank),
             z, z, z, z if lost0 is None else lost0, z)
    for _ in range(num_steps):
        carry = body(carry)
    data, pid, limbo_data, limbo_pid, _, mx_mov, mx_mask, mx_limbo, lost, \
        shipped = carry
    return data, pid, limbo_data, limbo_pid, (mx_mov, mx_mask, mx_limbo,
                                              lost, shipped)


def _reduce_diag(mesh: Mesh, mx_mov, mx_mask, mx_limbo, lost, shipped):
    """(max_movers, max_masked, max_limbo) maxima and (lost, shipped)
    totals over the mesh, as 0-dim tensors: two collectives."""
    mx = mesh.pmax(torch.stack([mx_mov, mx_mask, mx_limbo]))
    tot = mesh.psum(torch.stack([lost, shipped]))
    return mx[0], mx[1], mx[2], tot[0], tot[1]


def _gather_state(data, pid, limbo_data, limbo_pid, state: ParticleState,
                  mesh: Mesh) -> ParticleState:
    """Every rank's slab rows, back in particle order on every rank;
    particles in no slot and no limbo keep their values from ``state``."""
    n = state.n
    data_all = mesh.all_gather(data[:, :9].contiguous())
    pid_all = mesh.all_gather(pid)
    ld_all = mesh.all_gather(limbo_data[:, :9].contiguous())
    lp_all = mesh.all_gather(limbo_pid)
    base = torch.cat([state.positions.float(), state.velocities.float(),
                      state.accel.float()], 1)
    for rows, ids in ((data_all, pid_all), (ld_all, lp_all)):
        base = _set_drop(base, torch.where(ids >= 0, ids, n), rows)
    return state.replace(positions=base[:, _POS], velocities=base[:, _VEL],
                         accel=base[:, _ACC])


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def sharded_dense_simulate(state: ParticleState, cfg: SimConfig, dt,
                           num_steps: int, mesh: Mesh, nsc: int | None = None,
                           cap: int | None = None, mcap: int | None = None,
                           migcap: int | None = None,
                           limbocap: int | None = None,
                           ocap: int | None = None):
    """State-sharded exact cell-list trajectory (module docstring). Every
    rank passes the same full ``state`` and gets the full final state back.

    Returns ``(final_state, (max_movers, max_masked, max_limbo, lost,
    shipped_total))``, reduced over the mesh. ``max_masked``/``max_limbo``
    count only rows the overflow sidecar could not serve (``ocap`` is the
    per-rank budget, default ``cfg.overflow_capacity`` or
    ``celllist_dense.OCAP``; 0 disables the sidecar)."""
    g = _geometry(cfg, mesh, state.n, nsc, cap, mcap, migcap, limbocap, ocap)
    data, pid, ld, lp, lost0 = _local_build(state, cfg, g, mesh.rank)
    data, pid, ld, lp, diag = _window(data, pid, ld, lp, cfg, dt, num_steps,
                                      g, mesh, lost0=lost0)
    out = _gather_state(data, pid, ld, lp, state, mesh)
    return out, _reduce_diag(mesh, *diag)


def build_sharded_dense(state: ParticleState, cfg: SimConfig, mesh: Mesh,
                        nsc: int | None = None, cap: int | None = None,
                        mcap: int | None = None, migcap: int | None = None,
                        limbocap: int | None = None):
    """This rank's carry ``(data, pid, limbo_data, limbo_pid, lost)`` from
    a full state that every rank holds (``lost`` summed over the mesh)."""
    g = _geometry(cfg, mesh, state.n, nsc, cap, mcap, migcap, limbocap)
    data, pid, ld, lp, lost0 = _local_build(state, cfg, g, mesh.rank)
    return data, pid, ld, lp, mesh.psum(lost0)


def init_sharded_dense(seed: int, n: int, cfg: SimConfig, mesh: Mesh,
                       nsc: int | None = None, cap: int | None = None,
                       mcap: int | None = None, migcap: int | None = None,
                       limbocap: int | None = None):
    """A uniform random scene drawn straight into the carry, with no
    replicated stage: each rank draws its share of the n particles (n // D,
    one more on the first n % D ranks) with x inside its own slab, from a
    ``torch.Generator`` on its device seeded from ``(seed, rank)``, and
    builds its layout from that local draw. Equal slab volumes give the
    uniform density of a global draw. Particle ids are globally unique
    (rank offsets). A draw that rounds onto a neighbouring slab's plane is
    moved to the centre of the nearest own plane, so every row lands in its
    slab. Returns the carry, as ``build_sharded_dense``."""
    g = _geometry(cfg, mesh, n, nsc, cap, mcap, migcap, limbocap)
    me, d, dev = mesh.rank, g.d, mesh.device
    counts = balanced_counts(n, d)
    n_loc, off = counts[me], sum(counts[:me])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 1_000_003 + me)
    w = f32(cfg.world_size)
    half = float(w * np.float32(0.5))
    slab_w = float(w / np.float32(d))
    cellw = float(w / np.float32(g.nsc))
    pos = torch.rand((n_loc, 3), generator=gen, device=dev)
    x = (-half + me * slab_w) + pos[:, 0] * slab_w
    plane = torch.clamp(torch.floor(F.tdiv(x + half, cellw)).to(torch.int64),
                        0, g.nsc - 1)
    own = torch.clamp(plane, me * g.planes_local, (me + 1) * g.planes_local - 1)
    x = torch.where(plane == own, x, (own.float() + 0.5) * cellw - half)
    pos = torch.cat([x[:, None], pos[:, 1:] * float(w) - half], 1)
    species = torch.randint(0, cfg.id_count, (n_loc,), generator=gen,
                            device=dev)
    zeros = torch.zeros((n_loc, 3), device=dev)
    st = ParticleState(pos, zeros, species, torch.ones(n_loc, device=dev),
                       zeros)
    data, pid, ld, lp, lost0 = _local_build(st, cfg, g, me)
    pid = torch.where(pid >= 0, pid + off, pid)
    lp = torch.where(lp >= 0, lp + off, lp)
    return data, pid, ld, lp, mesh.psum(lost0)


def sharded_dense_steps(carry, cfg: SimConfig, dt, num_steps: int, mesh: Mesh,
                        nsc: int | None = None, cap: int | None = None,
                        mcap: int | None = None, migcap: int | None = None,
                        n: int | None = None, ocap: int | None = None):
    """Advance this rank's carry by ``num_steps``. Returns ``(carry,
    (max_movers, max_masked, max_limbo, lost, shipped))`` with ``lost`` and
    ``shipped`` counted for this window only; mask/limbo count only rows
    the sidecar could not serve. Pass ``n`` (the true particle count) so the
    mover pipeline gets the static sizes ``sharded_dense_simulate`` uses for
    that N; without it the bound comes from the slot count."""
    data, pid, ld, lp, lost_prev = carry
    n_hint = pid.shape[0] * mesh.size if n is None else n
    g = _geometry(cfg, mesh, n_hint, nsc, cap, mcap, migcap, lp.shape[0], ocap)
    data, pid, ld, lp, diag = _window(data, pid, ld, lp, cfg, dt, num_steps,
                                      g, mesh)
    diag = _reduce_diag(mesh, *diag)
    return (data, pid, ld, lp, lost_prev + diag[3]), diag


def gather_sharded_dense(carry, state: ParticleState, mesh: Mesh) -> ParticleState:
    """The full particle-order state on every rank from the ranks' carries
    (particles never placed keep their values from ``state``)."""
    data, pid, ld, lp, _ = carry
    return _gather_state(data, pid, ld, lp, state, mesh)


def sharded_exact_steps(carry, cfg: SimConfig, dt, num_steps: int, mesh: Mesh,
                        rcap: int):
    """Capacity-free exact window on a stay-sharded carry: the slab
    adaptive driver's terminal rung. Each rank compacts its live rows
    (occupied slots + live limbo) into an ``rcap``-row buffer and runs
    ``num_steps`` of masked ring all-pairs (``ring.ring_forces_masked``),
    so every receiver sees every source with O(rcap) memory per rank. Rows
    keep their slots for the window; ``sharded_relayout`` repairs the
    layout afterwards. ``rcap`` must cover every rank's live rows: the
    returned ``overflow`` (summed over the mesh) must be 0 for the window to
    be exact. Returns ``(carry, overflow)``."""
    from .ring import ring_forces_masked

    data, pid, ld, lp, lost = carry
    s_loc, limbocap = pid.shape[0], lp.shape[0]
    nl = s_loc + limbocap
    dev = pid.device
    live = torch.cat([pid >= 0, lp >= 0])
    idx = masked_indices(live, rcap, fill_value=nl)
    ok = idx < nl
    idxs = torch.clamp(idx, max=nl - 1)
    is_lim = idxs >= s_loc
    rows = torch.where(is_lim[:, None],
                       ld[torch.clamp(idxs - s_loc, 0, limbocap - 1)],
                       data[torch.clamp(idxs, max=s_loc - 1)])
    rows = torch.where(ok[:, None], rows, torch.zeros((), device=dev))
    overflow = live.sum() - ok.sum()
    fu, fv = _feat(data.shape[1])
    u, v = rows[:, fu], rows[:, fv]
    kick = float(F.kick_scale(cfg))

    def accel_fn(positions, st, c):
        return ring_forces_masked(positions, u, v, ok, c, mesh) * kick

    ps = ParticleState(rows[:, _POS], rows[:, _VEL],
                       torch.zeros((rcap,), dtype=torch.int64, device=dev),
                       torch.zeros((rcap,), device=dev), rows[:, _ACC])
    for _ in range(num_steps):
        ps = _step(ps, cfg, dt, accel_fn=accel_fn)
    new9 = torch.cat([ps.positions, ps.velocities, ps.accel], 1)
    slot_dst = torch.where(ok & ~is_lim, idxs, s_loc)
    lim_dst = torch.where(ok & is_lim, idxs - s_loc, limbocap)
    data = torch.cat([_set_drop(data[:, :9], slot_dst, new9), data[:, 9:]], 1)
    ld = torch.cat([_set_drop(ld[:, :9], lim_dst, new9), ld[:, 9:]], 1)
    return (data, pid, ld, lp, lost), mesh.psum(overflow)


def sharded_relayout(carry, cfg: SimConfig, mesh: Mesh, passes: int = 1,
                     nsc: int | None = None, cap: int | None = None,
                     mcap: int | None = None, migcap: int | None = None,
                     n: int | None = None, ocap: int | None = None):
    """Migration-only layout repair: ``passes`` transport passes of the
    step body with forces and integration skipped (positions and
    velocities untouched). Each pass ships every out-of-slab row one ring
    hop toward its slab and retries placement, so ``D // 2 + 1`` passes
    route anything the mover/outbox bounds allow.

    Returns ``(carry, (servable_max, unservable, lost))`` on the final
    layout: the largest per-rank count of rows the sidecar could serve next
    window, the global count of rows still outside their rank's slab, and
    the rows dropped past ``limbocap``. CALLERS MUST CHECK ``lost``
    (``_relayout_guarded`` grows limbo and retries)."""
    data, pid, ld, lp, lost_prev = carry
    n_hint = pid.shape[0] * mesh.size if n is None else n
    g = _geometry(cfg, mesh, n_hint, nsc, cap, mcap, migcap, lp.shape[0], ocap)
    data, pid, ld, lp, diag = _window(data, pid, ld, lp, cfg, 0.0, passes, g,
                                      mesh, move_only=True)
    lost = diag[3]
    cell_lo = mesh.rank * g.k_loc
    cell_of = cell_lo + torch.arange(g.s_loc, device=pid.device) // g.cap
    sid = bin_sid(data[:, _POS], cfg, g.nsc)
    mis_slot = (pid >= 0) & (sid != cell_of)
    in_slab = (sid - cell_lo >= 0) & (sid - cell_lo < g.k_loc)
    lt = torch.where(lp >= 0, bin_sid(ld[:, _POS], cfg, g.nsc) - cell_lo, -1)
    l_live = lp >= 0
    l_in = (lt >= 0) & (lt < g.k_loc)
    servable = (mis_slot & in_slab).sum() + (l_live & l_in).sum()
    unserv = (mis_slot & ~in_slab).sum() + (l_live & ~l_in).sum()
    tot = mesh.psum(torch.stack([unserv, lost]))
    return ((data, pid, ld, lp, lost_prev + tot[1]),
            (mesh.pmax(servable), tot[0], tot[1]))


def recap_sharded_dense(carry, cfg: SimConfig, mesh: Mesh, nsc: int,
                        cap_old: int, cap_new: int,
                        limbocap_new: int | None = None):
    """Grow this rank's carry from ``cap_old`` to ``cap_new`` slots a cell
    in place of a rebuild: every cell's slot block is padded with empty
    slots and its occupants keep theirs. The limbo grows to
    ``limbocap_new`` rows when that is larger. Limbo rows whose cell is in
    this rank's slab are then drained into free slots (the step's
    placement rule): left in limbo they would get no pair forces beyond the
    sidecar's budget, the inexactness the caller grew the capacity to end.
    Limbo rows of other slabs stay and ship with the next step. Collective-
    free. Raises for ``cap_new < cap_old``."""
    if cap_new < cap_old:
        raise ValueError("recap only grows: cap_new >= cap_old")
    data, pid, ld, lp, lost = carry
    k_loc = pid.shape[0] // cap_old
    if cap_new > cap_old:
        c, pad = data.shape[1], cap_new - cap_old
        data = torch.cat([data.reshape(k_loc, cap_old, c),
                          data.new_zeros((k_loc, pad, c))], 1).reshape(-1, c)
        pid = torch.cat([pid.reshape(k_loc, cap_old),
                         pid.new_full((k_loc, pad), -1)], 1).reshape(-1)
    grow = (0 if limbocap_new is None else limbocap_new) - lp.shape[0]
    if grow > 0:
        ld = torch.cat([ld, ld.new_zeros((grow, ld.shape[1]))])
        lp = torch.cat([lp, lp.new_full((grow,), -1)])
    cell_lo = mesh.rank * k_loc
    tgt = torch.where(lp >= 0, bin_sid(ld[:, _POS], cfg, nsc) - cell_lo, -1)
    valid = (lp >= 0) & (tgt >= 0) & (tgt < k_loc)
    order, dst, can = _assign_slots(pid, tgt, valid, k_loc, cap_new)
    data = _set_drop(data, dst, ld[order])
    pid = _set_drop(pid, dst, torch.where(can, lp[order], -1))
    return data, pid, ld[order], torch.where(can, -1, lp[order]), lost


def _relayout_guarded(carry, cfg: SimConfig, mesh: Mesh, *, nsc: int, cap: int,
                      mcap: int | None, ocap: int, n: int, verbose=None,
                      migcap: int | None = None):
    """Transport-only layout repair that never loses rows: a relayout whose
    limbo overflows is discarded, limbo grows 4x on the pre-relayout carry
    (still intact: the step functions never write their inputs) and it
    retries. Terminates: a per-rank limbo of n rows holds every row.
    Returns ``(carry, servable_max, unservable)`` with lost == 0."""
    while True:
        new_c, (servable, unserv, lost) = sharded_relayout(
            carry, cfg.replace(cell_capacity=cap), mesh,
            passes=mesh.size // 2 + 1, nsc=nsc, cap=cap, mcap=mcap,
            migcap=migcap, n=n, ocap=ocap)
        if int(lost) == 0:
            return new_c, int(servable), int(unserv)
        lc = carry[3].shape[0]
        if lc >= n:
            raise RuntimeError(f"relayout lost {int(lost)} rows at limbocap="
                               f"{lc} >= n={n}: the carry is corrupt")
        if verbose:
            verbose(f"[slab] relayout overflowed limbo ({int(lost)} rows "
                    f"would be lost): rewinding transport, limbocap={4 * lc}")
        carry = recap_sharded_dense(carry, cfg, mesh, nsc, cap, cap,
                                    limbocap_new=4 * lc)


LADDER_ENDS = ("exact", "exact_replicated", "warn", "raise")


def sharded_dense_adaptive(carry, cfg: SimConfig, dt, num_steps: int,
                           mesh: Mesh, n: int, nsc: int | None = None,
                           cap: int | None = None, mcap: int | None = None,
                           window: int = 64, max_cap: int = 512,
                           verbose=None, on_ladder_end: str = "exact",
                           state: ParticleState | None = None,
                           ocap: int | None = None,
                           migcap: int | None = None):
    """Capacity-adaptive stay-sharded driver: the slab counterpart of
    ``engine.step.simulate_dense_adaptive``. Every rank calls it with its
    own carry; the decisions come from diagnostics reduced over the mesh,
    so all ranks take the same branch.

    Runs ``window``-step chunks of ``sharded_dense_steps``. A window whose
    diagnostics report trouble is rewound (the step functions never write
    their inputs, so the pre-window carry is still live) and run again
    after the bound at fault grows:

      * movers past ``mcap``: ``mcap`` doubles;
      * rows lost past the limbo: the limbo grows 4x (``recap``);
      * masked or unserved limbo rows: the cell capacity doubles, up to
        ``max_cap`` (K1 takes any capacity; the JAX package's alignment and
        VMEM ladder is not ported), and the carry is recapped in place.

    When the ladder ends, or six rewinds in a row at one step leave
    trouble, ``on_ladder_end`` decides:

      * ``"exact"``: the window is rewound and served on the capacity-free
        ring all-pairs rung, stay-sharded (``sharded_exact_steps``, K3 on
        the card, O(N/D) rows a rank). After each exact window a
        transport-only relayout (``sharded_relayout``, guarded against
        loss) repairs the slots, and the grid path resumes once every row
        is in its slab and the misplaced rows fit the sidecar (``ocap``).
      * ``"exact_replicated"`` (needs ``state``, the particle-order
        template of species and masses): the window runs on the gathered
        state with ``engine.step.simulate_culled`` (K4 on the card), and a
        clean ``build_sharded_dense`` at the current capacity resumes the
        grid path. Without ``state`` it acts as ``"warn"``.
      * ``"warn"``: the window is committed with its unserved rows
        (``warnings.warn`` and ``verbose``); they get no pair forces for
        those steps, never wrong ones, and are never lost.
      * ``"raise"``: ``RuntimeError``.

    The host reads a few reduced scalars once a window, never inside a
    step. Returns ``(carry, cap, history)``; history lists ``(steps, cap,
    unserved)`` per committed window, ``cap`` the string ``"exact"`` for
    windows of a terminal rung (unserved always 0 there)."""
    import warnings

    from ..engine.step import simulate_culled

    if on_ladder_end not in LADDER_ENDS:
        raise ValueError(f"on_ladder_end must be one of {LADDER_ENDS}, got "
                         f"{on_ladder_end!r}")
    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None or cap is None:
        raise ValueError("sharded_dense_adaptive needs cfg.cell_grid / "
                         "cfg.cell_capacity")
    d = mesh.size
    if mcap is None:
        mcap = max(512, -(-max(n // (8 * d), 1) // 128) * 128)
    if ocap is None:
        ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity
    if nsc < 3:
        ocap = 0
    say = verbose or (lambda msg: None)
    replicated = on_ladder_end == "exact_replicated"
    exact_ok = on_ladder_end == "exact" or (replicated and state is not None)
    done = 0
    history = []
    ladder_ended = False
    exact_mode = False
    live = None  # the gathered particle-order state of the replicated rung

    def next_cap(c):
        return min(2 * c, max_cap) if c < max_cap else None

    def rcap_for(c):
        """Rows of the exact rung's compaction buffer: every rank's live
        rows (no row migrates inside an exact window), rounded up to a
        power of two, the same on every rank."""
        mine = (c[1] >= 0).sum() + (c[3] >= 0).sum()
        mx = int(mesh.pmax(mine.reshape(1))[0])
        nl = c[1].shape[0] + c[3].shape[0]
        return min(nl, max(256, 1 << (max(mx, 1) - 1).bit_length()))

    def relayout(c):
        return _relayout_guarded(c, cfg, mesh, nsc=nsc, cap=cap, mcap=mcap,
                                 ocap=ocap, n=n, verbose=verbose,
                                 migcap=migcap)

    def build(st, limbocap=None):
        return build_sharded_dense(st, cfg.replace(cell_capacity=cap), mesh,
                                   nsc=nsc, cap=cap, mcap=mcap, migcap=migcap,
                                   limbocap=limbocap)

    def run_exact_window(k):
        nonlocal carry, live
        if replicated:
            live, _ = simulate_culled(live, cfg, dt, k, window=min(k, 16))
            return
        carry, overflow = sharded_exact_steps(carry, cfg, dt, k, mesh,
                                              rcap=rcap_for(carry))
        if int(overflow):  # rcap covers every rank's live rows
            raise RuntimeError(f"exact rung: {int(overflow)} rows past rcap")

    def try_reenter_slab():
        nonlocal carry, exact_mode, live
        if not replicated:
            carry, servable, unserv = relayout(carry)
            if unserv == 0 and servable <= ocap:
                exact_mode = False
                say(f"[slab-adaptive] layout repaired (overflow {servable}/"
                    f"rank <= ocap={ocap}): re-entering the slab path at "
                    f"cap={cap}")
            return
        new = build(live)
        limbo_n, lost = (int(x) for x in torch.stack(
            [mesh.psum((new[3] >= 0).sum()), new[4]]).tolist())
        if limbo_n == 0 and lost == 0:
            carry, exact_mode, live = new, False, None
            say(f"[slab-adaptive] scene fits cap={cap} again: re-entering "
                f"the slab path")

    def enter_exact(prev, why):
        nonlocal carry, exact_mode, live
        exact_mode = True
        if replicated:
            live = gather_sharded_dense(prev, state, mesh)
            say(f"{why}: rewinding the window, serving exact windows on the "
                f"gathered state (simulate_culled) until the scene fits "
                f"again")
            return
        carry = prev
        say(f"{why}: rewinding the window, serving exact windows "
            f"stay-sharded on the ring all-pairs rung; a relayout re-probes "
            f"the slab path after each")

    def pre_unserved(c):
        """Limbo rows of a fresh carry past the sidecar's budget, summed
        over the mesh: they would be force-frozen before the first step's
        placement pass drains them."""
        return int(mesh.psum(torch.clamp((c[3] >= 0).sum() - ocap, min=0)))

    excess = pre_unserved(carry)
    while excess > 0:
        new_cap = next_cap(cap)
        if new_cap is None:
            ladder_ended = True
            msg = (f"[slab-adaptive] {excess} initial-build rows in limbo "
                   f"beyond the sidecar budget (ocap={ocap}/rank) and the "
                   f"ladder ended at cap={cap}")
            if on_ladder_end == "raise":
                raise RuntimeError(msg)
            if exact_ok:
                enter_exact(carry, msg)
            else:
                say(msg)
            break
        say(f"[slab-adaptive] draining {excess} initial-build limbo rows "
            f"beyond the sidecar budget: cap={cap} -> {new_cap}")
        carry = recap_sharded_dense(carry, cfg, mesh, nsc, cap, new_cap)
        cap = new_cap
        excess = pre_unserved(carry)

    rewinds_here = 0  # consecutive rewinds at the same step (loop guard)
    while done < num_steps:
        k = min(window, num_steps - done)
        if exact_mode:
            run_exact_window(k)
            done += k
            history.append((k, "exact", 0))
            if done < num_steps:
                try_reenter_slab()
            continue
        prev = carry
        carry, diag = sharded_dense_steps(
            carry, cfg.replace(cell_capacity=cap), dt, k, mesh, nsc=nsc,
            cap=cap, mcap=mcap, migcap=migcap, n=n, ocap=ocap)
        mov, mask, limbo, lost, _ = (int(x) for x in
                                     torch.stack(diag).tolist())
        trouble = mask + limbo  # both are rows without their pair forces
        if mov > mcap and rewinds_here < 6:
            mcap = -(-(2 * mov) // 128) * 128
            say(f"[slab-adaptive] step {done}: {mov} movers > mover cap: "
                f"rewinding the window, mcap={mcap}")
            carry = prev
            rewinds_here += 1
            continue
        if lost > 0 and rewinds_here < 6:
            lc = prev[3].shape[0]
            say(f"[slab-adaptive] step {done}: {lost} rows lost past limbo: "
                f"rewinding the window, limbocap={4 * lc}")
            carry = recap_sharded_dense(prev, cfg, mesh, nsc, cap, cap,
                                        limbocap_new=4 * lc)
            rewinds_here += 1
            continue
        if trouble > 0 and not ladder_ended and rewinds_here < 6:
            new_cap = next_cap(cap)
            if new_cap is not None:
                say(f"[slab-adaptive] step {done}: {mask} masked + {limbo} "
                    f"limbo at cap={cap}: rewinding the window, "
                    f"cap={new_cap}")
                carry = recap_sharded_dense(prev, cfg, mesh, nsc, cap,
                                            new_cap)
                cap = new_cap
                rewinds_here += 1
                continue
            ladder_ended = True
        if trouble > 0:
            msg = (f"[slab-adaptive] step {done}: {mask} masked + {limbo} "
                   f"limbo at cap={cap} with no larger capacity (cell_grid="
                   f"{nsc}, " + ("ladder ended" if ladder_ended
                                 else "rewind guard exhausted") + ")")
            if on_ladder_end == "raise":
                raise RuntimeError(msg)
            if exact_ok:
                enter_exact(prev, msg)
                continue
            msg += (": committing the window; the unserved rows get no pair "
                    "forces for these steps, and none is lost")
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            say(msg)
        done += k
        rewinds_here = 0
        history.append((k, cap, trouble))
    if exact_mode and replicated:
        # the trajectory lives in the gathered state: build a carry of it,
        # growing the limbo until the build loses nothing (the scene may
        # still be denser than cap)
        lc = carry[3].shape[0]
        while True:
            new = build(live, limbocap=lc)
            if int(new[4]) == 0:
                break
            lc *= 4
        carry = new
    elif exact_mode:
        # the carry is the state: one last loss-guarded relayout tidies
        # the slots for whoever reads it next
        carry, _, _ = relayout(carry)
    return carry, cap, history
