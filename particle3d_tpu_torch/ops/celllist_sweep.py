"""Column-sweep cell-list forces: the K1 kernel's wrapper, its plain torch
version, and the column layout it reads (port of
``particle3d_tpu.ops.pallas_celllist``).

Particles are binned into an ``nsc^3`` supercell grid (cell width >= the
cutoff) and stored column-major: one z-column of supercells per (x, y),
``cap`` slots per supercell, so each column's slots are contiguous and
z-minor. Each column carries one ghost supercell at each z end (shifted
copies for periodic boxes, masked padding otherwise), so every receiver
supercell's 3-supercell source window is one contiguous slice of each of
its 9 (x, y)-neighbour columns. Operand shapes are those of the JAX
package's ``_call`` (slot-minor ``[NCOL, 3|P|1, CS|G]``).

``column_sweep_forces`` launches the hand-written CUDA kernel
(``csrc/celllist_sweep.cu``) for CUDA tensors and computes the plain
version ``column_sweep_forces_ref`` for CPU tensors. The CUDA path has no
fallback: it launches or raises. ``KERNEL_LAUNCHES`` counts launches.

Not ported here: ``halo=True`` (the slab decomposition's mode), the
cadenced ``CellLayout`` half, and the Mosaic VMEM/alignment model
(``_pick_zr``, ``kernel_vmem_bytes``, ``max_feasible_cap``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import SimConfig, f32
from . import forces as F
from .params import LAW_IDS, PAIR_P, PF_W, gated_scale, pack_params, r2_gate

# (dx, dy) neighbour order, as the JAX package's _OFFSETS9 and the kernel
OFFSETS9 = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]

KERNEL_LAUNCHES = 0

_LIB = ("celllist_sweep", ("celllist_sweep.cu", "pair_law.cuh"))
# largest temporary of the plain version, in elements (blocks of columns)
_REF_MAX_ELEMS = 1 << 24


def _library():
    from ..utils.cuda_build import load_library

    lib = load_library(*_LIB)
    fn = lib.p3t_column_sweep
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_kernel():
    """Build (or find) and load the K1 library; returns nvcc's log."""
    from ..utils.cuda_build import build_log

    _library()
    return build_log(*_LIB)


def _check_operands(pos_d, u_d, post_g, vt_g, r2_g, wrap, nsc, cap):
    ncol, cs, g = nsc * nsc, nsc * cap, (nsc + 2) * cap
    nsrc = ncol if wrap else ncol + 1
    want = {"pos_d": (pos_d, (ncol, 3, cs)), "u_d": (u_d, (ncol, PAIR_P, cs)),
            "post_g": (post_g, (nsrc, 3, g)), "vt_g": (vt_g, (nsrc, PAIR_P, g)),
            "r2_g": (r2_g, (nsrc, 1, g))}
    for name, (t, shape) in want.items():
        if t.device != pos_d.device:
            raise ValueError(f"{name} is on {t.device}, pos_d on {pos_d.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want float32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nsc < 3:
        raise ValueError(f"the column sweep needs nsc >= 3 (got {nsc}): a "
                         f"3-supercell window must never hold a supercell "
                         f"and its own wrap-ghost copy")


def column_sweep_forces(pos_d, u_d, post_g, vt_g, r2_g, params, law: str,
                        wrap: bool, nsc: int, cap: int, halo: bool = False):
    """K1: f32[NCOL, 3, CS] forces on every slot (garbage on empty slots).

    ``params`` is the host-side f32[14] vector of ``pack_params``."""
    global KERNEL_LAUNCHES
    if halo:
        raise NotImplementedError(
            "column sweep halo=True (slab decomposition) is not ported yet: "
            "ROADMAP.md queue 1, 'K1 halo mode and scale-out'")
    _check_operands(pos_d, u_d, post_g, vt_g, r2_g, wrap, nsc, cap)
    if pos_d.device.type == "cpu":
        return column_sweep_forces_ref(pos_d, u_d, post_g, vt_g, r2_g, params,
                                       law, wrap, nsc, cap)
    if pos_d.device.type != "cuda":
        raise ValueError(f"no column-sweep kernel for device {pos_d.device}")
    pf = np.ascontiguousarray(np.asarray(params, np.float32))
    if pf.shape != (14,):
        raise ValueError(f"params must be f32[14], got {pf.shape}")
    fn = _library()
    out = torch.empty((nsc * nsc, 3, nsc * cap), dtype=torch.float32,
                      device=pos_d.device)
    with torch.cuda.device(pos_d.device):
        stream = torch.cuda.current_stream(pos_d.device).cuda_stream
        err = fn(pos_d.data_ptr(), u_d.data_ptr(), post_g.data_ptr(),
                 vt_g.data_ptr(), r2_g.data_ptr(),
                 pf.ctypes.data_as(ctypes.c_void_p), out.data_ptr(),
                 LAW_IDS[law], int(bool(wrap)), nsc, cap, stream)
    if err != 0:
        raise RuntimeError(f"column-sweep kernel launch failed: CUDA error "
                           f"{err} (nsc={nsc}, cap={cap})")
    KERNEL_LAUNCHES += 1
    return out


def _neighbour_columns(nsc: int, wrap: bool, dummy: int, w, device):
    """[NCOL, 9] source column per neighbour and its x / y image shifts."""
    c = torch.arange(nsc * nsc, device=device)
    dx = torch.tensor([o[0] for o in OFFSETS9], device=device)
    dy = torch.tensor([o[1] for o in OFFSETS9], device=device)
    nx = (c // nsc)[:, None] + dx[None]
    ny = (c % nsc)[:, None] + dy[None]
    if wrap:
        def shift(k):
            z = torch.zeros(k.shape, dtype=torch.float32, device=device)
            return torch.where(k < 0, z - w, torch.where(k >= nsc, z + w, z))

        return (nx % nsc) * nsc + ny % nsc, shift(nx), shift(ny)
    ok = (nx >= 0) & (nx < nsc) & (ny >= 0) & (ny < nsc)
    zero = torch.zeros(nx.shape, dtype=torch.float32, device=device)
    return torch.where(ok, nx * nsc + ny, dummy), zero, zero


def column_sweep_forces_ref(pos_d, u_d, post_g, vt_g, r2_g, params, law: str,
                            wrap: bool, nsc: int, cap: int):
    """Plain torch K1 with the same operands and the same 3-supercell
    windows, blocked over columns so that no temporary exceeds
    ``_REF_MAX_ELEMS`` elements (one unblocked gather at 262k would take
    ~18 GB). Walled boxes read the masked dummy column, as the TPU kernel
    does."""
    ncol, cs = nsc * nsc, nsc * cap
    p = u_d.shape[1]
    dev = pos_d.device
    w = float(params[PF_W])
    nbr, shx, shy = _neighbour_columns(nsc, wrap, post_g.shape[0] - 1, w, dev)
    # ghosted rows of receiver supercell zc's window: [zc*cap, (zc+3)*cap)
    win = (torch.arange(nsc, device=dev)[:, None] * cap
           + torch.arange(3 * cap, device=dev)[None])
    k = 27 * cap
    out = torch.empty((ncol, 3, cs), dtype=torch.float32, device=dev)
    blk = max(1, _REF_MAX_ELEMS // (cs * k))
    for c0 in range(0, ncol, blk):
        c1 = min(ncol, c0 + blk)
        b = c1 - c0
        cols = nbr[c0:c1]                               # [b, 9]

        def window(a):  # [NSRC, ch, G] -> [b, nsc, ch, 27*cap]
            t = a[cols][..., win]                       # [b, 9, ch, nsc, 3cap]
            return t.permute(0, 3, 2, 1, 4).reshape(b, nsc, a.shape[1], k)

        src = window(post_g)
        sx = (src[:, :, 0].reshape(b, nsc, 9, 3 * cap)
              + shx[c0:c1, None, :, None]).reshape(b, nsc, k)
        sy = (src[:, :, 1].reshape(b, nsc, 9, 3 * cap)
              + shy[c0:c1, None, :, None]).reshape(b, nsc, k)
        sz = src[:, :, 2]
        vj = window(vt_g)                               # [b, nsc, P, k]
        r2j = window(r2_g)[:, :, 0]                     # [b, nsc, k]
        rec = pos_d[c0:c1].reshape(b, 3, nsc, cap)
        ui = u_d[c0:c1].reshape(b, p, nsc, cap).permute(0, 2, 3, 1)
        dx = sx[:, :, None, :] - rec[:, 0, :, :, None]  # [b, nsc, cap, k]
        dy = sy[:, :, None, :] - rec[:, 1, :, :, None]
        dz = sz[:, :, None, :] - rec[:, 2, :, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        in_r = d2 < r2j[:, :, None, :]
        coef = F.pair_coef(ui, vj.transpose(-1, -2))
        s = gated_scale(law, d2, in_r, coef, params)
        out[c0:c1] = torch.stack(
            [(dx * s).sum(-1), (dy * s).sum(-1), (dz * s).sum(-1)],
            dim=1).reshape(b, 3, cs)
    return out


def fold_to_cells(pos_r, w, nsc: int, cap: int):
    """Fold each slot's coordinates [NCOL, CS, 3] into the periodic image
    nearest its cell centre, so a wrap-crosser sits next to its cell again
    (unmoved occupants fold by exactly 0)."""
    ncol, cs = pos_r.shape[0], pos_r.shape[1]
    dev = pos_r.device
    w = f32(w)
    cellw = w / np.float32(nsc)
    half_w = float(np.float32(0.5) * w)
    col = torch.arange(ncol, device=dev)
    ctr_x = ((col // nsc).to(torch.float32) + 0.5) * float(cellw) - half_w
    ctr_y = ((col % nsc).to(torch.float32) + 0.5) * float(cellw) - half_w
    zc = torch.arange(cs, device=dev) // cap
    ctr_z = (zc.to(torch.float32) + 0.5) * float(cellw) - half_w
    ctr = torch.stack([ctr_x[:, None].expand(ncol, cs),
                       ctr_y[:, None].expand(ncol, cs),
                       ctr_z[None, :].expand(ncol, cs)], dim=-1)
    return pos_r - float(w) * torch.round(F.tdiv(pos_r - ctr, w))


def ghost_columns(pos_r, v_r, r2_r, cfg: SimConfig, cap: int):
    """Slot-major column arrays pos_r [NCOL, CS, 3], v_r [NCOL, CS, P],
    r2_r [NCOL, CS] -> ghosted slot-minor (post_g, vt_g, r2_g). Periodic:
    the z ghosts are +-w-shifted copies of the far end. Walled: masked
    padding, plus the fully masked dummy column appended last."""
    ncol, cs = pos_r.shape[0], pos_r.shape[1]
    dev = pos_r.device
    if cfg.wrap_forces:
        zs = torch.zeros(3, dtype=torch.float32, device=dev)
        zs[2] = float(f32(cfg.world_size))
        pos_g = torch.cat([pos_r[:, cs - cap:] - zs, pos_r, pos_r[:, :cap] + zs], 1)
        v_g = torch.cat([v_r[:, cs - cap:], v_r, v_r[:, :cap]], 1)
        r2_gh = torch.cat([r2_r[:, cs - cap:], r2_r, r2_r[:, :cap]], 1)
    else:
        g = cs + 2 * cap
        pos_g = torch.zeros((ncol + 1, g, 3), dtype=torch.float32, device=dev)
        v_g = torch.zeros((ncol + 1, g, v_r.shape[2]), dtype=torch.float32,
                          device=dev)
        r2_gh = torch.full((ncol + 1, g), -1.0, dtype=torch.float32, device=dev)
        pos_g[:ncol, cap:cap + cs] = pos_r
        v_g[:ncol, cap:cap + cs] = v_r
        r2_gh[:ncol, cap:cap + cs] = r2_r
    return (pos_g.permute(0, 2, 1).contiguous(),
            v_g.permute(0, 2, 1).contiguous(),
            r2_gh[:, None, :].contiguous())


def bin_sid(positions, cfg: SimConfig, nsc: int):
    """Supercell id per row: floor((x + w/2) / cellw) clipped per axis."""
    w = f32(cfg.world_size)
    cellw = w / np.float32(nsc)
    shifted = positions + float(w * np.float32(0.5))
    idx3 = torch.clamp(torch.floor(F.tdiv(shifted, cellw)).to(torch.int64),
                       0, nsc - 1)
    return (idx3[:, 0] * nsc + idx3[:, 1]) * nsc + idx3[:, 2]


def prepare_columns(positions, u, v, cfg: SimConfig, nsc: int, cap: int):
    """Bin + stable sort into the ghosted column layout. Returns (pos_d,
    u_d, post_g, vt_g, r2_g, slot_particle [NCOL, CS], -1 for empty);
    particles of cell rank >= cap get no slot."""
    n = positions.shape[0]
    dev = positions.device
    ncol, cs, s_total = nsc * nsc, nsc * cap, nsc ** 3 * cap
    sid = bin_sid(positions, cfg, nsc)
    order = torch.argsort(sid, stable=True)
    sid_s = sid[order]
    starts = torch.searchsorted(sid_s, torch.arange(nsc ** 3, device=dev))
    rank = torch.arange(n, device=dev) - starts[sid_s]
    flat = torch.where(rank < cap, sid_s * cap + rank, s_total)
    slot_particle = torch.full((s_total + 1,), -1, dtype=torch.int64, device=dev)
    slot_particle[flat] = order  # overflow lands on the dropped last row
    slot_particle = slot_particle[:-1]
    present = slot_particle >= 0
    safe = torch.where(present, slot_particle, 0)

    pos_r = positions[safe].reshape(ncol, cs, 3).to(torch.float32)
    u_r = u[safe].reshape(ncol, cs, -1).to(torch.float32)
    v_r = v[safe].reshape(ncol, cs, -1).to(torch.float32)
    r2_r = torch.where(present, float(r2_gate(cfg)), -1.0).reshape(ncol, cs)
    post_g, vt_g, r2_g = ghost_columns(pos_r, v_r, r2_r, cfg, cap)
    return (pos_r.permute(0, 2, 1).contiguous(),
            u_r.permute(0, 2, 1).contiguous(),
            post_g, vt_g, r2_g, slot_particle.reshape(ncol, cs))


def check_cell_width(cfg: SimConfig, nsc: int):
    """Supercells must be at least as wide as the effective cutoff."""
    w = float(f32(cfg.world_size))
    r = float(f32(cfg.particle_effect_radius))
    cutoff = min(r, 1.0) if cfg.force_law == "particle_life" else r
    if w / nsc < cutoff - 1e-6:
        raise ValueError(
            f"cell width {w / nsc:.4f} < effective cutoff {cutoff:.4f}: "
            f"reduce cell_grid (nsc={nsc}) so cells cover the cutoff")


def fresh_celllist_forces(positions, u, v, cfg: SimConfig,
                          nsc: int | None = None, cap: int | None = None):
    """Accumulated pair forces [N, 3] through a fresh column layout and K1:
    the ``celllist_pallas`` backend of ``simulate`` (counterpart of the JAX
    package's ``pallas_celllist_forces``). Capacity-overflow particles get
    exact forces from the overflow sidecar (``ops.overflow``)."""
    from .celllist_dense import OCAP
    from .compaction import index_add_rows, masked_indices
    from .overflow import neighborhood_sweeps

    n = positions.shape[0]
    dev = positions.device
    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None or cap is None:
        raise NotImplementedError(
            "deriving cell_grid / cell_capacity from the config is not "
            "ported yet (ROADMAP.md queue 1, 'all-pairs backends'): set "
            "cfg.cell_grid and cfg.cell_capacity")
    if nsc < 3:
        raise NotImplementedError(
            f"cell_grid={nsc} < 3 needs the XLA-style cell list, not ported "
            f"yet (ROADMAP.md queue 1, 'all-pairs backends')")
    check_cell_width(cfg, nsc)
    if u.shape[1] < PAIR_P:
        u = torch.nn.functional.pad(u, (0, PAIR_P - u.shape[1]))
        v = torch.nn.functional.pad(v, (0, PAIR_P - v.shape[1]))

    pos_d, u_d, post_g, vt_g, r2_g, slot_particle = prepare_columns(
        positions, u, v, cfg, nsc, cap)
    forces_d = column_sweep_forces(pos_d, u_d, post_g, vt_g, r2_g,
                                   pack_params(cfg), cfg.force_law,
                                   bool(cfg.wrap_forces), nsc, cap)
    slot = slot_particle.reshape(-1)
    slotf = forces_d.permute(0, 2, 1).reshape(-1, 3)
    out = torch.zeros((n, 3), dtype=positions.dtype, device=dev)

    ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity
    if ocap:
        s_tot = slot.shape[0]
        inv = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
        inv[torch.where(slot >= 0, slot, n)] = torch.arange(s_tot, device=dev)
        mis_p = masked_indices(inv[:n] < 0, ocap, fill_value=n)
        safe = torch.where(slot >= 0, slot, 0)
        mp = torch.clamp(mis_p, max=n - 1)
        f_mis, f_from = neighborhood_sweeps(
            positions[safe].float(), u[safe].float(), v[safe].float(), slot >= 0,
            positions[mp].float(), u[mp].float(), v[mp].float(), mis_p < n,
            cfg, nsc, cap)
        out = index_add_rows(out, mp, f_mis.to(out.dtype), mis_p < n)
        slotf = slotf + f_from.to(slotf.dtype)
    return index_add_rows(out, torch.clamp(slot, min=0), slotf, slot >= 0)
