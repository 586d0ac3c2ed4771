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
package's ``_call`` (slot-minor ``[NCOL, 3|P|1, CS|G]``, P = 8 or 16).

``halo=True`` is the slab decomposition's mode (``parallel.domain_sharded``):
the receivers are whole x-planes of one slab and the sources carry one
halo plane at each x end, so the x neighbour is a local plane offset that
never wraps; y wraps (or hits the walled dummy column) as without the halo.

``column_sweep_forces`` launches the hand-written CUDA kernel
(``csrc/celllist_sweep.cu``) for CUDA tensors and computes the plain
version ``column_sweep_forces_ref`` for CPU tensors. Both return exactly 0
on every receiver slot whose own gate is <= 0 (empty, misplaced or dead
slots): the gate ``r2_g[c, 0, cap + slot]`` of its own column ``c``, which
is source column ``c + nsc`` in halo mode. The kernel sweeps live slots
only, so it never evaluates such a row. The CUDA path has no fallback: it
launches or raises. ``KERNEL_LAUNCHES`` counts the launches
without the halo, ``HALO_LAUNCHES`` those in halo mode.

The cadenced half (``CellLayout`` and ``build_layout`` to
``layout_forces``) freezes a binning across steps: between rebuilds only
the positions are regathered and ghosted, and K1 reads the layout's cached
features and gates. Not ported: the Mosaic VMEM/alignment model
(``_pick_zr``, ``kernel_vmem_bytes``, ``max_feasible_cap``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import SimConfig, f32
from . import forces as F
from .params import (LAW_IDS, PF_W, gated_scale, pack_params, r2_gate,
                     refuse_grad)

# (dx, dy) neighbour order, as the JAX package's _OFFSETS9 and the kernel
OFFSETS9 = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]

KERNEL_LAUNCHES = 0
HALO_LAUNCHES = 0
KERNEL_WIDTHS = (8, 16)  # feature widths the kernel is built for

_LIB = ("celllist_sweep", ("celllist_sweep.cu", "pair_law.cuh"))
# largest temporary of the plain version, in elements (blocks of columns)
_REF_MAX_ELEMS = 1 << 24


def _library_handle():
    from ..utils.cuda_build import load_library

    lib = load_library(*_LIB)
    lib.p3t_column_sweep_geometry.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.p3t_column_sweep_geometry.restype = None
    return lib


def _library():
    lib = _library_handle()
    fn = lib.p3t_column_sweep
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_geometry(nsc: int, cap: int, ncol: int, p: int) -> dict:
    """The block geometry K1 launches with on the current CUDA device (the
    library's ``p3t_column_sweep_geometry``): receiver supercells a z-block
    ``zr``, blocks a supercell ``nsub``, z-blocks a column ``nzb``, threads
    a block and receivers a thread."""
    lib = _library_handle()
    out = (ctypes.c_int * 5)()
    lib.p3t_column_sweep_geometry(nsc, cap, ncol, p, out)
    return dict(zip(("zr", "nsub", "nzb", "threads", "receivers_per_thread"),
                    out))


def build_kernel():
    """Build (or find) and load the K1 library; returns nvcc's log."""
    from ..utils.cuda_build import build_log

    _library()
    return build_log(*_LIB)


def _check_operands(pos_d, u_d, post_g, vt_g, r2_g, wrap, nsc, cap, halo):
    ncol, cs, g = pos_d.shape[0], nsc * cap, (nsc + 2) * cap
    p = u_d.shape[1] if u_d.dim() == 3 else -1
    if p not in KERNEL_WIDTHS:
        raise ValueError(f"u_d: feature width {p}, K1 takes {KERNEL_WIDTHS} "
                         f"(pad with zero columns, forces.pad_features)")
    if halo:
        if ncol < nsc or ncol % nsc:
            raise ValueError(f"halo receivers: {ncol} columns is not a whole "
                             f"number of planes of {nsc}")
        nsrc = ncol + 2 * nsc
    else:
        ncol = nsc * nsc
        nsrc = ncol
    if not wrap:
        nsrc += 1  # the masked dummy column
    want = {"pos_d": (pos_d, (ncol, 3, cs)), "u_d": (u_d, (ncol, p, cs)),
            "post_g": (post_g, (nsrc, 3, g)), "vt_g": (vt_g, (nsrc, p, g)),
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
    return ncol, p


def column_sweep_forces(pos_d, u_d, post_g, vt_g, r2_g, params, law: str,
                        wrap: bool, nsc: int, cap: int, halo: bool = False):
    """K1: f32[NCOL, 3, CS] forces on every receiver slot whose own gate is
    > 0, exactly 0 on the others. ``halo=False``: NCOL = nsc^2, the whole
    grid. ``halo=True``: NCOL is any whole number of x-planes and the
    sources carry NCOL + 2*nsc columns (module docstring).

    ``params`` is the host-side f32[14] vector of ``pack_params``."""
    global KERNEL_LAUNCHES, HALO_LAUNCHES
    refuse_grad("K1 (column_sweep_forces)", "the celllist_pallas backend",
                pos_d, u_d, post_g, vt_g, r2_g)
    ncol, p = _check_operands(pos_d, u_d, post_g, vt_g, r2_g, wrap, nsc, cap,
                              halo)
    if pos_d.device.type == "cpu":
        return column_sweep_forces_ref(pos_d, u_d, post_g, vt_g, r2_g, params,
                                       law, wrap, nsc, cap, halo=halo)
    if pos_d.device.type != "cuda":
        raise ValueError(f"no column-sweep kernel for device {pos_d.device}")
    pf = np.ascontiguousarray(np.asarray(params, np.float32))
    if pf.shape != (14,):
        raise ValueError(f"params must be f32[14], got {pf.shape}")
    fn = _library()
    out = torch.empty((ncol, 3, nsc * cap), dtype=torch.float32,
                      device=pos_d.device)
    with torch.cuda.device(pos_d.device):
        stream = torch.cuda.current_stream(pos_d.device).cuda_stream
        err = fn(pos_d.data_ptr(), u_d.data_ptr(), post_g.data_ptr(),
                 vt_g.data_ptr(), r2_g.data_ptr(),
                 pf.ctypes.data_as(ctypes.c_void_p), out.data_ptr(),
                 LAW_IDS[law], int(bool(wrap)), int(bool(halo)), nsc, cap,
                 ncol, p, stream)
    if err != 0:
        raise RuntimeError(f"column-sweep kernel launch failed: CUDA error "
                           f"{err} (nsc={nsc}, cap={cap}, ncol={ncol}, "
                           f"halo={halo})")
    if halo:
        HALO_LAUNCHES += 1
    else:
        KERNEL_LAUNCHES += 1
    return out


def _neighbour_columns(ncol: int, nsc: int, wrap: bool, halo: bool,
                       dummy: int, w, device):
    """[NCOL, 9] source column per neighbour and its x / y image shifts.
    In halo mode the x neighbour is the local source plane (the sources
    lead with one halo plane) and never wraps or shifts."""
    c = torch.arange(ncol, device=device)
    dx = torch.tensor([o[0] for o in OFFSETS9], device=device)
    dy = torch.tensor([o[1] for o in OFFSETS9], device=device)
    nx = (c // nsc + (1 if halo else 0))[:, None] + dx[None]
    ny = (c % nsc)[:, None] + dy[None]
    zero = torch.zeros(nx.shape, dtype=torch.float32, device=device)

    def shift(k):
        return torch.where(k < 0, zero - w, torch.where(k >= nsc, zero + w, zero))

    if wrap:
        if halo:
            return nx * nsc + ny % nsc, zero, shift(ny)
        return (nx % nsc) * nsc + ny % nsc, shift(nx), shift(ny)
    ok = (ny >= 0) & (ny < nsc)
    if not halo:
        ok = ok & (nx >= 0) & (nx < nsc)
    return torch.where(ok, nx * nsc + ny, dummy), zero, zero


def column_sweep_forces_ref(pos_d, u_d, post_g, vt_g, r2_g, params, law: str,
                            wrap: bool, nsc: int, cap: int, halo: bool = False):
    """Plain torch K1 with the same operands and the same 3-supercell
    windows, blocked over columns so that no temporary exceeds
    ``_REF_MAX_ELEMS`` elements (one unblocked gather at 262k would take
    ~18 GB). Walled boxes read the masked dummy column, as the TPU kernel
    does. Rows whose own gate is <= 0 are selected to exactly 0, as the
    kernel leaves them."""
    ncol, cs = pos_d.shape[0], nsc * cap
    p = u_d.shape[1]
    dev = pos_d.device
    w = float(params[PF_W])
    nbr, shx, shy = _neighbour_columns(ncol, nsc, wrap, halo,
                                       post_g.shape[0] - 1, w, dev)
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
    own = r2_g[nsc:nsc + ncol] if halo else r2_g[:ncol]
    return torch.where(own[:, :, cap:cap + cs] > 0.0, out, 0.0)


def fold_to_cells(pos_r, w, nsc: int, cap: int, col0_x: int = 0):
    """Fold each slot's coordinates [NCOL, CS, 3] into the periodic image
    nearest its cell centre, so a wrap-crosser sits next to its cell again
    (unmoved occupants fold by exactly 0). ``col0_x`` is the global x-plane
    of the first column: a slab's columns are a window of the grid."""
    ncol, cs = pos_r.shape[0], pos_r.shape[1]
    dev = pos_r.device
    w = f32(w)
    cellw = w / np.float32(nsc)
    half_w = float(np.float32(0.5) * w)
    col = torch.arange(ncol, device=dev)
    ctr_x = ((col // nsc + col0_x).to(torch.float32) + 0.5) * float(cellw) - half_w
    ctr_y = ((col % nsc).to(torch.float32) + 0.5) * float(cellw) - half_w
    zc = torch.arange(cs, device=dev) // cap
    ctr_z = (zc.to(torch.float32) + 0.5) * float(cellw) - half_w
    ctr = torch.stack([ctr_x[:, None].expand(ncol, cs),
                       ctr_y[:, None].expand(ncol, cs),
                       ctr_z[None, :].expand(ncol, cs)], dim=-1)
    return pos_r - float(w) * torch.round(F.tdiv(pos_r - ctr, w))


def _ghost(a, cfg: SimConfig, cap: int, fill: float, zshift: bool = False):
    """Slot-major [NCOL, CS, ...] -> ghosted [NSRC, G, ...]. Periodic: one
    copy of the far-end supercell at each z end (coordinates shifted by
    -+w when ``zshift``). Walled: ``fill`` padding, plus the dummy column
    of ``fill`` appended last."""
    ncol, cs = a.shape[0], a.shape[1]
    if cfg.wrap_forces:
        lo, hi = a[:, cs - cap:], a[:, :cap]
        if zshift:
            # [0, 0, w] made on the device: a host value assigned into it
            # would be a blocking copy
            zs = torch.nn.functional.pad(
                torch.full((1,), float(f32(cfg.world_size)), device=a.device),
                (2, 0))
            lo, hi = lo - zs, hi + zs
        return torch.cat([lo, a, hi], 1)
    g = torch.full((ncol + 1, cs + 2 * cap) + tuple(a.shape[2:]), fill,
                   dtype=torch.float32, device=a.device)
    g[:ncol, cap:cap + cs] = a
    return g


def ghost_positions(pos_r, cfg: SimConfig, cap: int):
    """Slot-major positions [NCOL, CS, 3] -> ghosted slot-minor post_g
    [NSRC, 3, G]: the one operand that changes between steps on a frozen
    layout (``dense_forces``)."""
    return _ghost(pos_r, cfg, cap, 0.0, zshift=True).permute(0, 2, 1).contiguous()


def ghost_columns(pos_r, v_r, r2_r, cfg: SimConfig, cap: int):
    """Slot-major column arrays pos_r [NCOL, CS, 3], v_r [NCOL, CS, P],
    r2_r [NCOL, CS] -> ghosted slot-minor (post_g, vt_g, r2_g). Periodic:
    the z ghosts are +-w-shifted copies of the far end. Walled: masked
    padding, plus the fully masked dummy column appended last."""
    return (ghost_positions(pos_r, cfg, cap),
            _ghost(v_r, cfg, cap, 0.0).permute(0, 2, 1).contiguous(),
            _ghost(r2_r, cfg, cap, -1.0)[:, None, :].contiguous())


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
    exact forces from the overflow sidecar (``ops.overflow``). ``nsc`` and
    ``cap`` default to the config's, else to ``celllist.grid_dims`` and
    ``default_capacity(slack=2.5)``; below 3 supercells per axis the
    XLA-style cell list (``celllist.celllist_forces``) takes over."""
    from .celllist import celllist_forces, default_capacity, grid_dims
    from .celllist_dense import OCAP
    from .compaction import index_add_rows, masked_indices
    from .overflow import neighborhood_sweeps

    n = positions.shape[0]
    dev = positions.device
    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None:
        nsc = grid_dims(float(cfg.world_size), float(cfg.particle_effect_radius))
    if cap is None:
        cap = default_capacity(n, nsc, slack=2.5)
    if nsc < 3:
        return celllist_forces(positions, u, v, cfg, nc=nsc, capacity=cap)
    check_cell_width(cfg, nsc)
    u, v = F.pad_features(u, v)

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


# ---------------------------------------------------------------------------
# Cadenced rebuild: reuse the sorted layout across steps
# ---------------------------------------------------------------------------
#
# Binning only needs to be valid, not fresh: a pair within the cutoff is
# still covered by the +-1 supercell window while every particle has drifted
# less than (cell_width - cutoff)/2 since the layout was built. The sort and
# scatter of a build are the expensive part; refreshing positions into an
# existing layout is one gather. Features and the r2 gate are
# layout-constant and cached.


@dataclasses.dataclass(frozen=True)
class CellLayout:
    """Frozen binning of particles into the column layout."""

    slot_particle: torch.Tensor  # i64 [NCOL, CS], -1 for an empty slot
    u_d: torch.Tensor            # f32 [NCOL, P, CS] receiver features
    vt_g: torch.Tensor           # f32 [NSRC, P, G] ghosted source features
    r2_g: torch.Tensor           # f32 [NSRC, 1, G] ghosted gates
    anchor: torch.Tensor         # f32 [N, 3] positions at build time


def build_layout(positions, u, v, cfg: SimConfig, nsc: int, cap: int) -> CellLayout:
    """Bin and sort ``positions`` into a layout; particles of cell rank >=
    cap get no slot (``slot_of_particle`` gives them -1)."""
    u, v = F.pad_features(u, v)
    _, u_d, _, vt_g, r2_g, slot_particle = prepare_columns(
        positions, u, v, cfg, nsc, cap)
    return CellLayout(slot_particle, u_d, vt_g, r2_g, positions)


def slot_of_particle(layout: CellLayout, n: int):
    """i64 [N] flat slot of each particle, -1 for particles the build
    dropped."""
    slot = layout.slot_particle.reshape(-1)
    inv = torch.full((n + 1,), -1, dtype=torch.int64, device=slot.device)
    inv[torch.where(slot >= 0, slot, n)] = torch.arange(slot.shape[0],
                                                        device=slot.device)
    return inv[:n]


def dense_forces(layout: CellLayout, pos_flat, cfg: SimConfig, nsc: int,
                 cap: int):
    """K1 forces f32 [NCOL*CS, 3] for positions already in the layout's
    slots (f32 [NCOL*CS, 3]); exactly 0 on empty slots. Only the positions
    are folded and ghosted on each call; features and gates come from the
    layout."""
    ncol, cs = nsc * nsc, nsc * cap
    pos_r = pos_flat.reshape(ncol, cs, 3).float()
    if cfg.wrap_forces:
        # stale-layout wrap crossers go back next to their cell
        pos_r = fold_to_cells(pos_r, cfg.world_size, nsc, cap)
    forces_d = column_sweep_forces(
        pos_r.permute(0, 2, 1).contiguous(), layout.u_d,
        ghost_positions(pos_r, cfg, cap), layout.vt_g, layout.r2_g,
        pack_params(cfg), cfg.force_law, bool(cfg.wrap_forces), nsc, cap)
    return forces_d.permute(0, 2, 1).reshape(-1, 3)


def drift_budget(cfg: SimConfig, nsc: int) -> float:
    """Largest per-particle displacement a frozen layout tolerates:
    (cell_width - cutoff) / 2, in float32."""
    w = f32(cfg.world_size)
    r = f32(cfg.particle_effect_radius)
    cutoff = min(r, np.float32(1.0)) if cfg.force_law == "particle_life" else r
    return float((w / np.float32(nsc) - cutoff) * np.float32(0.5))


def layout_drift(layout: CellLayout, positions, cfg: SimConfig):
    """Largest displacement since the layout's anchor, minimum image (a
    device scalar)."""
    d = F.min_image(positions - layout.anchor, cfg.world_size)
    return torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))


def layout_forces(layout: CellLayout, positions, cfg: SimConfig, nsc: int,
                  cap: int):
    """Forces [N, 3] on a frozen layout for particle-order positions: one
    gather into the slots, K1, one scatter back (0 for dropped particles).
    ``dense_forces`` skips both when the state lives in the slots
    (``engine.step.simulate_cadenced``)."""
    from .compaction import index_add_rows

    n = positions.shape[0]
    slot = layout.slot_particle.reshape(-1)
    present = slot >= 0
    safe = torch.where(present, slot, 0)
    pos_flat = torch.where(present[:, None], positions[safe], 0.0)
    f = dense_forces(layout, pos_flat, cfg, nsc, cap)
    return index_add_rows(torch.zeros_like(positions), safe,
                          f.to(positions.dtype), present)
