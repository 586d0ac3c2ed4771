"""All-pairs force sweeps: the wrappers of kernels K3, K2 and K4, their
plain torch versions, and the Morton-sorted tile culling around them (port
of ``particle3d_tpu.ops.pallas_allpairs``).

The kernels (``csrc/allpairs_sweep.cu``):

  K3  ``rect_sweep``      one-sided: receivers against a source set
  K2  ``tri_sweep``       triangular same-set sweep over the unordered tile
                          pairs (i, (i + k) mod nt), k = 0 .. nt/2, with an
                          optional bit mask of the steps to run
  K4  ``pairlist_sweep``  K2's tile-pair math over a worklist of surviving
                          tile pairs, sorted by receiver tile

Each wrapper checks its operands and raises on what its kernel does not
take. CPU tensors go to the plain version (``*_ref``), which follows its
kernel's formulation; CUDA tensors launch the kernel or raise, with no
fallback. ``KERNEL_LAUNCHES`` counts launches per kernel.

The JAX functions keep their names: ``pallas_allpairs_forces`` (K3, or K2
for same-set sweeps at N >= ``TRI_MIN_N``), ``pallas_allpairs_forces_tri``
(K2), ``culled_forces_sorted`` and ``pallas_allpairs_forces_culled`` (K2
with its mask), ``pallas_allpairs_forces_pairlist`` (K4), and the culling
helpers ``morton_keys``, ``_pack_bits``, ``culled_tile_mask``,
``tile_bounds``, ``pair_survival_mask`` and ``build_pair_worklist``.

Formulations differ between the kernels, as in the JAX package: K3 wraps
in world units and gates as ``params.gated_scale`` does; K2 and K4 take
positions and r^2 pre-scaled by 1/w in wrap mode, wrap as dx - round(dx),
gate d^2 > 1e-12 (wrap) or > 0 (walls) in box units, and restore d^2 with
w^2 and the force sums with w.

Not carried over, as Mosaic rules of the TPU: tile sizes of 640/512/256
and multiples of 128, the SMEM worklist bound ``_WLIST_MAX`` with its
chunks, and quantum padding of worklists. The kernels' tile is
``KERNEL_TILE`` rows; feature widths are padded with zero columns to 8 or
16 (``KERNEL_WIDTHS``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import SimConfig, f32
from . import forces as F
from .compaction import index_add_rows
from .params import (LAW_IDS, PF_INV_W, PF_W, directional_scale, gated_scale,
                     pack_params, pair_parts, r2_gate)

KERNEL_TILE = 128         # K2/K4 tile rows (csrc TILE)
RECT_BLOCK = 128          # K3 receivers per block and sources per chunk
KERNEL_WIDTHS = (8, 16)   # feature widths the kernels are built for
TRI_MIN_N = 4 * 512       # same-set sweeps this large go to K2 (JAX dispatch)
PACK_SHIFT = 15           # worklist entries are (i << 15) | j
_BLOCKS_PER_SM = 4        # partial-sum splits aim at this many blocks per SM
# largest [b, t, t] temporary of the plain versions, in elements
_REF_MAX_ELEMS = 1 << 24

KERNEL_LAUNCHES = {"allpairs_rect": 0, "allpairs_tri": 0,
                   "allpairs_pairlist": 0}

_LIB = ("allpairs_sweep", ("allpairs_sweep.cu", "tile_pair_mma.cuh",
                           "tile_sweep.cuh", "pair_law.cuh"))


def _library():
    from ..utils.cuda_build import load_library

    lib = load_library(*_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.p3t_allpairs_rect.argtypes = [p, p, i, p, p, p, i, i, p, p, i, i, i, p]
    lib.p3t_allpairs_tri.argtypes = [p] * 6 + [i, i, i, p, p, i, p, i, i, p]
    lib.p3t_allpairs_pairlist.argtypes = [p] * 7 + [i, i, p, p, p, i, i, p]
    for fn in (lib.p3t_allpairs_rect, lib.p3t_allpairs_tri,
               lib.p3t_allpairs_pairlist):
        fn.restype = ctypes.c_int
    return lib


def build_kernel():
    """Build (or find) and load the K2/K3/K4 library; returns nvcc's log."""
    from ..utils.cuda_build import build_log

    _library()
    return build_log(*_LIB)


# -- operand checks and launches --------------------------------------------

def _check(device, **operands):
    """Each operand is (tensor, dtype, shape): same device, dtype, shape,
    contiguous."""
    for name, (t, dtype, shape) in operands.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_ready(device, p: int, t: int | None = None):
    if device.type != "cuda":
        raise ValueError(f"no all-pairs kernel for device {device}")
    if p not in KERNEL_WIDTHS:
        raise ValueError(f"feature width {p}: the all-pairs kernels take "
                         f"{KERNEL_WIDTHS} (pad with zero columns, "
                         f"forces.pad_features)")
    if t is not None and t != KERNEL_TILE:
        raise ValueError(f"the triangular kernels' tile is {KERNEL_TILE} "
                         f"rows, got t={t}")


def _params(params) -> np.ndarray:
    pf = np.ascontiguousarray(np.asarray(params, np.float32))
    if pf.shape != (14,):
        raise ValueError(f"params must be f32[14], got {pf.shape}")
    return pf


def _splits(blocks: int, most: int, device) -> int:
    """Partial-sum splits so that ``blocks * splits`` fills the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(most, -(-(_BLOCKS_PER_SM * sms) // blocks)))


def _launch(name: str, fn, args, device, what: str, counts=None):
    """Launch on the current stream, raise on a refused launch, and count
    it in ``counts`` (this module's ``KERNEL_LAUNCHES`` by default)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({what})")
    (KERNEL_LAUNCHES if counts is None else counts)[name] += 1


def _round_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_rows(a, rows: int):
    if a.shape[0] == rows:
        return a.contiguous()
    pad = a.new_zeros((rows - a.shape[0],) + tuple(a.shape[1:]))
    return torch.cat([a, pad])


# -- K3: one-sided rectangular sweep ---------------------------------------

def rect_sweep(pos, u, src, v, r2row, params, law: str, wrap: bool):
    """K3: f32[N, 3] = sum over sources j of delta_ij * s(d2_ij, U_i . V_j),
    delta_ij = src_j - pos_i (minimum image in world units when ``wrap``),
    gated by d2 < r2row[j] (r2row = -1 masks a source)."""
    n, m, p = pos.shape[0], src.shape[0], u.shape[1]
    f = torch.float32
    _check(pos.device, pos=(pos, f, (n, 3)), u=(u, f, (n, p)),
           src=(src, f, (m, 3)), v=(v, f, (m, p)), r2row=(r2row, f, (m,)))
    if pos.device.type == "cpu":
        return rect_sweep_ref(pos, u, src, v, r2row, params, law, wrap)
    _kernel_ready(pos.device, p)
    if n == 0:
        raise ValueError("rect_sweep needs at least one receiver")
    pf = _params(params)
    lib = _library()
    splits = _splits(-(-n // RECT_BLOCK), max(1, -(-m // RECT_BLOCK)),
                     pos.device)
    out = torch.empty((splits, n, 3), dtype=f, device=pos.device)
    _launch("allpairs_rect", lib.p3t_allpairs_rect,
            (pos.data_ptr(), u.data_ptr(), n, src.data_ptr(), v.data_ptr(),
             r2row.data_ptr(), m, p, pf.ctypes.data_as(ctypes.c_void_p),
             out.data_ptr(), splits, LAW_IDS[law], int(bool(wrap))),
            pos.device, f"n={n}, m={m}")
    return out[0] if splits == 1 else out.sum(0)


def rect_sweep_ref(pos, u, src, v, r2row, params, law: str, wrap: bool):
    """Plain K3, blocked over receivers."""
    n, m = pos.shape[0], src.shape[0]
    w, inv_w = float(params[PF_W]), float(params[PF_INV_W])
    blk = max(1, _REF_MAX_ELEMS // max(1, m))
    out = []
    for i0 in range(0, n, blk):
        rec = pos[i0:i0 + blk]
        d = [src[None, :, c] - rec[:, c, None] for c in range(3)]
        if wrap:
            d = [x - torch.round(x * inv_w) * w for x in d]
        dx, dy, dz = d
        d2 = dx * dx + dy * dy + dz * dz
        coef = F.pair_coef(u[i0:i0 + blk], v)
        s = gated_scale(law, d2, d2 < r2row[None, :], coef, params)
        out.append(torch.stack([(dx * s).sum(1), (dy * s).sum(1),
                                (dz * s).sum(1)], dim=1))
    if not out:
        return pos.new_zeros((0, 3))
    return torch.cat(out)


def rect_operands(positions, u, src_positions, src_v, cfg: SimConfig):
    """``rect_sweep``'s arguments for receivers against a source set."""
    u, src_v = F.pad_features(u, src_v)
    src = src_positions.to(torch.float32).contiguous()
    r2row = torch.full((src.shape[0],), float(r2_gate(cfg)),
                       dtype=torch.float32, device=src.device)
    return (positions.to(torch.float32).contiguous(), u, src, src_v, r2row,
            pack_params(cfg), cfg.force_law, bool(cfg.wrap_forces))


def pallas_allpairs_forces(positions, u, v, cfg: SimConfig, *,
                           src_positions=None, src_v=None):
    """Accumulated pair forces [N, 3]: K3 against ``src_positions`` /
    ``src_v`` (a rectangular sweep) or against the receivers themselves;
    same-set sweeps of at least ``TRI_MIN_N`` particles go to K2, as in the
    JAX package."""
    if src_positions is None:
        if positions.shape[0] >= TRI_MIN_N:
            return pallas_allpairs_forces_tri(positions, u, v, cfg)
        src_positions, src_v = positions, v
    return rect_sweep(*rect_operands(positions, u, src_positions, src_v, cfg))


# -- K2 and K4: the triangular tile-pair sweeps -----------------------------

def _tile_pairs_ref(pi, ui, vi, mi, pj, uj, vj, r2j, params, law: str,
                    wrap: bool):
    """Both directions of a batch of tile pairs in the K2/K4 form: receiver
    tiles pi [b, t, 3] (features ui, vi, row mask mi [b, t]) against
    source tiles pj (uj, vj, gate r2j [b, t]). Returns the i-side [b, t, 3]
    and the j-side column sums [b, 3, t], both in box units and unnegated."""
    d = [pj[:, None, :, c] - pi[:, :, None, c] for c in range(3)]
    if wrap:
        d = [x - torch.round(x) for x in d]
    dx, dy, dz = d
    d2 = dx * dx + dy * dy + dz * dz
    valid = (d2 > (1e-12 if wrap else 0.0)) & (d2 < r2j[:, None, :])
    if wrap:
        w = f32(params[PF_W])
        d2 = d2 * float(w * w)
    parts = pair_parts(law, d2, valid, params)
    s_ij = directional_scale(parts, F.pair_coef(ui, vj))
    # selected, not multiplied by the row mask: a padded row sits at the
    # origin, where a singular law can give inf, and inf * 0 is NaN
    s_ji = torch.where(mi[:, :, None] > 0,
                       directional_scale(parts, F.pair_coef(vi, uj)), 0.0)
    i_side = torch.stack([(dx * s_ij).sum(2), (dy * s_ij).sum(2),
                          (dz * s_ij).sum(2)], dim=-1)
    j_side = torch.stack([(dx * s_ji).sum(1), (dy * s_ji).sum(1),
                          (dz * s_ji).sum(1)], dim=1)
    return i_side, j_side


def _check_tri(pos_p, u_p, v_p, r2row, imask, t: int):
    np_, p = pos_p.shape[0], u_p.shape[1]
    if t < 1 or np_ == 0 or np_ % t:
        raise ValueError(f"{np_} rows do not make whole tiles of {t}")
    f = torch.float32
    _check(pos_p.device, pos_p=(pos_p, f, (np_, 3)), u_p=(u_p, f, (np_, p)),
           v_p=(v_p, f, (np_, p)), r2row=(r2row, f, (np_,)),
           imask=(imask, f, (np_,)))
    return np_, p, np_ // t


def tri_sweep(pos_p, u_p, v_p, r2row, imask, params, law: str, wrap: bool,
              t: int, mask=None):
    """K2 over padded same-set operands of np_ = nt * t rows. Returns
    ``(out_a f32[np_, 3], out_b f32[nk, 3, np_])``, nk = nt // 2 + 1: the
    i-side sums, and the j-side partial of step k for tile (i + k) mod nt
    in ``out_b[k]``; the forces are ``out_a + out_b.sum(0).T``. ``mask``
    (i32 [nt, ceil(nk / 32)], ``_pack_bits``) selects the steps to run."""
    np_, p, nt = _check_tri(pos_p, u_p, v_p, r2row, imask, t)
    nk = nt // 2 + 1
    nkw = -(-nk // 32)
    if mask is not None:
        _check(pos_p.device, mask=(mask, torch.int32, (nt, nkw)))
    if pos_p.device.type == "cpu":
        return tri_sweep_ref(pos_p, u_p, v_p, r2row, imask, params, law, wrap,
                             t, mask)
    _kernel_ready(pos_p.device, p, t)
    pf = _params(params)
    lib = _library()
    splits = _splits(nt, nk, pos_p.device)
    out_a = torch.empty((splits, np_, 3), dtype=torch.float32,
                        device=pos_p.device)
    out_b = torch.empty((nk, 3, np_), dtype=torch.float32, device=pos_p.device)
    _launch("allpairs_tri", lib.p3t_allpairs_tri,
            (pos_p.data_ptr(), u_p.data_ptr(), v_p.data_ptr(),
             r2row.data_ptr(), imask.data_ptr(),
             mask.data_ptr() if mask is not None else None, nkw, nt, p,
             pf.ctypes.data_as(ctypes.c_void_p), out_a.data_ptr(), splits,
             out_b.data_ptr(), LAW_IDS[law], int(bool(wrap))),
            pos_p.device, f"nt={nt}, mask={mask is not None}")
    return (out_a[0] if splits == 1 else out_a.sum(0)), out_b


def tri_sweep_ref(pos_p, u_p, v_p, r2row, imask, params, law: str,
                  wrap: bool, t: int, mask=None):
    """Plain K2: the same (i, k) steps and guards, vectorised over blocks
    of receiver tiles."""
    np_ = pos_p.shape[0]
    nt = np_ // t
    nk = nt // 2 + 1
    dev = pos_p.device
    tiles = [a.reshape(nt, t, -1) for a in (pos_p, u_p, v_p)]
    r2t, mt = r2row.reshape(nt, t), imask.reshape(nt, t)
    i_sum = torch.zeros((nt, t, 3), dtype=torch.float32, device=dev)
    out_b = torch.zeros((nk, 3, nt, t), dtype=torch.float32, device=dev)
    ids = torch.arange(nt, device=dev)
    blk = max(1, _REF_MAX_ELEMS // (t * t))
    for k in range(nk):
        run = torch.ones(nt, dtype=torch.bool, device=dev)
        if 2 * k == nt:  # even nt: the half diagonal once, from i < nt/2
            run[nt // 2:] = False
        if mask is not None and k > 0:
            run &= ((mask[:, k // 32] >> (k % 32)) & 1) != 0
        for i0 in range(0, nt, blk):
            ii = ids[i0:i0 + blk]
            jj = (ii + k) % nt
            go = run[i0:i0 + blk][:, None, None]
            (pi, ui, vi), (pj, uj, vj) = ([a[ii] for a in tiles],
                                          [a[jj] for a in tiles])
            i_side, j_side = _tile_pairs_ref(pi, ui, vi, mt[ii], pj, uj, vj,
                                             r2t[jj], params, law, wrap)
            i_sum[ii] += torch.where(go, i_side, 0.0)
            if k > 0:  # the k = 0 diagonal is one-sided
                out_b[k][:, jj, :] = torch.where(go, -j_side,
                                                 0.0).permute(1, 0, 2)
    out_a = i_sum.reshape(np_, 3)
    out_b = out_b.reshape(nk, 3, np_)
    if wrap:
        w = float(params[PF_W])
        return out_a * w, out_b * w
    return out_a, out_b


def pairlist_sweep(pos_p, u_p, v_p, r2row, imask, wi, wj, params, law: str,
                   wrap: bool, t: int):
    """K4 over the worklist entries (wi[s], wj[s]) of receiver and source
    tiles, sorted by wi, with every tile's self entry present. Returns
    ``(out_a f32[np_, 3], out_b f32[W, 3, t])``: the i-side sums, and
    entry s's j-side partial for tile wj[s]."""
    np_, p, nt = _check_tri(pos_p, u_p, v_p, r2row, imask, t)
    nw = wi.shape[0]
    _check(pos_p.device, wi=(wi, torch.int32, (nw,)),
           wj=(wj, torch.int32, (nw,)))
    if pos_p.device.type == "cpu":
        return pairlist_sweep_ref(pos_p, u_p, v_p, r2row, imask, wi, wj,
                                  params, law, wrap, t)
    _kernel_ready(pos_p.device, p, t)
    pf = _params(params)
    lib = _library()
    row_start = torch.searchsorted(
        wi, torch.arange(nt + 1, dtype=torch.int32, device=wi.device),
        out_int32=True)
    out_a = torch.empty((np_, 3), dtype=torch.float32, device=pos_p.device)
    out_b = torch.empty((nw, 3, t), dtype=torch.float32, device=pos_p.device)
    _launch("allpairs_pairlist", lib.p3t_allpairs_pairlist,
            (pos_p.data_ptr(), u_p.data_ptr(), v_p.data_ptr(),
             r2row.data_ptr(), imask.data_ptr(), wj.data_ptr(),
             row_start.data_ptr(), nt, p, pf.ctypes.data_as(ctypes.c_void_p),
             out_a.data_ptr(), out_b.data_ptr(), LAW_IDS[law],
             int(bool(wrap))),
            pos_p.device, f"nt={nt}, entries={nw}")
    return out_a, out_b


def pairlist_sweep_ref(pos_p, u_p, v_p, r2row, imask, wi, wj, params,
                       law: str, wrap: bool, t: int):
    """Plain K4, blocked over worklist entries; the i-side sum by receiver
    tile is a deterministic ``index_add_rows``."""
    np_ = pos_p.shape[0]
    nt = np_ // t
    dev = pos_p.device
    nw = wi.shape[0]
    tiles = [a.reshape(nt, t, -1) for a in (pos_p, u_p, v_p)]
    r2t, mt = r2row.reshape(nt, t), imask.reshape(nt, t)
    i_all = torch.empty((nw, t, 3), dtype=torch.float32, device=dev)
    out_b = torch.empty((nw, 3, t), dtype=torch.float32, device=dev)
    blk = max(1, _REF_MAX_ELEMS // (t * t))
    for s0 in range(0, nw, blk):
        ii, jj = wi[s0:s0 + blk].long(), wj[s0:s0 + blk].long()
        (pi, ui, vi), (pj, uj, vj) = ([a[ii] for a in tiles],
                                      [a[jj] for a in tiles])
        i_side, j_side = _tile_pairs_ref(pi, ui, vi, mt[ii], pj, uj, vj,
                                         r2t[jj], params, law, wrap)
        i_all[s0:s0 + blk] = i_side
        # self entries are one-sided: their j-side is 0
        out_b[s0:s0 + blk] = torch.where((ii != jj)[:, None, None], -j_side,
                                         0.0)
    rows = (wi.long()[:, None] * t + torch.arange(t, device=dev)).reshape(-1)
    out_a = index_add_rows(torch.zeros((np_, 3), dtype=torch.float32,
                                       device=dev),
                           rows, i_all.reshape(-1, 3),
                           torch.ones_like(rows, dtype=torch.bool))
    if wrap:
        w = float(params[PF_W])
        return out_a * w, out_b * w
    return out_a, out_b


def tri_operands(positions, u, v, cfg: SimConfig, t: int):
    """``tri_sweep``'s arguments up to ``params``: padded rows, positions
    and r^2 pre-scaled by 1/w in wrap mode, r2row = -1 and imask = 0 on
    padding rows."""
    n = positions.shape[0]
    np_ = _round_to(n, t)
    dev = positions.device
    params = pack_params(cfg)
    pos = positions.to(torch.float32)
    r2 = r2_gate(cfg)
    if cfg.wrap_forces:
        inv_w = params[PF_INV_W]
        pos = pos * float(inv_w)
        r2 = r2 * (inv_w * inv_w)
    u, v = F.pad_features(u, v)
    r2row = torch.full((np_,), -1.0, dtype=torch.float32, device=dev)
    r2row[:n] = float(r2)
    imask = torch.zeros((np_,), dtype=torch.float32, device=dev)
    imask[:n] = 1.0
    return (_pad_rows(pos, np_), _pad_rows(u, np_), _pad_rows(v, np_), r2row,
            imask, params)


def pallas_allpairs_forces_tri(positions, u, v, cfg: SimConfig, *,
                               t: int | None = None):
    """Triangular all-pairs forces [N, 3] through K2 (same-set sweeps).
    ``t`` is the tile: the kernel's ``KERNEL_TILE``; the plain version
    takes any."""
    n = positions.shape[0]
    t = KERNEL_TILE if t is None else t
    ops = tri_operands(positions, u, v, cfg, t)
    out_a, out_b = tri_sweep(*ops, cfg.force_law, bool(cfg.wrap_forces), t)
    return tri_forces(out_a, out_b)[:n]


def tri_forces(out_a, out_b):
    """Forces [np_, 3] from ``tri_sweep``'s outputs: the k-sum of the
    j-side partials (a fixed-order reduction) plus the i-side."""
    return out_a + out_b.sum(0).T


# -- culling: Morton order, tile bounds, masks and worklists -----------------

def morton_keys(positions, world_size, bits: int = 10):
    """Z-order key per particle (3 x ``bits`` interleaved, int32)."""
    w = f32(world_size)
    scale = float(np.float32(1 << bits))
    shifted = positions + float(np.float32(0.5) * w)
    q = torch.clamp((F.tdiv(shifted, w) * scale).to(torch.int32), 0,
                    (1 << bits) - 1)

    def spread(x):  # 10-bit 3-D bit spread
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _pack_bits(mask_bool):
    """[nt, nk] bool -> [nt, ceil(nk / 32)] int32, bit k % 32 of word k // 32."""
    nt, nk = mask_bool.shape
    nkw = -(-nk // 32)
    dev = mask_bool.device
    padded = torch.zeros((nt, nkw * 32), dtype=torch.int64, device=dev)
    padded[:, :nk] = mask_bool.to(torch.int64)
    words = (padded.reshape(nt, nkw, 32)
             << torch.arange(32, device=dev)).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _sum3(d):
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _min_image(d, w):
    return d - torch.round(F.tdiv(d, w)) * float(w)


def tile_bounds(pos_sorted, n: int, t: int, cfg: SimConfig | None = None):
    """(centers [nt, 3], radii [nt]) bounding spheres per tile of Morton-
    sorted, zero-padded positions. With a periodic config the box is built
    from minimum-image deltas around each tile's first (always real)
    member, so a tile straddling the seam folds back; a tile spread past
    w/2 on an axis gets radius 1e30 (never culled)."""
    np_ = pos_sorted.shape[0]
    nt = np_ // t
    dev = pos_sorted.device
    valid = (torch.arange(np_, device=dev) < n).reshape(nt, t, 1)
    p3 = pos_sorted.to(torch.float32).reshape(nt, t, 3)
    wrap = cfg is not None and bool(cfg.wrap_forces)
    anchor = p3[:, 0:1, :]
    d = p3 - anchor
    if wrap:
        w = f32(cfg.world_size)
        d = _min_image(d, w)
    d = torch.where(valid, d, 0.0)
    mins, maxs = d.amin(1), d.amax(1)
    centers = anchor[:, 0, :] + 0.5 * (mins + maxs)
    ext = maxs - mins
    radii = 0.5 * torch.sqrt(_sum3(ext))
    if wrap:
        bad = (ext >= float(np.float32(0.5) * w)).any(-1)
        radii = torch.where(bad, float(np.float32(1e30)), radii)
    return centers, radii


def _cutoff(cfg: SimConfig) -> np.float32:
    return np.float32(np.sqrt(r2_gate(cfg)))


def culled_tile_mask(pos_sorted, n: int, t: int, cfg: SimConfig):
    """(packed mask [nt, ceil(nk / 32)], surviving fraction) of the K2
    steps (i, k) to run, for Morton-sorted, zero-padded positions: a tile
    pair runs unless its bounding spheres stay farther apart than the
    cutoff. The self diagonal k = 0 always runs."""
    np_ = pos_sorted.shape[0]
    nt = np_ // t
    nk = nt // 2 + 1
    dev = pos_sorted.device
    centers, radii = tile_bounds(pos_sorted, n, t, cfg)
    i = torch.arange(nt, device=dev)[:, None]
    j = ((i + torch.arange(nk, device=dev)[None, :]) % nt).reshape(-1)
    d = centers[i] - centers[j].reshape(nt, nk, 3)
    if cfg.wrap_forces:
        d = _min_image(d, f32(cfg.world_size))
    dist = torch.sqrt(_sum3(d))
    run = dist <= radii[i] + radii[j].reshape(nt, nk) + float(_cutoff(cfg))
    run[:, 0] = True
    return _pack_bits(run), run.to(torch.float32).mean()


def culled_forces_sorted(pos_s, u_s, v_s, cfg: SimConfig, *,
                         t: int | None = None):
    """(forces [N, 3], surviving fraction) through K2 in mask mode for
    Morton-sorted inputs. The mask comes from the given positions, so a
    stale order stays exact (tile bounds only grow)."""
    n = pos_s.shape[0]
    t = KERNEL_TILE if t is None else t
    ops = tri_operands(pos_s, u_s, v_s, cfg, t)
    mask, frac = culled_tile_mask(
        _pad_rows(pos_s.to(torch.float32), ops[0].shape[0]), n, t, cfg)
    out_a, out_b = tri_sweep(*ops, cfg.force_law, bool(cfg.wrap_forces), t,
                             mask=mask)
    return tri_forces(out_a, out_b)[:n], frac


def pallas_allpairs_forces_culled(positions, u, v, cfg: SimConfig, *,
                                  t: int | None = None,
                                  with_stats: bool = False):
    """Exact forces [N, 3] through the Morton-sorted, tile-culled K2."""
    order = torch.argsort(morton_keys(positions, cfg.world_size), stable=True)
    f_sorted, frac = culled_forces_sorted(positions[order], u[order], v[order],
                                          cfg, t=t)
    out = torch.empty_like(f_sorted)
    out[order] = f_sorted
    return (out, frac) if with_stats else out


def pair_survival_mask(pos_s_padded, n: int, t: int, nt: int,
                       cfg: SimConfig, skin=0.0):
    """Upper-triangular (j >= i) bool [nt, nt]: tile pairs whose bounding
    spheres can come within cutoff + ``skin``; the self pairs always."""
    centers, radii = tile_bounds(pos_s_padded, n, t, cfg)
    d = centers[:, None, :] - centers[None, :, :]
    if cfg.wrap_forces:
        d = _min_image(d, f32(cfg.world_size))
    dist = torch.sqrt(_sum3(d))
    cutoff = _cutoff(cfg) + np.float32(skin)
    run = dist <= radii[:, None] + radii[None, :] + float(cutoff)
    iu = torch.arange(nt, device=pos_s_padded.device)
    run &= iu[None, :] >= iu[:, None]
    return run | torch.eye(nt, dtype=torch.bool, device=run.device)


def build_pair_worklist(mask, nt: int):
    """``(wp, count)``: the surviving pairs of an [nt, nt] survival mask as
    int32 entries (i << 15) | j in row-major order (sorted by i, then j),
    on the mask's device. Exact: no padding, no capacity; ``torch.nonzero``
    synchronises once with the device to learn the count."""
    if nt + 1 >= 1 << PACK_SHIFT:
        raise ValueError(f"nt={nt} overflows the {PACK_SHIFT}-bit j field")
    ij = torch.nonzero(mask)
    count = int(ij.shape[0])
    if count < nt:
        raise ValueError("every tile's self pair must survive")
    return ((ij[:, 0] << PACK_SHIFT) | ij[:, 1]).to(torch.int32), count


def pallas_allpairs_forces_pairlist(pos_s, u_s, v_s, cfg: SimConfig, wp, *,
                                    t: int | None = None):
    """Exact forces [N, 3] for Morton-sorted inputs through K4 over the
    worklist ``wp`` (``build_pair_worklist``). The j-side partials are
    summed by source tile with a deterministic ``index_add_rows``."""
    n = pos_s.shape[0]
    t = KERNEL_TILE if t is None else t
    ops = tri_operands(pos_s, u_s, v_s, cfg, t)
    wi, wj = unpack_worklist(wp)
    out_a, out_b = pairlist_sweep(*ops[:5], wi, wj, ops[5], cfg.force_law,
                                  bool(cfg.wrap_forces), t)
    return pairlist_forces(out_a, out_b, wj)[:n]


def unpack_worklist(wp):
    """(wi, wj) int32 receiver and source tiles of packed entries."""
    return ((wp >> PACK_SHIFT).contiguous(),
            (wp & ((1 << PACK_SHIFT) - 1)).contiguous())


def pairlist_forces(out_a, out_b, wj):
    """Forces [np_, 3] from ``pairlist_sweep``'s outputs: the j-side
    partials summed by source tile (a deterministic ``index_add_rows``)
    plus the i-side."""
    np_ = out_a.shape[0]
    t = out_b.shape[2]
    nt = np_ // t
    fb = index_add_rows(out_b.new_zeros((nt, 3 * t)), wj.long(),
                        out_b.reshape(-1, 3 * t),
                        torch.ones_like(wj, dtype=torch.bool))
    return out_a + fb.reshape(nt, 3, t).permute(0, 2, 1).reshape(np_, 3)
