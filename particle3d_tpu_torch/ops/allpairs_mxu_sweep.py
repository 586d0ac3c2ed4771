"""Ghost-image triangular all-pairs sweep: the wrapper of kernel K5, its
plain torch version, and the ghost images around it (port of
``particle3d_tpu.ops.pallas_allpairs_mxu``, the ``allpairs_mxu`` backend).

K5 (``csrc/allpairs_mxu.cu``, ``mxu_sweep``) sweeps the unordered tile
pairs (i, (i + k) mod nt), k = 0 .. nt/2, of [reals | ghost images] with
plain (unwrapped) deltas in world units. Periodic forces come from ghost
copies of the particles that lie within the cutoff of a box face
(``_build_ghosts``), not from a per-pair wrap: each cross-boundary ordered
interaction appears once as a {real, ghost} pair, and the ghosts' own sums
are dropped. The force sums are factored, on both sides of each pair:

    F_i = A_i[:3] - p_i * A_i[3],    A_i = sum_j s_ij [p_j | 1]

(the TPU kernel's S @ [P|1] matmuls). The factored form re-associates each
force into |p|-magnitude sums, about 1e-5 relative accuracy against the
direct form of K2 (``allpairs_sweep``). ``precision="fast"`` also forms
d^2 = |p_i|^2 + |p_j|^2 - 2 p_i . p_j, whose cancellation leaves about
|p|^2 * 2^-24 of noise in d^2: ~1e-3 relative on near-contact pairs.

Tile pairs with a dead tile (every row's imask 0: the trailing invalid
ghosts and the padding, which ``_build_ghosts`` compacts to the end) are
skipped and their j-side blocks written as zeros, unlike the TPU kernel:
rows < N then lack only the (near-)zero terms of particle life's parked
pairs with invalid ghosts (``live_tiles``).

The wrapper checks its operands and raises on what its kernel does not
take. CPU tensors go to the plain version ``mxu_sweep_ref``, which runs the
same (i, k) steps and guards and the same factored form in FP32, blocked;
CUDA tensors launch the kernel or raise, with no fallback.
``KERNEL_LAUNCHES["allpairs_mxu"]`` counts launches.

A ghost count above the capacity silently drops wrap interactions, as in
the JAX package: hold ``ghost_count`` against it.

Not carried over: the JAX error for periodic sweeps under a traced config
without ``ghost_capacity`` (the port's configs are always concrete, so
``recommended_ghost_capacity`` always applies); the Mosaic tiles of 640 and
512 rows (the kernel's tile is ``KERNEL_TILE``, the plain version takes
any); the TPU's rsqrt (``sqrtf`` and a true divide, as in every kernel of
the port).
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from ..config import SimConfig, f32
from . import forces as F
from .allpairs_sweep import (_REF_MAX_ELEMS, KERNEL_TILE, _check,
                             _kernel_ready, _launch, _pad_rows, _params,
                             _round_to, _splits, _sum3, tri_forces)
from .compaction import masked_indices
from .params import LAW_IDS, directional_scale, pack_params, pair_parts, r2_gate

# the 26 non-zero image offsets in {-1, 0, 1}^3
_OFFSETS26 = np.array(
    [o for o in itertools.product((-1, 0, 1), repeat=3) if any(o)],
    dtype=np.float32)

KERNEL_LAUNCHES = {"allpairs_mxu": 0}

_LIB = ("allpairs_mxu", ("allpairs_mxu.cu", "tile_pair_mma.cuh",
                         "tile_sweep.cuh", "pair_law.cuh"))


def _library():
    from ..utils.cuda_build import load_library

    lib = load_library(*_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.p3t_allpairs_mxu.argtypes = [p] * 5 + [i, i, p, p, i, p, i, i, p]
    lib.p3t_allpairs_mxu.restype = ctypes.c_int
    return lib


def build_kernel():
    """Build (or find) and load the K5 library; returns nvcc's log."""
    from ..utils.cuda_build import build_log

    _library()
    return build_log(*_LIB)


# -- ghost images --------------------------------------------------------------

def _ghost_shell_mask(positions, w, r_eff):
    """[N, 26] bool: the ghost copy pos + off * w lies within r_eff of the
    box (each nonzero offset axis needs the particle near the opposite
    face)."""
    offs = torch.as_tensor(_OFFSETS26, device=positions.device)[None]
    lo = positions < float(np.float32(-0.5) * w + r_eff)  # ghost at +w
    hi = positions > float(np.float32(0.5) * w - r_eff)   # ghost at -w
    ok = ((offs == 0.0) | ((offs > 0.0) & lo[:, None, :])
          | ((offs < 0.0) & hi[:, None, :]))
    return ok.all(-1)


def _build_ghosts(positions, u, v, cfg: SimConfig, gcap: int):
    """(positions [gcap, 3], u, v gathered from the parents, valid [gcap]):
    the ghost images in ascending (particle, offset) order, as
    ``jnp.nonzero`` orders them; rows past the count are invalid copies of
    particle 0."""
    n = positions.shape[0]
    w = f32(cfg.world_size)
    r_eff = np.sqrt(r2_gate(cfg))
    mask = _ghost_shell_mask(positions, w, r_eff)
    idx = masked_indices(mask.reshape(-1), gcap, fill_value=n * 26)
    valid = idx < n * 26
    p = torch.where(valid, idx // 26, 0)
    o = torch.where(valid, idx % 26, 0)
    offs = torch.as_tensor(_OFFSETS26, dtype=positions.dtype,
                           device=positions.device)
    gpos = positions[p] + offs[o] * float(w)
    return gpos, u[p], v[p], valid


def ghost_count(positions, cfg: SimConfig):
    """Ghost images the current frame needs, as a device scalar: hold it
    against the capacity (under capacity, wrap interactions are dropped)."""
    w = f32(cfg.world_size)
    return _ghost_shell_mask(positions, w, np.sqrt(r2_gate(cfg))).sum()


def recommended_ghost_capacity(cfg: SimConfig, n: int,
                               slack: float = 1.6) -> int:
    """Ghost capacity for a uniform-density scene: the expected shell
    population times ``slack``, plus 256, rounded up to 128."""
    w = float(np.asarray(cfg.world_size))
    r = float(np.asarray(cfg.particle_effect_radius))
    r_eff = min(r, 1.0) if cfg.force_law == "particle_life" else r
    rho = min(r_eff / w, 0.5)
    expected = n * ((1.0 + 2.0 * rho) ** 3 - 1.0)
    return int(_round_to(int(expected * slack) + 256, 128))


# -- K5 ---------------------------------------------------------------------------

def mxu_operands(positions, u, v, cfg: SimConfig, gcap: int | None, t: int):
    """``mxu_sweep``'s arguments up to ``params`` for N particles: rows
    [reals | gcap ghosts] (ghosts only with periodic forces) padded to
    whole tiles of ``t``; p4 = [pos | 1] in world units with zero padding
    rows; r2row = r^2, or -1 on invalid ghosts and padding; imask 1 on
    reals and valid ghosts."""
    n = positions.shape[0]
    dev = positions.device
    f = torch.float32
    pos = positions.to(f)
    u, v = F.pad_features(u, v)
    r2 = float(r2_gate(cfg))
    r2row = torch.full((n,), r2, dtype=f, device=dev)
    imask = torch.ones((n,), dtype=f, device=dev)
    if cfg.wrap_forces:
        gpos, gu, gv, gvalid = _build_ghosts(pos, u, v, cfg, gcap)
        pos = torch.cat([pos, gpos])
        u, v = torch.cat([u, gu]), torch.cat([v, gv])
        r2row = torch.cat([r2row, torch.where(gvalid, r2, -1.0).to(f)])
        imask = torch.cat([imask, gvalid.to(f)])
    m = pos.shape[0]
    mp = _round_to(m, t)
    p4 = torch.cat([pos, torch.ones((m, 1), dtype=f, device=dev)], dim=1)
    pad = mp - m
    r2row = torch.cat([r2row, torch.full((pad,), -1.0, dtype=f, device=dev)])
    imask = torch.cat([imask, torch.zeros((pad,), dtype=f, device=dev)])
    return (_pad_rows(p4, mp), _pad_rows(u, mp), _pad_rows(v, mp), r2row,
            imask, pack_params(cfg))


def _check_mxu(p4, u_p, v_p, r2row, imask, t: int):
    mp, p = p4.shape[0], u_p.shape[1]
    if t < 1 or mp == 0 or mp % t:
        raise ValueError(f"{mp} rows do not make whole tiles of {t}")
    f = torch.float32
    _check(p4.device, p4=(p4, f, (mp, 4)), u_p=(u_p, f, (mp, p)),
           v_p=(v_p, f, (mp, p)), r2row=(r2row, f, (mp,)),
           imask=(imask, f, (mp,)))
    return mp, p, mp // t


def live_tiles(imask, t: int):
    """bool [nt]: the tiles of ``t`` rows that hold a row with imask > 0
    (the kernel finds the same by a vote inside each block)."""
    return (imask.reshape(-1, t) > 0).any(1)


def mxu_sweep(p4, u_p, v_p, r2row, imask, params, law: str, fast: bool,
              t: int):
    """K5 over padded operands of mp = nt * t rows (``mxu_operands``).
    Returns ``(out_a f32[mp, 3], out_b f32[nk, 3, mp])``, nk = nt // 2 + 1:
    the fixed-up i-side sums, and the fixed-up j-side partial of step k
    for tile (i + k) mod nt in ``out_b[k]`` (zeros where either tile is
    dead, ``live_tiles``); the forces are
    ``allpairs_sweep.tri_forces(out_a, out_b)``."""
    mp, p, nt = _check_mxu(p4, u_p, v_p, r2row, imask, t)
    if p4.device.type == "cpu":
        return mxu_sweep_ref(p4, u_p, v_p, r2row, imask, params, law, fast, t)
    _kernel_ready(p4.device, p, t)
    pf = _params(params)
    lib = _library()
    nk = nt // 2 + 1
    splits = _splits(nt, nk, p4.device)
    out_a = torch.empty((splits, mp, 3), dtype=torch.float32, device=p4.device)
    out_b = torch.empty((nk, 3, mp), dtype=torch.float32, device=p4.device)
    _launch("allpairs_mxu", lib.p3t_allpairs_mxu,
            (p4.data_ptr(), u_p.data_ptr(), v_p.data_ptr(), r2row.data_ptr(),
             imask.data_ptr(), nt, p, pf.ctypes.data_as(ctypes.c_void_p),
             out_a.data_ptr(), splits, out_b.data_ptr(), LAW_IDS[law],
             int(bool(fast))),
            p4.device, f"nt={nt}, fast={bool(fast)}", counts=KERNEL_LAUNCHES)
    return (out_a[0] if splits == 1 else out_a.sum(0)), out_b


def _fp32_matmul(a, b):
    """a @ b in full FP32: TF32's 10-bit operands would wreck the factored
    sums, whose terms are |p|-sized."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a, b)


def _mxu_tile_pairs_ref(p4i, ui, vi, mi, p4j, uj, vj, r2j, params, law: str,
                        fast: bool, diag):
    """Both directions of a batch of tile pairs in K5's form: receiver
    tiles p4i [b, t, 4] (features ui, vi, row mask mi [b, t]) against
    source tiles p4j (uj, vj, gate r2j [b, t]); ``diag`` [t, t] masks the
    index diagonal (None off the k = 0 diagonal). Returns the i-side
    sums A [b, t, 4] and the fixed-up j-side [b, t, 3]."""
    if fast:
        g4 = _fp32_matmul(p4i, p4j.transpose(1, 2))
        ni, nj = _sum3(p4i[..., :3]), _sum3(p4j[..., :3])
        d2 = torch.clamp(ni[:, :, None] + nj[:, None, :] + (2.0 - 2.0 * g4),
                         min=0.0)
    else:
        dx, dy, dz = (p4j[:, None, :, c] - p4i[:, :, None, c] for c in range(3))
        d2 = dx * dx + dy * dy + dz * dz
    valid = (d2 > 0.0) & (d2 < r2j[:, None, :])
    if diag is not None:
        valid = valid & ~diag
    parts = pair_parts(law, d2, valid, params)
    s_ij = directional_scale(parts, F.pair_coef(ui, vj))
    s_ji = torch.where(mi[:, :, None] > 0.0,
                       directional_scale(parts, F.pair_coef(vi, uj)), 0.0)
    a4 = _fp32_matmul(s_ij, p4j)
    b4 = _fp32_matmul(s_ji.transpose(1, 2), p4i)
    return a4, b4[..., :3] - p4j[..., :3] * b4[..., 3:]


def mxu_sweep_ref(p4, u_p, v_p, r2row, imask, params, law: str, fast: bool,
                  t: int):
    """Plain K5: the same (i, k) steps, guards and dead-tile skips and the
    same factored form in FP32, vectorised over blocks of receiver tiles;
    the i-side sums are fixed up once at the end, as in the kernel."""
    mp = p4.shape[0]
    nt = mp // t
    nk = nt // 2 + 1
    dev = p4.device
    tiles = [a.reshape(nt, t, -1) for a in (p4, u_p, v_p)]
    r2t, mt = r2row.reshape(nt, t), imask.reshape(nt, t)
    acc = torch.zeros((nt, t, 4), dtype=torch.float32, device=dev)
    out_b = torch.zeros((nk, 3, nt, t), dtype=torch.float32, device=dev)
    ids = torch.arange(nt, device=dev)
    eye = torch.eye(t, dtype=torch.bool, device=dev)
    live = live_tiles(imask, t)
    blk = max(1, _REF_MAX_ELEMS // (t * t))
    for k in range(nk):
        run = live & live[(ids + k) % nt]
        if 2 * k == nt:  # even nt: the half diagonal once, from i < nt/2
            run[nt // 2:] = False
        for i0 in range(0, nt, blk):
            ii = ids[i0:i0 + blk]
            jj = (ii + k) % nt
            go = run[i0:i0 + blk][:, None, None]
            (pi, ui, vi), (pj, uj, vj) = ([a[ii] for a in tiles],
                                          [a[jj] for a in tiles])
            a4, j_side = _mxu_tile_pairs_ref(pi, ui, vi, mt[ii], pj, uj, vj,
                                             r2t[jj], params, law, fast,
                                             eye if k == 0 else None)
            acc[ii] += torch.where(go, a4, 0.0)
            if k > 0:  # the k = 0 diagonal is one-sided
                out_b[k][:, jj, :] = torch.where(go, j_side,
                                                 0.0).permute(2, 0, 1)
    p3 = tiles[0][..., :3]
    out_a = (acc[..., :3] - p3 * acc[..., 3:]).reshape(mp, 3)
    return out_a, out_b.reshape(nk, 3, mp)


def pallas_allpairs_forces_mxu(positions, u, v, cfg: SimConfig, *,
                               precision: str | None = None,
                               t: int | None = None,
                               gcap: int | None = None):
    """Accumulated pair forces [N, 3] through the ghost-image triangular
    sweep K5 (same-set sweeps). ``precision``: "exact" (the default, from
    ``cfg.precision``) or "fast"; ``gcap``: the ghost capacity (then
    ``cfg.ghost_capacity``, then ``recommended_ghost_capacity``); ``t``: the
    tile, the kernel's ``KERNEL_TILE`` (the plain version takes any)."""
    n = positions.shape[0]
    if precision is None:
        precision = getattr(cfg, "precision", "exact") or "exact"
    if precision not in ("exact", "fast"):
        raise ValueError(f"precision must be 'exact' or 'fast', got "
                         f"{precision!r}")
    if cfg.wrap_forces:
        if gcap is None:
            gcap = cfg.ghost_capacity
        if gcap is None:
            gcap = recommended_ghost_capacity(cfg, n)
    t = KERNEL_TILE if t is None else t
    ops = mxu_operands(positions, u, v, cfg, gcap, t)
    out_a, out_b = mxu_sweep(*ops, cfg.force_law, precision == "fast", t)
    return tri_forces(out_a, out_b)[:n].to(positions.dtype)
