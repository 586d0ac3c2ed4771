"""K2's and K5's CUDA source compiled for the CPU and held to their plain
versions.

``particle3d_tpu_torch/csrc/allpairs_sweep.cu`` and ``allpairs_mxu.cu``
(their shared tile-pair sweep ``tile_pair_mma.cuh``) are built with g++
against ``tests/_cuda_emulation/cuda_runtime.h``: lanes as threads,
barriers for ``__syncthreads``, the warp shuffles and the warp-wide
``mma.sync.m16n8k8`` TF32 product in the hardware's fragment layout, and
``cvt.rna.tf32.f32`` rounding as the hardware does; each launch is
rewritten to a loop over blocks. The kernels are called through their C
entry points in a child process (``_cuda_emulated``). This checks the
logic without a GPU: the 3xTF32 split and fragment ownership, the pairs
each lane evaluates, the deferred lane sums, k-spans, odd and even tile
counts, the k = 0 diagonal, mask mode, padded rows under Lennard-Jones
and K5's dead ghost tiles. Tolerances are ``chip_smoke.py``'s (the sums'
order differs from the plain versions'). Skipped where no g++ with
C++20's ``<barrier>`` is installed.
"""

import numpy as np
import pytest
import torch

from _cuda_emulated import Emulated, build
from particle3d_tpu_torch.config import SimConfig, reference_config
from particle3d_tpu_torch.ops import allpairs_mxu_sweep as M
from particle3d_tpu_torch.ops import allpairs_sweep as A
from particle3d_tpu_torch.ops.forces import pair_features
from particle3d_tpu_torch.ops.params import LAW_IDS
from particle3d_tpu_torch.state import from_numpy

T = A.KERNEL_TILE
# chip_smoke.py's gates: (relative L2 or None, max abs as a share of max|F|)
K2_TOL = (1e-5, 1e-4)
K5_TOL = (3e-5, 1e-4)
FAST_TOL = (None, 3e-3)
TRI_SIG = "p" * 6 + "iiippipiip"
MXU_SIG = "p" * 5 + "iippipiip"


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """K2-K4's and K5's sources built for the CPU (in parallel), loaded in
    one child process: (tri entry point, mxu entry point) as callables on
    numpy arrays."""
    paths = build(tmp_path_factory.mktemp("allpairs_emulated"),
                  {"allpairs_sweep": 3, "allpairs_mxu": 1})
    if paths is None:
        pytest.skip("no g++ with C++20's <barrier> for the CPU emulation")
    emu = Emulated()

    def entry(lib, fn, sig):
        return lambda args, outs: emu.call(paths[lib], fn, sig, args, outs)

    yield (entry("allpairs_sweep", "p3t_allpairs_tri", TRI_SIG),
           entry("allpairs_mxu", "p3t_allpairs_mxu", MXU_SIG))
    emu.close()


def _gate(got, want, tol):
    rel_l2, max_abs = tol
    assert torch.isfinite(got).all()
    scale = want.abs().max()
    assert 0 < scale < 1e6
    if rel_l2 is not None:
        err = torch.linalg.vector_norm(got - want)
        assert err <= rel_l2 * torch.linalg.vector_norm(want)
    assert (got - want).abs().max() <= max_abs * scale


def _state(pos, species, masses=None):
    n = len(pos)
    return from_numpy(np.asarray(pos, np.float32), np.zeros((n, 3), np.float32),
                      np.asarray(species, np.int32), masses, device="cpu")


def _uniform(n, w, seed, species=5):
    rng = np.random.default_rng(seed)
    return _state(rng.uniform(-w / 2, w / 2, (n, 3)),
                  rng.integers(0, species, n))


def _wide(cfg, species=12, seed=3):
    rng = np.random.default_rng(seed)
    return cfg.replace(id_count=species, colors=None,
                       attraction_matrix=rng.uniform(-1, 1, (species, species))
                       .astype(np.float32)).validate()


def _k2(tri, st, cfg, splits=1, mask=None):
    """K2's C entry point and its plain version on the same operands:
    (forces, plain forces) for the N rows."""
    u, v = pair_features(st, cfg)
    ops = A.tri_operands(st.positions, u, v, cfg, T)
    np_, p = ops[0].shape[0], ops[1].shape[1]
    nt = np_ // T
    nk = nt // 2 + 1
    out_a = np.full((splits, np_, 3), np.nan, np.float32)
    out_b = np.full((nk, 3, np_), np.nan, np.float32)
    err, (out_a, out_b) = tri(
        [*(x.numpy() for x in ops[:5]),
         mask.numpy() if mask is not None else None, -(-nk // 32), nt, p,
         ops[5], out_a, splits, out_b, LAW_IDS[cfg.force_law],
         int(cfg.wrap_forces), None], (10, 12))
    assert err == 0
    out_a, out_b = torch.from_numpy(out_a), torch.from_numpy(out_b)
    args = (cfg.force_law, bool(cfg.wrap_forces), T)
    want = A.tri_sweep_ref(*ops, *args, mask=mask)
    n = st.n
    return (A.tri_forces(out_a.sum(0), out_b)[:n],
            A.tri_forces(*want)[:n])


@pytest.mark.parametrize("label,n,splits", [
    ("particle_life", 600, 2),      # 5 tiles: odd nt, ragged last tile
    ("walled", 1000, 1),            # 8 tiles: even nt, half diagonal once
    ("lennard_jones", 900, 1),      # the IEEE law, a jittered lattice
    ("gravity", 700, 1),            # split masses: two feature columns
    ("wide", 520, 1),               # 12 species: feature width 16
])
def test_k2_matches_plain(libs, label, n, splits):
    cfg = reference_config(world_size=6.0)
    st = _uniform(n, 6.0, 1)
    if label == "walled":
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    elif label == "lennard_jones":
        cfg = cfg.replace(force_law="lennard_jones", particle_effect_radius=0.5,
                          lj_sigma=0.1, lj_epsilon=0.5)
        lin = (np.arange(10) + 0.5) * 0.6 - 3.0
        g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
        g = g.reshape(-1, 3) + np.random.default_rng(2).normal(0, 0.05, (1000, 3))
        st = _state(g[:n], np.zeros(n))
    elif label == "gravity":
        cfg = cfg.replace(force_law="gravity", gravity_softening=0.05,
                          particle_effect_radius=2.0)
        st = _state(st.positions.numpy(), np.zeros(n),
                    masses=np.random.default_rng(4).uniform(0.5, 2.0, n))
    elif label == "wide":
        cfg = _wide(cfg)
        st = _uniform(n, 6.0, 5, species=12)
    _gate(*_k2(libs[0], st, cfg, splits), K2_TOL)


def test_k2_mask_mode_matches_plain(libs):
    """Two clusters 16 apart along z, Morton-sorted: the steps between
    them are culled (42% of 42)."""
    cfg = reference_config(world_size=30.0)
    rng = np.random.default_rng(6)
    pos = rng.uniform(-1.5, 1.5, (1500, 3))
    pos[:, 2] += np.where(np.arange(1500) < 750, -8.0, 8.0)
    keys = A.morton_keys(torch.as_tensor(pos, dtype=torch.float32),
                         cfg.world_size)
    order = torch.argsort(keys, stable=True).numpy()
    st = _state(pos[order], rng.integers(0, 5, 1500))
    np_ = -(-st.n // T) * T
    mask, frac = A.culled_tile_mask(A._pad_rows(st.positions, np_), st.n, T,
                                    cfg)
    assert float(frac) < 0.6
    _gate(*_k2(libs[0], st, cfg, mask=mask), K2_TOL)


def test_k2_padded_rows_at_origin_under_lennard_jones(libs):
    """84 padded rows at the origin and a particle 1e-4 from them: the
    padded rows' infinite scales are selected out of the j-side."""
    cfg = SimConfig(force_law="lennard_jones", lj_sigma=0.1, lj_epsilon=0.5,
                    particle_effect_radius=0.5, world_size=10.0,
                    wrap_forces=True).validate()
    lin = (np.arange(7) - 3) * 0.45 + 0.2
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = np.concatenate([[[1e-4, 0.0, 0.0]], g[:299]
                          + np.random.default_rng(12).normal(0, 0.01, (299, 3))])
    got, want = _k2(libs[0], _state(pos, np.zeros(300)), cfg)
    _gate(got, want, K2_TOL)


def _k5(mxu, st, cfg, fast, gcap, splits=1):
    """K5's C entry point and its plain version: (forces, plain forces,
    out_b, live tiles)."""
    u, v = pair_features(st, cfg)
    ops = M.mxu_operands(st.positions, u, v, cfg, gcap, T)
    mp, p = ops[0].shape[0], ops[1].shape[1]
    nt = mp // T
    nk = nt // 2 + 1
    out_a = np.full((splits, mp, 3), np.nan, np.float32)
    out_b = np.full((nk, 3, mp), np.nan, np.float32)
    err, (out_a, out_b) = mxu(
        [*(x.numpy() for x in ops[:5]), nt, p, ops[5], out_a, splits, out_b,
         LAW_IDS[cfg.force_law], int(fast), None], (8, 10))
    assert err == 0
    out_a, out_b = torch.from_numpy(out_a), torch.from_numpy(out_b)
    want = M.mxu_sweep_ref(*ops, cfg.force_law, fast, T)
    n = st.n
    return (M.tri_forces(out_a.sum(0), out_b)[:n],
            M.tri_forces(*want)[:n], out_b, M.live_tiles(ops[4], T))


@pytest.mark.parametrize("fast,splits", [(False, 1), (True, 2)])
def test_k5_with_dead_ghost_tiles_matches_plain(libs, fast, splits):
    """400 particles in a box of 5: ~600 ghosts in a capacity of 1,280, so
    the last of 14 tiles hold only invalid ghosts and padding and are
    skipped; their j-side blocks are exactly 0."""
    cfg = reference_config(world_size=5.0)
    st = _uniform(400, 5.0, 7)
    count = int(M.ghost_count(st.positions, cfg))
    gcap = 1280
    assert count + 2 * T < gcap
    got, want, out_b, live = _k5(libs[1], st, cfg, fast, gcap, splits)
    assert int(live.sum()) < live.numel()
    _gate(got, want, FAST_TOL if fast else K5_TOL)
    dead = (~live).repeat_interleave(T)
    assert (out_b[:, :, dead] == 0).all()


def test_k5_walled_wide_features_matches_plain(libs):
    """Walls (no ghosts) and 12 species: feature width 16, 7 tiles."""
    cfg = _wide(reference_config(world_size=6.0)).replace(
        boundary="clamp", wrap_forces=False)
    st = _uniform(800, 6.0, 8, species=12)
    got, want, _, _ = _k5(libs[1], st, cfg, False, None)
    _gate(got, want, K5_TOL)
