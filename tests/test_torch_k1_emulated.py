"""K1's CUDA source compiled for the CPU and held to its plain version.

``particle3d_tpu_torch/csrc/celllist_sweep.cu`` is built with g++ against
``tests/_cuda_emulation/cuda_runtime.h`` (lanes as threads, barriers for
``__syncthreads`` and warp ballots; the launch rewritten to a loop over
blocks) and called through its C entry point in a child process
(``_cuda_emulated``). This checks
the kernel's logic without a GPU: stages and their compaction, the packing
of receivers onto lanes, passes, supercells split into pieces, the halo
neighbour map, and exactly 0 on dead receiver rows. The arithmetic is the
host's, so forces are compared at the tolerance of ``chip_smoke.py`` (the
sums' order differs from the plain version's). Skipped where no g++ with
C++20's ``<barrier>`` is installed.
"""

import numpy as np
import pytest
import torch

from _cuda_emulated import Emulated, build
from particle3d_tpu_torch.config import reference_config
from particle3d_tpu_torch.ops import celllist_sweep as S
from particle3d_tpu_torch.ops.forces import pad_features, pair_features
from particle3d_tpu_torch.ops.params import LAW_IDS, pack_params
from particle3d_tpu_torch.parallel import domain_sharded as DS
from particle3d_tpu_torch.parallel import make_mesh
from particle3d_tpu_torch.state import from_numpy

K1_SIG = "p" * 7 + "i" * 7 + "p"


@pytest.fixture(scope="module")
def k1_lib(tmp_path_factory):
    """K1's source built for the CPU and loaded in a child process: a
    callable (entry point, signature, arguments, outputs, restype) on
    numpy arrays, with the kernel's entry points and the emulation's
    ``emu_set_sm_count``."""
    paths = build(tmp_path_factory.mktemp("k1_emulated"),
                  {"celllist_sweep": 1})
    if paths is None:
        pytest.skip("no g++ with C++20's <barrier> for K1's CPU emulation")
    emu = Emulated()
    yield lambda fn, sig, args, outs=(), restype="i": emu.call(
        paths["celllist_sweep"], fn, sig, args, outs, restype)
    emu.close()


@pytest.fixture(scope="module")
def k1(k1_lib):
    return lambda args, outs: k1_lib("p3t_column_sweep", K1_SIG, args, outs)


def _geometry(lib, nsc, cap, ncol, p):
    _, (out,) = lib("p3t_column_sweep_geometry", "iiiip",
                    [nsc, cap, ncol, p, np.zeros(5, np.int32)], (4,),
                    restype=None)
    return tuple(int(x) for x in out[:3])  # zr, nsub, nzb


def _run(fn, ops, cfg, nsc, cap, halo):
    out = np.full((ops[0].shape[0], 3, nsc * cap), np.nan, np.float32)
    err, (out,) = fn([*(t.numpy() for t in ops), pack_params(cfg), out,
                      LAW_IDS[cfg.force_law], int(cfg.wrap_forces), int(halo),
                      nsc, cap, ops[0].shape[0], ops[1].shape[1], None], (6,))
    assert err == 0
    return torch.from_numpy(out)


def _check(fn, ops, cfg, nsc, cap, halo=False):
    got = _run(fn, ops, cfg, nsc, cap, halo)
    want = S.column_sweep_forces_ref(*ops, pack_params(cfg), cfg.force_law,
                                     bool(cfg.wrap_forces), nsc, cap, halo=halo)
    ncol = ops[0].shape[0]
    own = (ops[4][nsc:nsc + ncol] if halo else ops[4][:ncol])[:, 0, cap:]
    live = own[:, :nsc * cap] > 0
    g, w = got.permute(0, 2, 1)[live], want.permute(0, 2, 1)[live]
    assert torch.isfinite(got).all()
    assert (got.permute(0, 2, 1)[~live] == 0).all()
    scale = w.abs().max()
    assert 0 < scale < 1e6
    assert torch.linalg.vector_norm(g - w) <= 1e-5 * torch.linalg.vector_norm(w)
    assert (g - w).abs().max() <= 1e-4 * scale
    return got


def _scene(n, w, seed, species=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-w / 2, w / 2, (n, 3)).astype(np.float32)
    return from_numpy(pos, np.zeros((n, 3), np.float32),
                      rng.integers(0, species, n).astype(np.int32),
                      device="cpu")


def _grid_ops(st, cfg, nsc, cap):
    u, v = pad_features(*pair_features(st, cfg))
    return S.prepare_columns(st.positions, u, v, cfg, nsc, cap)[:5]


@pytest.mark.parametrize("walled,cap,n,w,nsc", [
    (False, 32, 600, 16.0, 8),     # blocks of many supercells, two stages
    (True, 300, 2000, 6.0, 3),     # a supercell staged in pieces
])
def test_grid_mode_matches_plain(k1, walled, cap, n, w, nsc):
    cfg = reference_config(world_size=w)
    if walled:
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    _check(k1, _grid_ops(_scene(n, w, 2), cfg, nsc, cap), cfg, nsc, cap)


def test_grid_split_for_a_short_wave_matches_plain(k1_lib):
    """On 8 SMs (56 resident blocks) a 9^3 grid's 81 columns of one z-block
    each would fill under 1.5 waves, so the launcher splits each column into
    z-blocks of 5 and 4 supercells; on 1 SM it keeps one block a column."""
    nsc, cap, w = 9, 32, 18.0
    cfg = reference_config(world_size=w)
    ops = _grid_ops(_scene(5000, w, 4), cfg, nsc, cap)
    assert _geometry(k1_lib, nsc, cap, nsc * nsc, 8) == (9, 1, 1)
    k1_lib("emu_set_sm_count", "i", [8], restype=None)
    try:
        assert _geometry(k1_lib, nsc, cap, nsc * nsc, 8) == (5, 1, 2)
        _check(lambda a, o: k1_lib("p3t_column_sweep", K1_SIG, a, o), ops,
               cfg, nsc, cap)
    finally:
        k1_lib("emu_set_sm_count", "i", [1], restype=None)


def test_stale_receiver_row_under_lennard_jones_is_zero(k1):
    """A dead slot holding a copy of a live particle 1e-6 away would sum an
    infinite force; the kernel never evaluates it and leaves 0."""
    cfg = reference_config(world_size=8.0).replace(
        force_law="lennard_jones", lj_sigma=0.15, lj_epsilon=0.2,
        particle_effect_radius=0.5)
    lin = (np.arange(8) - 3.5) * 0.45
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    st = from_numpy(g.astype(np.float32), np.zeros_like(g, np.float32),
                    np.zeros(len(g), np.int32), device="cpu")
    cap = 16
    pos_d, u_d, post_g, vt_g, r2_g = _grid_ops(st, cfg, 8, cap)
    c, live = (int(i) for i in torch.nonzero(r2_g[:, 0, cap:-cap] > 0)[0])
    cell = r2_g[c, 0, cap + live // cap * cap:cap + (live // cap + 1) * cap]
    empty = live // cap * cap + int(torch.nonzero(cell <= 0)[0, 0])
    pos_d[c, :, empty] = pos_d[c, :, live] + 1e-6
    post_g[c, :, cap + empty] = post_g[c, :, cap + live] + 1e-6
    got = _check(k1, (pos_d, u_d, post_g, vt_g, r2_g), cfg, 8, cap)
    assert (got[c, :, empty] == 0).all()


def test_halo_split_call_at_width_16_matches_plain(k1):
    """The interior-split halo call of one rank, walled, 12 species."""
    rng = np.random.default_rng(1)
    cfg = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=8, cell_capacity=32,
        boundary="clamp", wrap_forces=False, id_count=12, colors=None,
        attraction_matrix=rng.uniform(-1, 1, (12, 12)).astype(np.float32)
    ).validate()
    st = _scene(1500, 16.0, 3, species=12)
    mesh = make_mesh(1, device="cpu")
    g = DS._geometry(cfg, mesh, st.n, None, None, None, None, None)
    data, pid, _, _, _ = DS._local_build(st, cfg, g, 0)
    aligned = (pid >= 0) & (S.bin_sid(data[:, :3], cfg, 8)
                            == torch.arange(g.s_loc) // 32)
    r2 = torch.where(aligned, 1.0, -1.0)
    pos_d, u_d, pack = DS.slab_pack(data[:, :3], data, r2, cfg, g, 0)
    ops = DS.halo_call_operands(pos_d[8:-8], u_d[8:-8], pack, cfg, 32)
    assert ops[1].shape[1] == 16
    _check(k1, ops, cfg, 8, 32, halo=True)
