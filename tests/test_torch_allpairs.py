"""The port's all-pairs sweeps (K3 rectangular, K2 triangular; plain
versions on the CPU) against the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs.

Tolerances are the JAX package's own for these kernels against the dense
path (tests/test_pallas_allpairs.py): rtol 3e-4 / atol 3e-5, and rtol
1e-3 / atol 1e-4 for Lennard-Jones, whose steep core amplifies rounding.
Both sides use the same formulation per kernel, so the differences are
summation order and the last bits of sqrt and division.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import SimConfig, reference_config
from particle3d_tpu.engine.step import step as jax_step
from particle3d_tpu.ops import forces as JF
from particle3d_tpu.ops import pallas_allpairs as JA
from particle3d_tpu.state import from_numpy as jax_from_numpy

import particle3d_tpu_torch as P
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.ops import allpairs_mxu_sweep as M
from particle3d_tpu_torch.ops import allpairs_sweep as A
from particle3d_tpu_torch.ops import forces as TF
from particle3d_tpu_torch.ops.params import pack_params


def _law_cfg(law):
    if law == "gravity":
        return SimConfig(force_law="gravity", gravity_constant=1.5,
                         gravity_softening=0.3, particle_effect_radius=4.0,
                         world_size=20.0, wrap_forces=True).validate()
    if law == "lennard_jones":
        return SimConfig(force_law="lennard_jones", lj_epsilon=1.0,
                         lj_sigma=0.3, particle_effect_radius=1.5,
                         world_size=12.0, wrap_forces=False).validate()
    if law == "spring":
        return SimConfig(force_law="spring", spring_stiffness=2.5,
                         spring_rest_length=0.4, particle_effect_radius=1.0,
                         world_size=10.0).validate()
    if law == "walled":
        return reference_config().replace(wrap_forces=False)
    return reference_config()


def _scene(cfg, n, seed, k=5):
    """Uniform points for particle life and springs; a jittered lattice for
    gravity and Lennard-Jones, whose near-coincident pairs would make the
    comparison ill-conditioned (as in the JAX tests)."""
    rng = np.random.default_rng(seed)
    w = float(np.asarray(cfg.world_size))
    if cfg.force_law in ("gravity", "lennard_jones"):
        side = int(np.ceil(n ** (1 / 3)))
        spacing = 0.6 * float(np.asarray(cfg.particle_effect_radius))
        lin = (np.arange(side) - (side - 1) / 2) * spacing
        g = np.stack(np.meshgrid(lin, lin, lin), -1).reshape(-1, 3)[:n]
        pos = g + rng.normal(0, 0.05 * spacing, g.shape)
    else:
        pos = rng.uniform(-w / 2, w / 2, (n, 3))
    pos = pos.astype(np.float32)
    species = rng.integers(0, k, n).astype(np.int32)
    masses = rng.uniform(0.5, 2.0, n).astype(np.float32)
    zeros = np.zeros_like(pos)
    return (jax_from_numpy(pos, zeros, species, masses=masses),
            P.from_numpy(pos, zeros, species, masses=masses, device="cpu"))


def _features(cfg, n, seed, k=5):
    jst, tst = _scene(cfg, n, seed, k)
    ju, jv = JF.pair_features(jst, cfg)
    tu, tv = TF.pair_features(tst, from_jax_config(cfg))
    return jst, ju, jv, tst, tu, tv


def _tol(cfg):
    return ((1e-3, 1e-4) if cfg.force_law == "lennard_jones"
            else (3e-4, 3e-5))


def _close(got, want, cfg):
    rtol, atol = _tol(cfg)
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("law,n", [
    ("particle_life", 32), ("particle_life", 100), ("particle_life", 513),
    ("walled", 200), ("gravity", 150), ("lennard_jones", 128),
    ("spring", 200)])
def test_rect_sweep_matches_jax(law, n):
    cfg = _law_cfg(law)
    jst, ju, jv, tst, tu, tv = _features(cfg, n, n)
    want = JA.pallas_allpairs_forces(jst.positions, ju, jv, cfg)
    got = A.pallas_allpairs_forces(tst.positions, tu, tv, from_jax_config(cfg))
    _close(got, want, cfg)


def test_rect_sweep_against_another_source_set():
    cfg = reference_config()
    jst, ju, jv, tst, tu, tv = _features(cfg, 300, 4)
    want = JA.pallas_allpairs_forces(jst.positions[:70], ju[:70], jv, cfg,
                                     src_positions=jst.positions[70:],
                                     src_v=jv[70:])
    got = A.pallas_allpairs_forces(tst.positions[:70], tu[:70], tv,
                                   from_jax_config(cfg),
                                   src_positions=tst.positions[70:],
                                   src_v=tv[70:])
    _close(got, want, cfg)


@pytest.mark.parametrize("law,n,t", [
    ("particle_life", 200, 64), ("walled", 300, 64), ("gravity", 150, 64),
    ("lennard_jones", 216, 64), ("spring", 200, 64),
    # tile-count edges: nt = 2 (even-nt half diagonal), odd nt, ragged pad
    ("particle_life", 128, 64), ("particle_life", 96, 48),
    ("particle_life", 260, 64)])
def test_tri_sweep_matches_jax(law, n, t):
    cfg = _law_cfg(law)
    jst, ju, jv, tst, tu, tv = _features(cfg, n, n + t)
    want = JA.pallas_allpairs_forces_tri(jst.positions, ju, jv, cfg, t=t)
    got = A.pallas_allpairs_forces_tri(tst.positions, tu, tv,
                                       from_jax_config(cfg), t=t)
    _close(got, want, cfg)


def test_many_species_wide_features():
    """id_count = 12 > PAIR_P: the port pads the features to 16 columns."""
    rng = np.random.default_rng(77)
    cfg = SimConfig(id_count=12, world_size=10.0).validate().replace(
        attraction_matrix=rng.uniform(-1, 1, (12, 12)).astype(np.float32))
    jst, ju, jv, tst, tu, tv = _features(cfg, 200, 77, k=12)
    assert tu.shape[1] == 12
    tcfg = from_jax_config(cfg)
    _close(A.pallas_allpairs_forces(tst.positions, tu, tv, tcfg),
           JA.pallas_allpairs_forces(jst.positions, ju, jv, cfg), cfg)
    _close(A.pallas_allpairs_forces_tri(tst.positions, tu, tv, tcfg, t=64),
           JA.pallas_allpairs_forces_tri(jst.positions, ju, jv, cfg, t=64),
           cfg)


@pytest.mark.parametrize("n", [256, 2048])
def test_allpairs_pallas_step_matches_jax(n):
    """One step on the ``allpairs_pallas`` backend: K3 below N=2,048, K2
    from there (the JAX dispatch), against the JAX package's step."""
    cfg = reference_config().replace(neighbor="allpairs_pallas")
    jst, tst = _scene(cfg, n, 21)
    jout = jax_step(jst, cfg, jnp.float32(1 / 60))
    tout = P.step(tst, from_jax_config(cfg), 1 / 60)
    np.testing.assert_allclose(tout.positions.numpy(),
                               np.asarray(jout.positions), rtol=1e-4, atol=1e-5)


def test_dispatch_and_cpu_launches_no_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(A, "tri_sweep", lambda *a, **k: calls.append("K2")
                        or A.tri_sweep_ref(*a, **k))
    monkeypatch.setattr(A, "rect_sweep", lambda *a, **k: calls.append("K3")
                        or A.rect_sweep_ref(*a, **k))
    cfg = from_jax_config(reference_config())
    for n in (A.TRI_MIN_N - 1, A.TRI_MIN_N):
        st = P.make_scene("reference", seed=1, n=n, device="cpu")[0]
        u, v = TF.pair_features(st, cfg)
        A.pallas_allpairs_forces(st.positions, u, v, cfg)
    assert calls == ["K3", "K2"]
    assert all(c == 0 for c in A.KERNEL_LAUNCHES.values())


def test_kernel_wrappers_check_operands_and_never_fall_back():
    """Operand errors raise; a tensor on a device that is neither the CPU
    nor CUDA raises instead of taking the plain version."""
    cfg = from_jax_config(reference_config())
    pf = pack_params(cfg)
    n = 64
    pos, u = torch.zeros((n, 3)), torch.zeros((n, 8))
    r2 = torch.ones(n)
    with pytest.raises(ValueError, match="want"):
        A.rect_sweep(pos, u, pos, u[:, :4], r2, pf, "particle_life", True)
    meta = [x.to("meta") for x in (pos, u, pos, u, r2)]
    with pytest.raises(ValueError, match="no all-pairs kernel"):
        A.rect_sweep(*meta, pf, "particle_life", True)
    with pytest.raises(ValueError, match="whole tiles"):
        A.tri_sweep(pos, u, u, r2, r2, pf, "particle_life", True, t=48)
    mask = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="mask"):
        A.tri_sweep(pos, u, u, r2, r2, pf, "particle_life", True, t=32,
                    mask=mask)
    w = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no all-pairs kernel"):
        A.pairlist_sweep(*meta[:2], meta[1], meta[4], meta[4], w, w, pf,
                         "particle_life", True, 32)
    p4 = torch.zeros((n, 4))
    with pytest.raises(ValueError, match="no all-pairs kernel"):
        M.mxu_sweep(*[x.to("meta") for x in (p4, u, u, r2, r2)], pf,
                    "particle_life", False, 32)
    with pytest.raises(ValueError, match="want"):
        M.mxu_sweep(pos, u, u, r2, r2, pf, "particle_life", False, 32)
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="feature width"):
        A._kernel_ready(cuda, 12)
    with pytest.raises(ValueError, match="tile"):
        A._kernel_ready(cuda, 8, t=64)



def _padded_origin_scene():
    """N = 300 at t = 128 (the kernels' tile): 84 padded rows at the origin,
    in the last of three tiles. Lennard-Jones in a periodic box of 10, one
    real particle at (1e-4, 0, 0) in tile 0, the other 299 on a lattice at
    least 0.35 from it. K2's step k = 1 sweeps tile 2's rows, padded ones
    included, as receivers against tile 0; with two tiles (N = 100 at
    t = 64) the padded tile would only ever be a source, and the fault
    would not show."""
    cfg = SimConfig(force_law="lennard_jones", lj_sigma=0.1, lj_epsilon=0.5,
                    particle_effect_radius=0.5, world_size=10.0,
                    wrap_forces=True).validate()
    lin = (np.arange(7) - 3) * 0.45 + 0.2
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(12)
    pos = np.concatenate([[[1e-4, 0.0, 0.0]], g[:299]
                          + rng.normal(0, 0.01, (299, 3))]).astype(np.float32)
    zeros = np.zeros_like(pos)
    st = P.from_numpy(pos, zeros, np.zeros(300, np.int32), device="cpu")
    return from_jax_config(cfg), st


@pytest.mark.parametrize("kernel", ["tri", "pairlist"])
def test_padded_rows_at_origin_stay_inert(kernel):
    """A padded row at the origin and a real particle 1e-4 from it: under
    Lennard-Jones their pair's scale is infinite. K2's and K4's j-side must
    select the padded row away (inf * 0 would be NaN in the real row's
    force), and the real rows match the plain all-pairs oracle. K4 runs the
    lower-triangular worklist (each tile against the tiles before it), so
    that the padded tile is a receiver; the survival mask's upper triangle
    never makes it one."""
    from particle3d_tpu_torch.ops.allpairs import allpairs_forces

    cfg, st = _padded_origin_scene()
    n, t = st.n, A.KERNEL_TILE
    u, v = TF.pair_features(st, cfg)
    ops = A.tri_operands(st.positions, u, v, cfg, t)
    nt = ops[0].shape[0] // t
    assert (nt, ops[0].shape[0] - n) == (3, 84)
    args = (cfg.force_law, True, t)
    if kernel == "tri":
        got = A.tri_forces(*A.tri_sweep_ref(*ops, *args))[:n]
    else:
        wi, wj = (torch.tensor(a, dtype=torch.int32) for a in
                  zip(*[(i, j) for i in range(nt) for j in range(i + 1)]))
        out_a, out_b = A.pairlist_sweep_ref(*ops[:5], wi, wj, ops[5], *args)
        got = A.pairlist_forces(out_a, out_b, wj)[:n]
    assert bool(torch.isfinite(got).all())
    want = allpairs_forces(st.positions, u, v, cfg)
    assert want.abs().max() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_bounds_count_coefficients_at_the_tf32_rate():
    """The restated bound (utils/bounds.py): K2 at N=262,144 and K5 over
    the 303,298 live rows of particle_life_large_allpairs, with five-species
    coefficients at the TF32 rate, against the FP32-only count."""
    from particle3d_tpu_torch.utils.bounds import (bound, ops_mxu,
                                                   ops_two_sided)

    n, m = 262_144, 303_298
    k2 = bound(n * (n - 1) / 2, ops_two_sided(5, True), 0)
    k5 = bound(m * (m - 1) / 2, ops_mxu(5, False), 0)
    assert k2[1] == k5[1] == "operations"
    assert abs(k2[0] - 22.56) < 0.01 and abs(k2[2] - 32.82) < 0.01
    assert abs(k5[0] - 28.15) < 0.01
    assert bound(1, (0, 0), 3.35e12)[:2] == (1e3, "bytes")
