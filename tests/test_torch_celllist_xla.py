"""The port's XLA-style cell list (``ops/celllist.py``, the ``celllist``
backend), the small-grid sidecar (``rect_forces``, ``sidecar_sweeps`` and
``_sidecar_apply`` below 3 supercells), ``fresh_celllist_forces`` with a
derived or tiny grid, and the ``lj_gas`` preset, against the JAX package
on the same numpy inputs.

Forces are held to the port's standard bound, relative L2 <= 1e-5 and max
abs <= 1e-4 * max|F|: both sides evaluate the same pairs with the same
formulation, so only summation order and the last bits of sqrt and
division differ.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import SimConfig, reference_config
from particle3d_tpu import simulate as jax_simulate
from particle3d_tpu.engine import step as JS
from particle3d_tpu.models import make_scene as jax_make_scene
from particle3d_tpu.ops import celllist as JC
from particle3d_tpu.ops import celllist_dense as JD
from particle3d_tpu.ops import forces as JF
from particle3d_tpu.ops import overflow as JO
from particle3d_tpu.ops.pallas_celllist import pallas_celllist_forces
from particle3d_tpu.state import from_numpy as jax_from_numpy

import particle3d_tpu_torch as P
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.engine import step as TS
from particle3d_tpu_torch.ops import celllist as TC
from particle3d_tpu_torch.ops import celllist_dense as TD
from particle3d_tpu_torch.ops import forces as TF
from particle3d_tpu_torch.ops import overflow as TO
from particle3d_tpu_torch.ops.celllist_sweep import fresh_celllist_forces
from particle3d_tpu_torch.ops.params import pack_params


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-4 * scale


def _states(pos, species, vel=None):
    pos = np.asarray(pos, np.float32)
    vel = np.zeros_like(pos) if vel is None else np.asarray(vel, np.float32)
    species = np.asarray(species, np.int32)
    return (jax_from_numpy(pos, vel, species),
            P.from_numpy(pos, vel, species, device="cpu"))


def _law_scene(law, walls, n, seed):
    """(JAX config, JAX state, port state): particle life uniform in a box
    of 16 (8^3 cells of 2); Lennard-Jones on a jittered lattice of spacing
    0.45 in a box of 8 (10^3 cells of 0.8), whose pairs would otherwise
    meet the steep core."""
    rng = np.random.default_rng(seed)
    if law == "particle_life":
        cfg = reference_config(world_size=16.0)
        pos = rng.uniform(-8, 8, (n, 3))
    else:
        cfg = SimConfig(force_law="lennard_jones", lj_sigma=0.3,
                        lj_epsilon=0.5, particle_effect_radius=0.8,
                        world_size=8.0).validate()
        side = int(np.ceil(n ** (1 / 3)))
        lin = (np.arange(side) - side / 2) * 0.45
        g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
        pos = g.reshape(-1, 3)[:n] + rng.normal(0, 0.04, (n, 3))
    if walls:
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    return (cfg, *_states(pos, rng.integers(0, 5, n)))


@pytest.mark.parametrize("law,walls,group", [
    (law, walls, g) for law in ("particle_life", "lennard_jones")
    for walls in (False, True) for g in (1, 2)])
def test_celllist_forces_match_jax(law, walls, group):
    cfg, jst, tst = _law_scene(law, walls, 1500, 7)
    tcfg = from_jax_config(cfg)
    nc = TC.grid_dims(float(tcfg.world_size),
                      float(tcfg.particle_effect_radius))
    assert nc == JC.grid_dims(float(cfg.world_size),
                              float(cfg.particle_effect_radius))
    # capacity above the fullest cell: no particle is dropped
    cap = -(-(TC.celllist_stats(tst.positions, tcfg)[0] + 1) // 8) * 8
    assert (TC.celllist_stats(tst.positions, tcfg, capacity=cap)
            == JC.celllist_stats(jst.positions, cfg, capacity=cap))
    ju, jv = JF.pair_features(jst, cfg)
    tu, tv = TF.pair_features(tst, tcfg)
    want = JC.celllist_forces(jst.positions, ju, jv, cfg, capacity=cap,
                              group=group, cell_batch=256)
    got = TC.celllist_forces(tst.positions, tu, tv, tcfg, capacity=cap,
                             group=group, cell_batch=256)
    _close(got, want)


def test_build_cell_list_matches_jax():
    cfg, jst, tst = _law_scene("particle_life", False, 700, 3)
    got = TC.build_cell_list(tst.positions, from_jax_config(cfg), 8, 4)
    want = JC.build_cell_list(jst.positions, cfg, 8, 4)  # overflows
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for wrap in (True, False):
        for g, w in zip(TC._supercell_tables(8, 2, wrap),
                        JC._supercell_tables(8, 2, wrap)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _slot_arrays(seed, s=600, m=24):
    """Slot rows with phantom (invalid) rows, and a misplaced set with
    padding rows, on particle life in a box of 10."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-5, 5, (s, 3)).astype(np.float32)
    u = rng.uniform(-1, 1, (s, 8)).astype(np.float32)
    v = rng.uniform(0, 1, (s, 8)).astype(np.float32)
    ok = rng.uniform(size=s) < 0.8
    idx = rng.choice(s, m, replace=False)
    mvalid = np.arange(m) < m - 5
    return pos, u, v, ok, idx, mvalid


def test_rect_forces_and_sidecar_sweeps_match_jax():
    cfg = reference_config()
    tcfg = from_jax_config(cfg)
    pos, u, v, ok, idx, mvalid = _slot_arrays(11)
    t = torch.from_numpy
    for blocks in ((65536, 65536), (64, 128)):
        want = JO.rect_forces(pos[:50], u[:50], pos, v, jnp.asarray(ok), cfg,
                              *blocks)
        got = TO.rect_forces(t(pos[:50]), t(u[:50]), t(pos), t(v), t(ok),
                             tcfg, *blocks)
        _close(got, want)
    mpos, mu, mv = pos[idx], u[idx], v[idx]
    for block in (65536, 100):
        want = JO.sidecar_sweeps(pos, u, v, jnp.asarray(ok), mpos, mu, mv,
                                 jnp.asarray(mvalid), cfg, block=block)
        got = TO.sidecar_sweeps(t(pos), t(u), t(v), t(ok), t(mpos), t(mu),
                                t(mv), t(mvalid), tcfg, block=block)
        for g, w in zip(got, want):
            _close(g, w)


def test_small_grid_sidecar_apply_matches_jax():
    """``_sidecar_apply`` below 3 supercells (the dense sweeps over every
    slot) on a 2^3 layout whose cells overflow, against JAX's branch on
    the same layout."""
    rng = np.random.default_rng(5)
    cfg = reference_config(world_size=10.0)
    n, nsc, cap, ocap = 160, 2, 16, 64
    jst, tst = _states(rng.uniform(-5, 5, (n, 3)), rng.integers(0, 5, n))
    tcfg = from_jax_config(cfg)
    tds = TD.build_dense(tst, tcfg, nsc, cap, ocap)
    jds = JD.DenseSim(*(jnp.asarray(getattr(tds, f).numpy())
                        for f in ("data", "feat", "pid", "r2")))
    tmis = TD.sidecar_indices(tds, ocap)
    jmis = jnp.asarray(tmis.numpy())
    assert int((tmis < tds.pid.shape[0]).sum()) > 0  # the sidecar has work
    f0 = rng.normal(size=(tds.pid.shape[0], 3)).astype(np.float32)
    valid = (jds.r2 > 0.0).astype(jnp.float32)[:, None]
    want = JS._sidecar_apply(jnp.asarray(f0) * valid, jds.pos, jds, jmis,
                             cfg, valid, nsc, cap)
    f0t = torch.from_numpy(f0) * (tds.r2 > 0.0).float()[:, None]
    got = TS._sidecar_apply(f0t, tds.pos, tds, tmis, tcfg, nsc, cap)
    _close(got, want)


@pytest.mark.parametrize("grid", [2, None])
def test_fresh_celllist_forces_small_or_derived_grid(grid):
    """``cell_grid=2`` falls back to the XLA-style cell list (all-pairs
    below 3 cells); unset grid and capacity are derived as in the JAX
    package (here grid 3, capacity default_capacity(n, 3, slack=2.5) = 32,
    which no cell fills: the sidecar is off, as it has no work here)."""
    cfg = reference_config(world_size=6.0).replace(
        neighbor="celllist_pallas", cell_grid=grid, overflow_capacity=0)
    rng = np.random.default_rng(8)
    n = 300
    jst, tst = _states(rng.uniform(-3, 3, (n, 3)), rng.integers(0, 5, n))
    tcfg = from_jax_config(cfg)
    ju, jv = JF.pair_features(jst, cfg)
    tu, tv = TF.pair_features(tst, tcfg)
    want = pallas_celllist_forces(jst.positions, ju, jv, cfg, interpret=True)
    got = fresh_celllist_forces(tst.positions, tu, tv, tcfg)
    _close(got, want)


def test_lj_gas_matches_jax():
    """``lj_gas`` at N=4,096 (the XLA-style cell list on an 8^3 grid,
    velocity Verlet), 4 steps from the JAX scene, against JAX's simulate."""
    jst, jcfg, jdt = jax_make_scene("lj_gas", n=4096)
    st, cfg, dt = P.make_scene("lj_gas", n=4096, device="cpu")
    want_cfg = from_jax_config(jcfg)
    for f in ("neighbor", "cell_grid", "cell_capacity", "integrator",
              "force_law", "boundary"):
        assert getattr(cfg, f) == getattr(want_cfg, f), f
    np.testing.assert_array_equal(pack_params(cfg), pack_params(want_cfg))
    assert dt == jdt and cfg.neighbor == "celllist" and cfg.cell_grid == 8
    tst = P.from_jax_state(jst, device="cpu")
    want = jax_simulate(jst, jcfg, jnp.float32(jdt), 4)
    got = P.simulate(tst, cfg, dt, 4)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.velocities.numpy(),
                               np.asarray(want.velocities), rtol=1e-4,
                               atol=1e-6)
