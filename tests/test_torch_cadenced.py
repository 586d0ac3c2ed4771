"""The port's cadenced cell layout (``CellLayout``, ``dense_forces``,
``layout_forces``, ``drift_budget``) and its two drivers on it,
``simulate_cadenced`` and ``simulate_dense_carry``, against the JAX
package on the same numpy inputs.

JAX's K1 runs in Pallas interpret mode; the port's K1 takes its plain
version on CPU tensors. Forces: relative L2 <= 1e-5 on occupied slots
(the JAX kernel leaves garbage on empty slots, the port's exactly 0).
Trajectories: rtol 1e-4 / atol 1e-5 on positions, the tolerance of
``test_torch_main_path.py`` (a few chaotic steps amplify the force sums'
last-bit differences); drift within 1e-6; dropped counts equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import reference_config
from particle3d_tpu.engine import step as JE
from particle3d_tpu.ops import celllist_dense as JD
from particle3d_tpu.ops import pallas_celllist as JPC
from particle3d_tpu.ops.forces import pair_features as jax_pair_features
from particle3d_tpu.state import from_numpy as jax_from_numpy

import particle3d_tpu_torch as P
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.engine import step as TE
from particle3d_tpu_torch.ops import celllist_dense as TD
from particle3d_tpu_torch.ops import celllist_sweep as TS
from particle3d_tpu_torch.ops.forces import pair_features

NSC, W, DT = 8, 16.0, 1 / 60
CAP = 16  # ~2 particles a cell at these N: no build drops unless clumped


def _cfg(law="particle_life", walled=False, **kw):
    kw = {"neighbor": "celllist_pallas", "cell_grid": NSC,
          "cell_capacity": CAP, **kw}
    cfg = reference_config(world_size=W).replace(**kw)
    if law == "lennard_jones":
        cfg = cfg.replace(force_law="lennard_jones", particle_effect_radius=0.5,
                          lj_sigma=0.08, lj_epsilon=0.5)
    if walled:
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    return cfg


def _states(n, seed, clump=0, speed=0.3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    if clump:  # cram ``clump`` particles into one cell: the build drops some
        pos[:clump] = np.float32(1.1) + rng.uniform(0, 0.3, (clump, 3))
    vel = rng.normal(0, speed, (n, 3)).astype(np.float32)
    sp = rng.integers(0, 5, n).astype(np.int32)
    return (jax_from_numpy(pos, vel, sp),
            P.from_numpy(pos, vel, sp, device="cpu"))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _layouts(jst, tst, cfg, cap=CAP):
    ju, jv = jax_pair_features(jst, cfg)
    tcfg = from_jax_config(cfg)
    tu, tv = pair_features(tst, tcfg)
    jl = JPC.build_layout(jst.positions, ju, jv, cfg, NSC, cap)
    tl = TS.build_layout(tst.positions, tu, tv, tcfg, NSC, cap)
    return jl, tl, tcfg


@pytest.mark.parametrize("law,walled", [
    ("particle_life", False), ("particle_life", True),
    ("lennard_jones", False), ("lennard_jones", True)])
def test_dense_and_layout_forces_match_jax(law, walled):
    cfg = _cfg(law, walled)
    jst, tst = _states(1000, 1)
    jl, tl, tcfg = _layouts(jst, tst, cfg)
    np.testing.assert_array_equal(tl.slot_particle.numpy(),
                                  np.asarray(jl.slot_particle))
    for name in ("u_d", "vt_g", "r2_g"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)), name)
    # positions into the slots, moved by a drift inside the budget, so the
    # layout is stale and periodic wrap crossers need the fold
    rng = np.random.default_rng(2)
    moved = np.asarray(jst.positions) + rng.uniform(-0.3, 0.3, (1000, 3)).astype(np.float32)
    if walled:
        moved = np.clip(moved, -W / 2, W / 2)
    else:
        moved = (moved + W / 2) % W - W / 2
    slot = tl.slot_particle.reshape(-1).numpy()
    occ = slot >= 0
    flat = np.where(occ[:, None], moved[np.maximum(slot, 0)], 0).astype(np.float32)
    want = np.asarray(JPC.dense_forces(jl, jnp.asarray(flat), cfg, NSC, CAP))
    got = TS.dense_forces(tl, torch.tensor(flat), tcfg, NSC, CAP).numpy()
    assert _rel_l2(got[occ], want[occ]) <= 1e-5
    assert (got[~occ] == 0).all()
    want_p = np.asarray(JPC.layout_forces(jl, jnp.asarray(moved), cfg, NSC, CAP))
    got_p = TS.layout_forces(tl, torch.tensor(moved), tcfg, NSC, CAP).numpy()
    assert _rel_l2(got_p, want_p) <= 1e-5


@pytest.mark.parametrize("walled", [False, True])
def test_layout_forces_on_a_fresh_build_equal_the_fresh_path(walled):
    """Inside the port: the same K1 on the same operands, the cached
    features and gates against rebuilt ones, each particle's force landing
    on a zero row: bit-identical."""
    cfg = from_jax_config(_cfg(walled=walled, overflow_capacity=0))
    _, tst = _states(1000, 3)
    u, v = pair_features(tst, cfg)
    lay = TS.build_layout(tst.positions, u, v, cfg, NSC, CAP)
    assert torch.equal(TS.layout_forces(lay, tst.positions, cfg, NSC, CAP),
                       TS.fresh_celllist_forces(tst.positions, u, v, cfg))


@pytest.mark.parametrize("cfg", [
    _cfg(), _cfg(cell_grid=5), _cfg("lennard_jones"),
    _cfg(particle_effect_radius=0.7, cell_grid=16),
    _cfg().replace(force_law="spring", particle_effect_radius=1.5)],
    ids=["life", "life_grid5", "lj", "life_r07", "spring"])
def test_drift_budget_equals_jax(cfg):
    nsc = cfg.cell_grid
    assert TS.drift_budget(from_jax_config(cfg), nsc) == \
        float(JPC.drift_budget(cfg, nsc))


@pytest.mark.parametrize("case", ["wrap", "walled", "lennard_jones",
                                  "dropping"])
def test_simulate_cadenced_matches_jax(case):
    cap, clump = CAP, 0
    cfg = _cfg("lennard_jones" if case == "lennard_jones" else "particle_life",
               walled=case == "walled")
    if case == "dropping":  # 24 rows in one cell at cap 16: the build drops
        clump = 24
        cfg = cfg.replace(cell_capacity=cap)
    jst, tst = _states(800, 4, clump)
    jout, jdrift, jdrop = JE.simulate_cadenced(jst, cfg, jnp.float32(DT), 8,
                                               rebuild_every=4)
    tout, tdrift, tdrop = TE.simulate_cadenced(tst, from_jax_config(cfg), DT,
                                               8, rebuild_every=4)
    assert int(tdrop) == int(jdrop)
    assert (int(tdrop) > 0) == (case == "dropping")
    assert abs(float(tdrift) - float(jdrift)) <= 1e-6
    for name in ("positions", "velocities"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_simulate_cadenced_trailing_window_and_exactness():
    """A trailing partial window (10 = 4 + 4 + 2), and inside the budget
    the cadenced trajectory agrees with the per-step fresh build."""
    cfg = from_jax_config(_cfg())
    _, tst = _states(600, 5)
    out, drift, dropped = TE.simulate_cadenced(tst, cfg, DT, 10,
                                               rebuild_every=4)
    ref = TE.simulate(tst, cfg, DT, 10)
    assert int(dropped) == 0 and float(drift) < TS.drift_budget(cfg, NSC)
    np.testing.assert_allclose(out.positions.numpy(), ref.positions.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("walled", [False, True])
def test_simulate_dense_carry_matches_jax(walled):
    cfg = _cfg(walled=walled)
    tcfg = from_jax_config(cfg)
    jst, tst = _states(800, 6)
    jds = JD.build_dense(jst, cfg, NSC, CAP, 512)
    tds = TD.build_dense(tst, tcfg, NSC, CAP, 512)
    np.testing.assert_array_equal(tds.pid.numpy(), np.asarray(jds.pid))
    mcap = TD.default_mover_capacity(800)
    for _ in range(2):  # the second call continues the carried layout
        jds, (jmov, jmis) = JE.simulate_dense_carry(
            jds, cfg, jnp.float32(DT), 3, NSC, CAP, mcap, 512)
        tds, (tmov, tmis) = TE.simulate_dense_carry(tds, tcfg, DT, 3, NSC, CAP,
                                                    mcap, 512)
        assert int(tmis) == int(jmis) == 0 and int(tmov) == int(jmov) > 0
        np.testing.assert_allclose(
            TD.scatter_back(tds, tst).positions.numpy(),
            np.asarray(JD.scatter_back(jds, jst).positions),
            rtol=1e-4, atol=1e-5)


def test_lennard_jones_phantom_rows_stay_finite():
    """Empty slots ride a cadenced window as rows at the origin. A real
    particle sits exactly there, so every phantom receiver row of its
    neighbourhood sees a source at distance 0, whose Lennard-Jones force
    is not finite: the row must be selected to 0, not multiplied by a
    mask (inf * 0 = NaN would integrate and poison real rows as a
    source). The window must stay finite and equal the fresh path."""
    cfg = from_jax_config(_cfg("lennard_jones", cell_capacity=8))
    side = 8  # spacing 2 > the 0.5 cutoff: the lattice alone is force-free
    lin = 2 * np.arange(side, dtype=np.float32) - 7
    lat = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(7)
    pos = np.concatenate([lat + rng.uniform(-0.05, 0.05, lat.shape),
                          np.zeros((1, 3))]).astype(np.float32)
    n = pos.shape[0]
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    st = P.from_numpy(pos, vel, np.zeros(n, np.int32), device="cpu")
    u, v = pair_features(st, cfg)
    lay = TS.build_layout(st.positions, u, v, cfg, NSC, 8)
    assert (lay.slot_particle < 0).any()  # phantom slots exist
    out, drift, dropped = TE.simulate_cadenced(st, cfg, DT, 6, rebuild_every=6)
    assert int(dropped) == 0
    for name in ("positions", "velocities", "accel"):
        assert torch.isfinite(getattr(out, name)).all(), name
    ref = TE.simulate(st, cfg, DT, 6)
    np.testing.assert_allclose(out.positions.numpy(), ref.positions.numpy(),
                               rtol=0, atol=1e-6)
