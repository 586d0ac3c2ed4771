"""The port's column-slab cell list (``parallel.domain``) on 1, 2 and 4
ranks (gloo, one spawned process each; one spawn a mesh size runs every
case) against the JAX package on the same numpy inputs.

The JAX module's own ``sharded_dense_forces`` is wrong on a periodic box
with pairs across the seams (its ghost rows lack the z image shift and the
fold, and its column roll misplaces the x shifts at D >= 2; ROADMAP.md
queue 3), so the port is held to JAX's single-device ``dense_forces`` on
the same layout and its ``simulate_cadenced``; a test pins the
reference's difference. On JAX's own ``lj_gas`` scene, where no pair
crosses a seam, the port matches JAX's ``sharded_cell_simulate``.

Forces: relative L2 <= 1e-5 and max abs <= 1e-4 * max|F| on occupied
slots (exactly 0 on the empty ones). Positions: 1e-5 absolute.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from particle3d_tpu import reference_config
from particle3d_tpu.engine import step as JE
from particle3d_tpu.models import make_scene as jax_make_scene
from particle3d_tpu.ops import pallas_celllist as JPC
from particle3d_tpu.ops.forces import pair_features as jax_pair_features
from particle3d_tpu.parallel import make_mesh as jax_make_mesh
from particle3d_tpu.parallel import domain as JDOM
from particle3d_tpu.state import from_numpy as jax_from_numpy

import torch

from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.ops.celllist_sweep import build_layout
from particle3d_tpu_torch.ops.forces import pair_features
from particle3d_tpu_torch.parallel import domain as TDOM
from particle3d_tpu_torch.parallel.mesh import Mesh, make_mesh
from particle3d_tpu_torch.state import from_numpy

from _torch_ranks import run_ranks
from _torch_scaleout_cases import DT, domain_main

NSC, CAP, W = 4, 128, 16.0
N_DENSE = 2048
STEPS, EVERY = 8, 4
CFG = reference_config(world_size=W).replace(
    neighbor="celllist_pallas", cell_grid=NSC, cell_capacity=CAP)
# the trajectories at cap 64 (the scene's fullest cell holds fewer rows):
# the plain K1 costs the square of the capacity
CFG_SIM = CFG.replace(cell_capacity=64)


def _pair_scene(n=N_DENSE, seed=0):
    """n/2 pairs of particles 0.5 apart (inside particle life's effective
    cutoff of 1), the pair centres uniform in the periodic box: every
    receiver has at least one pair in range, and many pairs straddle the
    x, y and z seams."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-W / 2, W / 2, (n // 2, 3))
    u = rng.normal(size=(n // 2, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = np.concatenate([c, c + 0.5 * u]).astype(np.float32)
    pos = ((pos + W / 2) % W - W / 2).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    sp = rng.integers(0, 5, n).astype(np.int32)
    return pos, vel, sp


def _slot_positions(pos, slot, seed=1):
    """The particles moved by up to 0.3 a coordinate (inside the drift
    budget of 1.5), wrapped, in their layout slots: a stale layout with
    wrap crossers that the fold must put back."""
    rng = np.random.default_rng(seed)
    moved = pos + rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    moved = ((moved + W / 2) % W - W / 2).astype(np.float32)
    occ = slot >= 0
    return np.where(occ[:, None], moved[np.maximum(slot, 0)],
                    0).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    pos, vel, sp = _pair_scene()
    jst = jax_from_numpy(pos, vel, sp)
    ju, jv = jax_pair_features(jst, CFG)
    layout = JPC.build_layout(jst.positions, ju, jv, CFG, NSC, CAP)
    slot = np.asarray(layout.slot_particle).reshape(-1)
    flat = _slot_positions(pos, slot)
    want = np.asarray(JPC.dense_forces(layout, jnp.asarray(flat), CFG, NSC,
                                       CAP))
    return {"pos": pos, "vel": vel, "sp": sp, "slot": slot, "flat": flat,
            "layout": layout, "want": want}


@pytest.fixture(scope="module")
def lj_scene():
    # JAX's test runs cap 48; at about one particle a cell 16 holds every
    # cell, and the plain K1 costs the square of the capacity
    st, cfg, dt = jax_make_scene("lj_gas", n=512)
    cfg = cfg.replace(neighbor="celllist_pallas", cell_grid=8,
                      cell_capacity=16)
    st = JE.warmup(st, cfg)
    arrays = tuple(np.asarray(getattr(st, f)) for f in
                   ("positions", "velocities", "species", "masses", "accel"))
    got, _ = JDOM.sharded_cell_simulate(st, cfg, dt, STEPS, jax_make_mesh(4),
                                        rebuild_every=EVERY, nsc=8, cap=16)
    return arrays, cfg, float(dt), np.asarray(got.positions)


@pytest.fixture(scope="module")
def cadenced_want(scene):
    out, _, dropped = JE.simulate_cadenced(
        jax_from_numpy(scene["pos"], scene["vel"], scene["sp"]), CFG_SIM,
        jnp.float32(DT), STEPS, rebuild_every=EVERY)
    assert int(dropped) == 0
    return np.asarray(out.positions)


def _cases(scene, lj_scene):
    arrays, lj_cfg, lj_dt, _ = lj_scene
    sim = (scene["pos"], scene["vel"], scene["sp"], None, None)
    return {"forces": ("forces", scene["pos"], scene["sp"], scene["flat"],
                       from_jax_config(CFG), NSC, CAP),
            "cadenced": ("simulate", sim, from_jax_config(CFG_SIM), float(DT),
                         STEPS, EVERY),
            "lj_gas": ("simulate", arrays, from_jax_config(lj_cfg), lj_dt,
                       STEPS, EVERY)}


@pytest.fixture(scope="module")
def ranks(scene, lj_scene):
    cases = _cases(scene, lj_scene)
    return {1: [domain_main(make_mesh(1, device="cpu"), cases)],
            2: run_ranks(domain_main, 2, cases),
            4: run_ranks(domain_main, 4, cases)}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _hold_forces(got, want, occ):
    scale = np.abs(want[occ]).max()
    assert _rel_l2(got[occ], want[occ]) <= 1e-5
    assert np.abs(got[occ] - want[occ]).max() <= 1e-4 * scale
    assert (got[~occ] == 0).all()


def test_scene_has_pairs_for_every_receiver(scene):
    """The dense scene's premise: every particle has a partner inside the
    cutoff (minimum image), and pairs cross the periodic seams."""
    pos = scene["pos"].astype(np.float64)
    half = N_DENSE // 2
    d = pos[half:] - pos[:half]
    d -= W * np.round(d / W)
    assert np.allclose(np.linalg.norm(d, axis=1), 0.5, atol=1e-5)
    across = np.abs(pos[half:] - pos[:half]).max(1) > W / 2
    assert across.sum() > 50


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_dense_forces_match_single_device(ranks, scene, d):
    occ = scene["slot"] >= 0
    assert occ.sum() == N_DENSE  # nothing dropped at cap 128
    for r in range(d):  # every rank gathers the same forces
        _hold_forces(ranks[d][r]["forces"], scene["want"], occ)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_cell_simulate_matches_cadenced(ranks, cadenced_want, d):
    for r in range(d):
        pos, drift = ranks[d][r]["cadenced"]
        assert 0 < drift < (W / NSC - 1.0) / 2
        np.testing.assert_allclose(pos, cadenced_want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_cell_simulate_matches_jax_on_lj_gas(ranks, lj_scene, d):
    """Parity with JAX's own column-slab path on its test scene (N=512 in
    a box of 32 with cutoff 0.5: no pair crosses a seam)."""
    want = lj_scene[3]
    for r in range(d):
        np.testing.assert_allclose(ranks[d][r]["lj_gas"][0], want, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("d", [1, 2])
def test_jax_column_roll_differs_on_a_periodic_box(scene, d):
    """The reference's fault, pinned: JAX's ``sharded_dense_forces`` on
    the dense scene misses the single-device forces on the rows whose
    pairs cross the z seam (no z image shift) or whose particle crossed a
    seam since the build (no fold), and at D = 2 also near the slab edges
    (the x shifts of the rolled columns); the port matches (tests
    above)."""
    mesh = jax_make_mesh(d)
    fn = jax.shard_map(
        lambda lay, p: JDOM.sharded_dense_forces(lay, p, CFG, NSC, CAP),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False)
    got = np.asarray(fn(scene["layout"], jnp.asarray(scene["flat"])))
    occ = scene["slot"] >= 0
    want = scene["want"]
    bad = (np.abs(got - want).max(1) > 1e-4 * np.abs(want[occ]).max()) & occ
    print(f"JAX column-slab forces, D={d}: {bad.sum()} of {occ.sum()} rows "
          f"off, max abs error {np.abs(got - want)[occ].max():.4f} "
          f"(max|F| {np.abs(want[occ]).max():.4f})")
    assert bad.sum() > 0


def test_walled_and_indivisible_grids_raise(scene):
    cfg = from_jax_config(CFG)
    st = from_numpy(scene["pos"], scene["vel"], scene["sp"], device="cpu")
    u, v = pair_features(st, cfg)
    layout = build_layout(st.positions, u, v, cfg, NSC, CAP)
    flat = torch.tensor(scene["flat"])
    one = make_mesh(1, device="cpu")
    walled = cfg.replace(boundary="clamp", wrap_forces=False)
    with pytest.raises(ValueError, match="periodic"):
        TDOM.sharded_dense_forces(layout, flat, walled, NSC, CAP, one)
    with pytest.raises(ValueError, match="periodic"):
        TDOM.sharded_cell_simulate(st, walled, DT, 4, one, rebuild_every=4)
    # the checks come before any collective: a 3-rank view needs no group
    three = Mesh(3, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide by mesh size 3"):
        TDOM.sharded_dense_forces(layout, flat, cfg, NSC, CAP, three)
    with pytest.raises(ValueError, match="multiple of rebuild_every"):
        TDOM.sharded_cell_simulate(st, cfg, DT, 6, one, rebuild_every=4)
