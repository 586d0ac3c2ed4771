"""The port's launchers on the CPU: ``examples/scaleout.py`` (ring2m
against the JAX package's ``sharded_simulate``, ring2level against ring2m,
slab16m's small form through a checkpoint against an uninterrupted run,
the launchers' sizes) and ``examples/render_demo.py`` (its orbiting
camera against the JAX script's, a two-frame GIF). One rank each; the
tolerance is stated in each test."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import SimConfig as JaxSimConfig
from particle3d_tpu.parallel import make_mesh as jax_make_mesh
from particle3d_tpu.parallel import shard_state as jax_shard_state
from particle3d_tpu.parallel import sharded_simulate as jax_sharded_simulate
from particle3d_tpu.render.camera import default_camera as jax_default_camera
from particle3d_tpu.render.camera import view_matrix as jax_view_matrix
from particle3d_tpu.state import from_numpy as jax_from_numpy

from particle3d_tpu_torch.examples import render_demo as RD
from particle3d_tpu_torch.examples import scaleout as SO
from particle3d_tpu_torch.parallel import make_mesh, make_mesh_2d
from particle3d_tpu_torch.parallel.dryrun import ring_parity
from particle3d_tpu_torch.render.camera import default_camera, view_matrix
from particle3d_tpu_torch.state import from_numpy

RING_N = 512
RING_STEPS = 3


def _quiet(_msg):
    pass


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The slab and ring steps here are long chains of small ops: one
    intra-op thread runs them faster than several and leaves the cores to
    the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ring_states(n, seed=0):
    """One numpy scene in the ring's box (uniform, at rest, unit masses)
    for both packages."""
    rng = np.random.default_rng(seed)
    w = float(SO.ring_config().world_size)
    pos = rng.uniform(-w / 2, w / 2, (n, 3)).astype(np.float32)
    vel = np.zeros_like(pos)
    species = np.zeros(n, np.int32)
    return (jax_from_numpy(pos, vel, species),
            from_numpy(pos, vel, species, device="cpu"))


@pytest.fixture(scope="module")
def ring2m_run():
    _, st = _ring_states(RING_N)
    return st, SO.run_ring("ring2m", st, make_mesh(1, device="cpu"),
                           RING_STEPS, say=_quiet)


def test_ring2m_matches_jax_sharded_simulate(ring2m_run):
    """N=512, 3 steps on one rank against the JAX package's
    sharded_simulate on a 1-device CPU mesh (``neighbor="allpairs"``, the
    JAX script's setting off the TPU), from one numpy state: max |dpos| /
    world <= 1e-5 and max |dvel| / max |vel| <= 1e-5. From rest the
    leapfrog's first step moves nothing, so three steps at dt 1e-3 move a
    particle ~3e-6 times its acceleration: the positions alone would pass
    almost any force law, and the velocities hold the law itself."""
    st0, (rec, got) = ring2m_run
    jst, _ = _ring_states(RING_N)
    jcfg = JaxSimConfig(force_law="gravity", particle_effect_radius=20.0,
                        world_size=40.0, gravity_softening=0.05,
                        integrator="leapfrog", neighbor="allpairs").validate()
    mesh = jax_make_mesh(1)
    # (sharded_simulate donates its input state)
    want = jax_sharded_simulate(jax_shard_state(jst, mesh), jcfg,
                                jnp.float32(SO.RING_DT), RING_STEPS, mesh)
    w = 40.0
    d = got.positions.double().numpy() - np.asarray(want.positions, np.float64)
    d -= w * np.round(d / w)
    assert np.abs(d).max() / w <= 1e-5
    vel = np.asarray(want.velocities, np.float64)
    dv = got.velocities.double().numpy() - vel
    assert np.abs(dv).max() / np.abs(vel).max() <= 1e-5
    assert not torch.equal(got.positions, st0.positions)
    assert (rec["mode"], rec["n"], rec["ranks"], rec["steps"]) == (
        "ring2m", RING_N, 1, RING_STEPS)
    assert rec["ms_per_step"] > 0 and rec["pair_interactions_per_s"] > 0


def test_ring2level_one_rank_matches_ring2m(ring2m_run):
    """On a 1 x 1 mesh the 2-level ring sweeps the one block in the 1-D
    ring's order: bit-identical positions and velocities."""
    st, (_, want) = ring2m_run
    rec, got = SO.run_ring("ring2level", st, make_mesh_2d(1, 1, device="cpu"),
                           RING_STEPS, say=_quiet)
    assert rec["mode"] == "ring2level" and rec["ranks"] == 1
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.velocities, want.velocities)


@pytest.mark.parametrize("mode", ["ring2m", "ring2level"])
def test_ring_parity_on_one_rank(mode):
    """parallel.dryrun.ring_parity, which torchrun runs on D ranks against
    one: on a one-rank mesh both runs are the same, so both gaps are 0."""
    mesh = (make_mesh(1, device="cpu") if mode == "ring2m"
            else make_mesh_2d(1, 1, device="cpu"))
    rec = ring_parity(mesh, mode, 256, 2)
    assert (rec["mode"], rec["ranks"], rec["n"]) == (mode, 1, 256)
    assert rec["max_dpos_over_world"] == 0.0
    assert rec["max_dvel_over_max_vel"] == 0.0


def test_slab16m_resumes_bit_identically_through_a_checkpoint(tmp_path):
    """slab16m's small form (N=4,096, grid 8, cap 21): 2 steps saved to
    ``--checkpoint``, 2 more resumed from it, bit-identical to 4 steps
    without a checkpoint (masked, limbo and lost 0)."""
    nsc, n, cap = SO.slab_geometry(1)
    assert (nsc, n, cap) == (8, 4096, 21)
    mesh = make_mesh(1, device="cpu")
    d = str(tmp_path / "ck")
    first, _ = SO.run_slab(mesh, n, nsc, cap, 2, checkpoint=d, say=_quiet)
    rec, resumed = SO.run_slab(mesh, n, nsc, cap, 2, checkpoint=d, say=_quiet)
    _, whole = SO.run_slab(mesh, n, nsc, cap, 4, say=_quiet)
    assert first["step"] == 2 and rec["step"] == 4
    assert "restore_s" in rec and "save_s" in rec
    assert [rec[k] for k in ("masked", "limbo", "lost")] == [0, 0, 0]
    assert all(torch.equal(a, b) for a, b in zip(resumed, whole))


@pytest.mark.parametrize("ranks,n,full,want", [
    (1, None, True, (64, 16_777_216, 161)),
    (4, None, True, (64, 16_777_216, 161)),
    (3, None, False, (9, 4095, 15)),
    (2, 2_000_001, False, (64, 2_000_000, 20)),
])
def test_slab_geometry(ranks, n, full, want):
    """The JAX script's sizes: grid 64 under --full or past 1e6 particles,
    rounded up to a multiple of the ranks; cap 2.5 times the mean
    occupancy, plus one."""
    assert SO.slab_geometry(ranks, n, full) == want


def test_ring_sizes():
    assert SO.ring_n(1, full=True) == 2_097_152
    assert SO.ring_n(4) == 512 and SO.ring_n(3, n=1000) == 999
    cfg = SO.ring_config()
    assert (cfg.force_law, cfg.integrator, cfg.neighbor) == (
        "gravity", "leapfrog", "allpairs_pallas")


def test_launchers_raise_without_a_card():
    """Both default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SO.main(["ring2m", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RD.main(["--preset", "reference", "--frames", "1"])


@pytest.mark.parametrize("i,frames", [(0, 2), (1, 2), (3, 7), (59, 80)])
def test_orbit_camera_matches_the_jax_script(i, frames):
    """The port's view matrix of frame i against the JAX script's camera
    (render_demo.py:65-78) at the same angle: within 1e-6 of its largest
    entry."""
    w = 40.0
    got = view_matrix(RD.orbit_camera(default_camera(w), w, i, frames))
    ang = 2 * np.pi * i / frames
    cam = jax_default_camera(w).replace(
        position=jnp.asarray([w * np.sin(ang), 0.25 * w, w * np.cos(ang)],
                             jnp.float32),
        yaw=jnp.float32(-np.degrees(ang)), pitch=jnp.float32(-10.0))
    want = np.asarray(jax_view_matrix(cam))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_render_demo_writes_two_frames(tmp_path):
    """2 frames at 32 x 24 on the reference preset (no cell grid:
    ``simulate``) into a GIF of 2 frames."""
    from PIL import Image

    out = str(tmp_path / "sub" / "demo.gif")
    rec = RD.render_demo("reference", out, frames=2, steps_per_frame=2,
                         warm_steps=1, width=32, height=24, device="cpu",
                         say=_quiet)
    assert (rec["frames"], rec["steps"], rec["n"]) == (2, 5, 1000)
    with Image.open(out) as im:
        assert im.n_frames == 2 and im.size == (32, 24)
