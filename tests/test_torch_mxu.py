"""The port's ghost-image all-pairs sweep (K5's plain version on the CPU)
against the JAX package's ``pallas_allpairs_forces_mxu`` in interpret mode
(t = 64), on the same numpy inputs, and the ``allpairs_mxu`` backend's
step and simulate against the JAX package's.

Tolerances are the JAX package's own for this kernel against the dense
path (tests/test_pallas_mxu.py): 2e-5 * max|F| in exact mode (the
factored sums re-associate |p|-sized terms) and 3e-3 * max|F| in fast
mode (the Gram form's d^2 noise on near-contact pairs).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import SimConfig, reference_config
from particle3d_tpu import simulate as jax_simulate
from particle3d_tpu.engine.step import warmup as jax_warmup
from particle3d_tpu.ops import forces as JF
from particle3d_tpu.ops import pallas_allpairs_mxu as JM
from particle3d_tpu.state import from_numpy as jax_from_numpy

import particle3d_tpu_torch as P
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.ops import allpairs_mxu_sweep as M
from particle3d_tpu_torch.ops import forces as TF

CASES = [
    ("particle_life_wrap", reference_config()),
    ("particle_life_nowrap",
     reference_config().replace(wrap_forces=False, boundary="clamp")),
    ("gravity", SimConfig(force_law="gravity", particle_effect_radius=3.0,
                          world_size=12.0, gravity_softening=0.1).validate()),
    ("lj", SimConfig(force_law="lennard_jones", particle_effect_radius=0.8,
                     lj_sigma=0.3).validate()),
    ("spring", SimConfig(force_law="spring", particle_effect_radius=1.5,
                         spring_rest_length=0.7).validate()),
]


def _states(pos, species, vel=None):
    pos = np.asarray(pos, np.float32)
    vel = np.zeros_like(pos) if vel is None else vel
    species = np.asarray(species, np.int32)
    return (jax_from_numpy(pos, vel, species),
            P.from_numpy(pos, vel, species, device="cpu"))


def _scene(seed, n, cfg):
    """The JAX test's scene: uniform points and species."""
    rng = np.random.default_rng(seed)
    half = float(np.asarray(cfg.world_size)) / 2
    pos = rng.uniform(-half, half, (n, 3))
    return _states(pos, rng.integers(0, cfg.id_count, n))


def _forces(cfg, jst, tst, **kw):
    """(port, JAX) K5 forces on the same scene."""
    ju, jv = JF.pair_features(jst, cfg)
    tcfg = from_jax_config(cfg)
    tu, tv = TF.pair_features(tst, tcfg)
    want = np.asarray(JM.pallas_allpairs_forces_mxu(
        jst.positions, ju, jv, cfg, t=kw.pop("t", 64), interpret=True, **kw))
    got = M.pallas_allpairs_forces_mxu(tst.positions, tu, tv, tcfg,
                                       t=64, **kw)
    return got.numpy(), want


@pytest.mark.parametrize("name,cfg", CASES, ids=[c[0] for c in CASES])
def test_mxu_matches_jax_exact(name, cfg):
    got, want = _forces(cfg, *_scene(3, 257, cfg))  # odd N: tile padding
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


@pytest.mark.parametrize("name,cfg", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_mxu_matches_jax_fast(name, cfg):
    got, want = _forces(cfg, *_scene(4, 200, cfg), precision="fast")
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-3)


def test_wrap_through_image_and_coincident_pairs():
    """A pair in range only through the periodic image interacts (through
    its ghosts), as in the JAX package; coincident particles exert no
    force (reference quirk Q8), in both modes."""
    cfg = reference_config()
    w = 10.0
    pos = np.zeros((2, 3), np.float32)
    pos[0, 0] = -w / 2 + 0.1
    pos[1, 0] = w / 2 - 0.4  # image distance 0.5 < cutoff, direct 9.5
    jst, tst = _states(pos, [0, 1])
    got, want = _forces(cfg, jst, tst, t=8)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert int(M.ghost_count(tst.positions, from_jax_config(cfg))) == 2

    pos = np.zeros((4, 3), np.float32)
    pos[2:] = 2.5  # a second coincident pair, away from the first
    tst = _states(pos, [0, 1, 2, 3])[1]
    tcfg = from_jax_config(cfg)
    tu, tv = TF.pair_features(tst, tcfg)
    for precision in ("exact", "fast"):
        got = M.pallas_allpairs_forces_mxu(tst.positions, tu, tv, tcfg, t=8,
                                           precision=precision)
        np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-7)


GHOST_CFGS = [reference_config(), reference_config(world_size=20.0),
              SimConfig(force_law="lennard_jones", particle_effect_radius=0.5,
                        world_size=8.0).validate()]


@pytest.mark.parametrize("i", range(len(GHOST_CFGS)))
def test_ghosts_match_jax(i):
    """The same ghost rows in the same order (jnp.nonzero's), parents and
    validity; the counts and the recommended capacity equal JAX's."""
    cfg = GHOST_CFGS[i]
    n = 300
    jst, tst = _scene(10 + i, n, cfg)
    tcfg = from_jax_config(cfg)
    gcap = M.recommended_ghost_capacity(tcfg, n)
    assert gcap == JM.recommended_ghost_capacity(cfg, n)
    assert int(M.ghost_count(tst.positions, tcfg)) == int(
        JM.ghost_count(jst.positions, cfg))
    rng = np.random.default_rng(i)
    feats = rng.normal(size=(2, n, 8)).astype(np.float32)
    for cap in (gcap, 16):  # roomy, and truncated below the count
        got = M._build_ghosts(tst.positions, torch.from_numpy(feats[0]),
                              torch.from_numpy(feats[1]), tcfg, cap)
        want = JM._build_ghosts(jst.positions, jnp.asarray(feats[0]),
                                jnp.asarray(feats[1]), cfg, cap)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-6)
        for g, wnt in zip(got[1:3], want[1:3]):  # parents' features
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("integrator", ["euler", "velocity_verlet"])
def test_simulate_on_allpairs_mxu_matches_jax(integrator):
    """Three steps on the ``allpairs_mxu`` backend against the JAX
    package's simulate; ``step`` three times gives the same state."""
    # the JAX simulate traces the config, so it needs a static capacity
    cfg = reference_config().replace(
        neighbor="allpairs_mxu", integrator=integrator,
        ghost_capacity=JM.recommended_ghost_capacity(reference_config(), 128))
    rng = np.random.default_rng(31)
    pos = rng.uniform(-5, 5, (128, 3))
    vel = rng.normal(0, 0.3, (128, 3)).astype(np.float32)
    jst, tst = _states(pos, rng.integers(0, 5, 128), vel)
    dt = 1 / 60
    tcfg = from_jax_config(cfg)
    want = jax_simulate(jax_warmup(jst, cfg), cfg, jnp.float32(dt), 3)
    got = P.simulate(P.warmup(tst, tcfg), tcfg, dt, 3)
    stepped = P.warmup(tst, tcfg)
    for _ in range(3):
        stepped = P.step(stepped, tcfg, dt)
    assert torch.equal(stepped.positions, got.positions)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.velocities.numpy(),
                               np.asarray(want.velocities), rtol=1e-4,
                               atol=1e-5)


def test_cuda_call_without_a_card_raises_and_computes_nothing(monkeypatch):
    """Operands off the CPU never take the plain version: a call on a
    device that is not the CPU raises before any sweep runs, nothing is
    counted, and the entry points refuse the card when there is none."""
    calls = []
    monkeypatch.setattr(M, "mxu_sweep_ref", lambda *a, **k: calls.append(a))
    cfg = from_jax_config(reference_config())
    tst = P.make_scene("reference", seed=2, n=100, device="cpu")[0]
    u, v = TF.pair_features(tst, cfg)
    ops = M.mxu_operands(tst.positions, u, v, cfg, 256, M.KERNEL_TILE)
    meta = [x.to("meta") for x in ops[:5]]
    with pytest.raises(ValueError, match="no all-pairs kernel"):
        M.mxu_sweep(*meta, ops[5], cfg.force_law, False, M.KERNEL_TILE)
    with pytest.raises(ValueError, match="want"):
        M.mxu_sweep(ops[0][:, :3].contiguous(), *ops[1:], cfg.force_law,
                    False, M.KERNEL_TILE)
    with pytest.raises(ValueError, match="whole tiles"):
        M.mxu_sweep(*ops, cfg.force_law, False, 100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.from_numpy(tst.positions.numpy(), tst.velocities.numpy(),
                     tst.species.numpy(), device="cuda")
    assert calls == [] and M.KERNEL_LAUNCHES["allpairs_mxu"] == 0
