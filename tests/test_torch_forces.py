"""The port's force laws, plain all-pairs sweep and integrators against the
JAX package on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-6: the port computes every config scalar in
float32 as the JAX package does, so elementwise laws agree to rounding and
force sums differ only in summation order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import reference_config
from particle3d_tpu.engine.step import step as jax_step, warmup as jax_warmup
from particle3d_tpu.ops import forces as JF
from particle3d_tpu.ops.allpairs import allpairs_forces as jax_allpairs
from particle3d_tpu.state import from_numpy as jax_from_numpy

import particle3d_tpu_torch as P
from particle3d_tpu_torch.config import BOUNDARIES, INTEGRATORS, from_jax_config
from particle3d_tpu_torch.ops import forces as TF
from particle3d_tpu_torch.ops.allpairs import allpairs_forces

LAWS = ["particle_life", "lennard_jones", "gravity", "spring"]
W = 10.0


def _cfg(law, **kw):
    cfg = reference_config(world_size=W).replace(force_law=law, **kw)
    if law == "lennard_jones":
        cfg = cfg.replace(particle_effect_radius=1.0, lj_sigma=0.1, lj_epsilon=0.7)
    elif law == "gravity":
        cfg = cfg.replace(particle_effect_radius=3.0, gravity_constant=0.3,
                          gravity_softening=0.05)
    elif law == "spring":
        cfg = cfg.replace(particle_effect_radius=1.0, spring_stiffness=2.5,
                          spring_rest_length=0.4)
    return cfg


def _scene(n, seed, speed=0.3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    vel = rng.normal(0, speed, (n, 3)).astype(np.float32)
    sp = rng.integers(0, 5, n).astype(np.int32)
    m = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return (jax_from_numpy(pos, vel, sp, masses=m),
            P.from_numpy(pos, vel, sp, masses=m))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("law", LAWS)
def test_features_scales_and_magnitudes_match_jax(law):
    cfg = _cfg(law)
    tcfg = from_jax_config(cfg)
    jst, tst = _scene(64, 0)
    for pad in (None, 8):
        ju, jv = JF.pair_features(jst, cfg, pad_p=pad)
        tu, tv = TF.pair_features(tst, tcfg, pad_p=pad)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rng = np.random.default_rng(1)
    d2 = rng.uniform(1e-3, 4.0, 2000).astype(np.float32)
    coef = rng.normal(size=2000).astype(np.float32)
    _close(TF.scale_fn(tcfg)(torch.tensor(d2), torch.tensor(coef)),
           JF.scale_fn(cfg)(jnp.asarray(d2), jnp.asarray(coef)))
    d = np.sqrt(d2)
    _close(TF.magnitude_fn(tcfg)(torch.tensor(d), torch.tensor(coef)),
           JF.magnitude_fn(cfg)(jnp.asarray(d), jnp.asarray(coef)))
    assert np.float32(TF.kick_scale(tcfg)) == np.float32(JF.kick_scale(cfg))


def test_min_image_matches_jax():
    rng = np.random.default_rng(2)
    delta = rng.uniform(-1.5 * W, 1.5 * W, (4000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TF.min_image(torch.tensor(delta), W).numpy(),
        np.asarray(JF.min_image(jnp.asarray(delta), W)))


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("law", LAWS)
def test_allpairs_matches_jax(law, wrap):
    cfg = _cfg(law, wrap_forces=wrap)
    jst, tst = _scene(300, 3)
    ju, jv = JF.pair_features(jst, cfg)
    tu, tv = TF.pair_features(tst, from_jax_config(cfg))
    want = np.asarray(jax_allpairs(jst.positions, ju, jv, cfg))
    got = allpairs_forces(tst.positions, tu, tv, from_jax_config(cfg),
                          block_i=128)
    _close(got, want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_one_step_matches_jax(integrator, boundary):
    cfg = _cfg("particle_life", integrator=integrator, boundary=boundary,
               acceleration=np.array([0.0, -0.5, 0.25], np.float32))
    tcfg = from_jax_config(cfg)
    jst, tst = _scene(200, 4, speed=20.0)  # fast: many particles cross a face
    jst, tst = jax_warmup(jst, cfg), P.warmup(tst, tcfg)
    _close(tst.accel, jst.accel)
    jout = jax_step(jst, cfg, jnp.float32(1 / 30))
    tout = P.step(tst, tcfg, 1 / 30)
    for name in ("positions", "velocities", "accel"):
        _close(getattr(tout, name), getattr(jout, name))
