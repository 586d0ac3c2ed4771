"""The port's binding of the C++ reference engine (``native.py``) against
the JAX package's binding on the same inputs (the same source, built
without OpenMP here: equal arrays), and the port's CPU trajectory at the BASELINE parity anchor
(N=1,000, 120 steps) against it, held to ``tests/test_native.py``'s
L2 < 5e-3 (``chip_smoke.py`` phase 27 does the same on the card, also
through K3)."""

import numpy as np
import pytest

from particle3d_tpu import native as jax_native
from particle3d_tpu import reference_config as jax_reference

import particle3d_tpu_torch as P
from particle3d_tpu_torch import native

pytestmark = pytest.mark.skipif(not jax_native.available(),
                                reason="the JAX package's native build is "
                                       "unavailable")


def _scene(seed, n, world):
    rng = np.random.default_rng(seed)
    half = world / 2
    pos = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    species = rng.integers(0, 5, n).astype(np.int32)
    return pos, vel, species


def test_builds_into_build_dir():
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.available()


@pytest.mark.parametrize("walls", [False, True])
@pytest.mark.parametrize("steps", [1, 10])
def test_binding_matches_jax_binding(walls, steps):
    boundary = "clamp" if walls else "wrap"
    cfg = P.reference_config(boundary=boundary)
    jcfg = jax_reference().replace(boundary=boundary)
    pos, vel, species = _scene(steps, 300, 10.0)
    got = native.native_simulate(pos, vel, species, cfg, 1 / 60, steps)
    want = jax_native.native_simulate(pos, vel, species, jcfg, 1 / 60, steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    one = native.native_step(pos, vel, species, cfg, 1 / 60, use_hash=False)
    np.testing.assert_array_equal(
        one[0], jax_native.native_step(pos, vel, species, jcfg, 1 / 60,
                                       use_hash=False)[0])


def test_rejects_other_laws_and_shapes():
    cfg = P.reference_config()
    pos, vel, species = _scene(0, 10, 10.0)
    with pytest.raises(ValueError, match="particle_life"):
        native.native_step(pos, vel, species, cfg.replace(force_law="gravity"),
                           1 / 60)
    with pytest.raises(ValueError, match="want"):
        native.native_step(pos, vel[:9], species, cfg, 1 / 60)


def test_cpu_trajectory_matches_native_at_1k():
    cfg = P.reference_config()
    pos, vel, species = _scene(3, 1000, 10.0)
    st = P.from_numpy(pos, vel, species, device="cpu")
    out = P.simulate(st, cfg, 1.0 / 60.0, 120)
    gp, _ = native.native_simulate(pos, vel, species, cfg, 1.0 / 60.0, 120)
    l2 = np.sqrt(np.mean((out.positions.numpy() - gp) ** 2))
    assert l2 < 5e-3, f"trajectory L2 error vs native reference: {l2}"
