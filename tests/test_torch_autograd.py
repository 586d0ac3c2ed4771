"""Autograd through the port's step against ``jax.grad`` on the same numpy
inputs: the attraction matrix as a tensor that requires grad, d(KE)/d(pos0)
on the two backends that differentiate (``allpairs``, ``celllist``), the
matrix recovered by Adam as in ``tests/test_learn_matrix.py``, and the
kernel backends refusing to record a graph.

Tolerances: gradients agree with JAX's to rel. L2 <= 1e-5 over the whole
gradient (float32 trajectories of a few steps; the two frameworks sum the
pair forces in different orders, and the gaps measured are 5e-8 to
2.3e-7); the finite-difference checks keep the JAX test's rel 0.05 / abs
1e-4; the recovery keeps its thresholds.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from particle3d_tpu import (SimConfig as JaxConfig, init_scene as jax_init,
                            reference_config as jax_reference, simulate as
                            jax_simulate)
from particle3d_tpu.engine.step import step as jax_step

import particle3d_tpu_torch as P
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.examples import learn_matrix as LM
from particle3d_tpu_torch.utils.checkpoint import _config_to_jsonable
from particle3d_tpu_torch.utils.metrics import kinetic_energy

GRAD_REL_L2 = 1e-5
DT = 1.0 / 30.0
HIDDEN2 = np.array([[0.7, -0.6], [0.4, 0.5]], np.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These trajectories are long chains of small ops: one intra-op
    thread runs them as fast as several and leaves the cores to the other
    test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _learn_setup():
    """tests/test_learn_matrix.py's scenes (2 x 96 particles, world 8,
    2 species) from jax.random, and both packages' configs."""
    jcfg = JaxConfig(
        world_size=8.0, id_count=2, particle_effect_radius=2.0,
        coefficient=2.0, interaction_force=2.0, min_pull_ratio=0.3,
        attraction_matrix=np.zeros((2, 2), np.float32)).validate()
    st0 = jax.vmap(lambda key: jax_init(key, 96, jcfg))(
        jax.random.split(jax.random.PRNGKey(1), 2))
    batch = (torch.tensor(np.asarray(st0.positions)),
             torch.tensor(np.asarray(st0.velocities)),
             torch.tensor(np.asarray(st0.species), dtype=torch.int64))
    return jcfg, st0, LM.scene_config(2, 8.0), batch


def _jax_snapshots(jcfg, st0, matrix):
    cfg = jcfg.replace(attraction_matrix=matrix)
    body = jax.checkpoint(lambda s, _: (jax_step(s, cfg, jnp.float32(DT)),
                                        None))

    def window(s, _):
        s2, _ = jax.lax.scan(body, s, None, length=3)
        return s2, s2.positions

    return jax.vmap(lambda s0: jax.lax.scan(window, s0, None, length=2)[1])(st0)


@pytest.mark.parametrize("at", ["zero", "half_hidden"])
def test_matrix_gradient_matches_jax(at):
    jcfg, st0, cfg0, batch = _learn_setup()
    m0 = (np.zeros((2, 2), np.float32) if at == "zero"
          else (0.5 * HIDDEN2).astype(np.float32))
    target = _jax_snapshots(jcfg, st0, jnp.asarray(HIDDEN2))

    def jloss(m):
        d2 = jnp.sum((_jax_snapshots(jcfg, st0, m) - target) ** 2, axis=-1)
        return jnp.mean(jnp.minimum(d2, 0.09))

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(m0))

    mat = torch.tensor(m0, requires_grad=True)
    pred = LM.snapshots(mat, batch, cfg0, DT, 6, 3)
    np.testing.assert_allclose(pred.detach().numpy(),
                               np.asarray(_jax_snapshots(jcfg, st0,
                                                         jnp.asarray(m0))),
                               rtol=0, atol=1e-4)
    loss = LM.snapshot_loss(pred, torch.tensor(np.asarray(target)))
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-4)
    assert _rel_l2(mat.grad.numpy(), jg) <= GRAD_REL_L2


def test_adam_recovers_matrix():
    """80 iterations of clipped Adam from zero recover the hidden matrix
    to the JAX test's thresholds."""
    _, _, cfg0, batch = _learn_setup()
    mat, losses = LM.learn(torch.tensor(HIDDEN2), batch, cfg0, DT, 6, 3,
                           iters=80, lr=0.05)
    l0 = float(LM.snapshot_loss(
        LM.snapshots(torch.zeros(2, 2), batch, cfg0, DT, 6, 3),
        LM.snapshots(torch.tensor(HIDDEN2), batch, cfg0, DT, 6, 3)))
    assert losses[0] == pytest.approx(l0, rel=1e-6)
    assert losses[-1] < 0.05 * l0
    assert float(torch.max(torch.abs(mat - torch.tensor(HIDDEN2)))) < 0.15


def _ke_grad_case(name):
    if name == "allpairs":  # test_advanced_parallel's first scene
        jcfg = jax_reference(world_size=4.0)
        return jcfg, jax_init(jax.random.PRNGKey(1), 32, jcfg), 1.0 / 60.0, 5
    jcfg = jax_reference(world_size=8.0).replace(neighbor="celllist",
                                                 cell_grid=8)
    return jcfg, jax_init(jax.random.PRNGKey(1), 256, jcfg), 1.0 / 60.0, 1


@pytest.mark.parametrize("backend", ["allpairs", "celllist"])
def test_kinetic_energy_gradient_matches_jax(backend):
    jcfg, jst, dt, steps = _ke_grad_case(backend)

    def jloss(pos0):
        out = jax_simulate(jst.replace(positions=pos0), jcfg, dt, steps)
        return 0.5 * jnp.sum(out.velocities ** 2)

    jg = np.asarray(jax.grad(jloss)(jst.positions))
    cfg = from_jax_config(jcfg)
    st = P.from_jax_state(jst, device="cpu")
    pos0 = st.positions.clone().requires_grad_(True)
    out = P.simulate(st.replace(positions=pos0), cfg, dt, steps)
    kinetic_energy(out).backward()  # unit masses: the JAX test's loss
    g = pos0.grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0
    assert _rel_l2(g, jg) <= GRAD_REL_L2


def test_gradient_matches_finite_differences():
    """test_advanced_parallel's finite-difference check, on the port."""
    jcfg = jax_reference(world_size=4.0).replace(coefficient=0.0)
    st = P.from_jax_state(jax_init(jax.random.PRNGKey(2), 12, jcfg),
                          device="cpu")
    cfg = from_jax_config(jcfg)

    def loss(pos0):
        out = P.simulate(st.replace(positions=pos0), cfg, 1.0 / 60.0, 2)
        return 0.5 * torch.sum(out.velocities ** 2)

    pos0 = st.positions.clone().requires_grad_(True)
    loss(pos0).backward()
    g = pos0.grad.numpy()
    eps = 1e-3
    with torch.no_grad():
        for idx in [(0, 0), (5, 1), (11, 2)]:
            dp, dm = st.positions.clone(), st.positions.clone()
            dp[idx] += eps
            dm[idx] -= eps
            fd = (float(loss(dp)) - float(loss(dm))) / (2 * eps)
            assert g[idx] == pytest.approx(fd, rel=0.05, abs=1e-4)


def test_tensor_matrix_validates_and_serialises():
    m = torch.tensor(HIDDEN2, requires_grad=True)
    cfg = LM.scene_config(2, 8.0).replace(attraction_matrix=m).validate()
    assert cfg.attraction_matrix is m
    assert _config_to_jsonable(cfg)["attraction_matrix"] == HIDDEN2.tolist()
    with pytest.raises(P.ConfigError, match="shape"):
        cfg.replace(attraction_matrix=torch.zeros(3, 3)).validate()


# The kernel backends at shapes that reach their kernel's wrapper (K3, K1,
# K2 in mask mode, K5) on a 5-species reference scene.
_KERNEL_CASES = {
    "allpairs_pallas": dict(),
    "celllist_pallas": dict(cell_grid=4, cell_capacity=32),
    "allpairs_culled": dict(),
    "allpairs_mxu": dict(),
}


def _kernel_scene(backend):
    cfg = P.reference_config(world_size=8.0).replace(
        neighbor=backend, **_KERNEL_CASES[backend])
    st = P.init_scene(torch.Generator().manual_seed(3), 300, cfg, "cpu")
    return st, cfg


@pytest.mark.parametrize("backend", sorted(_KERNEL_CASES))
def test_kernel_backends_refuse_grad(backend):
    st, cfg = _kernel_scene(backend)
    m = torch.tensor(np.asarray(cfg.attraction_matrix), requires_grad=True)
    with pytest.raises(RuntimeError, match="only the allpairs and celllist"):
        P.step(st, cfg.replace(attraction_matrix=m), 1.0 / 60.0)
    pos0 = st.positions.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        P.step(st.replace(positions=pos0), cfg, 1.0 / 60.0)
    # under no_grad the same calls return what the numpy config gives
    want = P.step(st, cfg, 1.0 / 60.0)
    with torch.no_grad():
        got = P.step(st.replace(positions=pos0), cfg.replace(
            attraction_matrix=m), 1.0 / 60.0)
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.velocities, want.velocities)
