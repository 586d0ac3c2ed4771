"""The port's ``SimulationApp`` against the JAX package's, from one numpy
state, and the file formats both packages share.

Trajectories: rtol 1e-4 / atol 1e-5 on positions, as
``test_torch_main_path.py`` (JAX's K1 in interpret mode, the port's plain
version: the force sums differ in their last bits). Controls, configs,
checkpoints and trajectory files: exactly equal. Inside the port, a
rerun from the same state is bit-identical.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import reference_config
from particle3d_tpu.app.driver import SimulationApp as JaxApp
from particle3d_tpu.state import from_numpy as jax_from_numpy
from particle3d_tpu.utils import checkpoint as JCK
from particle3d_tpu.utils import trajio as JTR

import particle3d_tpu_torch as P
from particle3d_tpu_torch.app import SimulationApp
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.engine import step as TE
from particle3d_tpu_torch.ops import celllist_dense as TD
from particle3d_tpu_torch.utils import checkpoint as TCK
from particle3d_tpu_torch.utils import trajio as TTR

W = 16.0


def _cell_cfg(**kw):
    kw = {"neighbor": "celllist_pallas", "cell_grid": 8, "cell_capacity": 16,
          **kw}
    return reference_config(world_size=W).replace(**kw)


def _numpy_scene(n, seed, clump=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    if clump:  # ``clump`` particles in one cell
        pos[:clump] = np.float32(1.1) + rng.uniform(0, 0.3, (clump, 3))
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    return pos, vel, rng.integers(0, 5, n).astype(np.int32)


def _apps(cfg, n=800, seed=0, clump=0):
    pos, vel, sp = _numpy_scene(n, seed, clump)
    japp = JaxApp(state=jax_from_numpy(pos, vel, sp), cfg=cfg)
    tapp = SimulationApp(P.from_numpy(pos, vel, sp, device="cpu"),
                         from_jax_config(cfg), device="cpu")
    return japp, tapp


def _same_cfg(port_cfg, jax_cfg):
    """Every field equal, numeric ones as the float32 both packages
    compute in."""
    want = from_jax_config(jax_cfg)
    for f in dataclasses.fields(want):
        ref = np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(
            np.asarray(getattr(port_cfg, f.name), ref.dtype), ref, f.name)


def _spy(monkeypatch, name):
    """Count the calls of ``engine.step.<name>`` made by the app."""
    calls = []
    fn = getattr(TE, name)

    def wrapped(*a, **kw):
        calls.append(a[3] if len(a) > 3 else kw.get("num_steps"))
        return fn(*a, **kw)

    monkeypatch.setattr(TE, name, wrapped)
    return calls


def _close(tapp, japp):
    np.testing.assert_allclose(tapp.state.positions.numpy(),
                               np.asarray(japp.state.positions),
                               rtol=1e-4, atol=1e-5)


def test_cadenced_and_carry_branches_match_jax(monkeypatch):
    japp, tapp = _apps(_cell_cfg())
    cadenced = _spy(monkeypatch, "simulate_cadenced")
    carry = _spy(monkeypatch, "simulate_dense_carry")
    builds = _spy(monkeypatch, "_dense_scan")
    real_build = TD.build_dense
    n_builds = []
    monkeypatch.setattr(TD, "build_dense",
                        lambda *a, **k: n_builds.append(1) or real_build(*a, **k))
    for k in (4, 1, 1):  # cadenced, then the carry branch twice
        japp.run_steps(k)
        tapp.run_steps(k)
        _close(tapp, japp)
    assert cadenced == [4] and carry == [1, 1] and len(builds) == 2
    assert len(n_builds) == 1  # the second carry batch reuses the layout
    assert tapp.step_index == japp.step_index == 6
    assert tapp.capacity_masked == japp.capacity_masked == 0
    assert tapp.max_drift == pytest.approx(japp.max_drift, abs=1e-6)
    assert tapp.metrics().keys() == japp.metrics().keys()


def test_plain_backend_app_matches_jax():
    cfg = reference_config()
    pos, vel, sp = _numpy_scene(300, 1)
    pos = pos * 0.6  # inside the reference's world of 10
    japp = JaxApp(state=jax_from_numpy(pos, vel, sp), cfg=cfg)
    tapp = SimulationApp(P.from_numpy(pos, vel, sp, device="cpu"),
                         from_jax_config(cfg), device="cpu")
    assert japp.tick(real_dt=10.0) == tapp.tick(real_dt=10.0) == 5
    _close(tapp, japp)
    tapp._accum = 0.0
    assert tapp.tick(real_dt=0.001) == 0
    assert tapp.metrics().keys() == japp.metrics().keys()
    assert tapp.update_timer.ema_ms > 0


CONTROLS = [
    ("set_world_size", (1.0,)), ("set_world_size", (25.0,)),
    ("set_update_rate", (0.1,)), ("set_update_rate", (5000.0,)),
    ("set_walls", (True,)), ("set_walls", (False,)),
    ("set_effect_radius", (100.0,)), ("set_effect_radius", (0.0,)),
    ("set_interaction_force", (-3.0,)), ("set_interaction_force", (50.0,)),
    ("set_drag", (2.0,)), ("set_drag", (-1.0,)),
    ("set_min_pull_ratio", (0.0,)), ("set_min_pull_ratio", (3.0,)),
    ("set_gravity", (0.0, -9.8, 0.5)),
    ("set_color", (2, [0.1, 0.2, 0.3])),
    ("set_attraction", (0, 1, 7.5)), ("set_attraction", (3, 2, -4.0)),
    ("set_attraction_matrix", (np.full((5, 5), 0.25, np.float32),)),
    ("set_particle_count", (40,)), ("set_particle_count", (140,)),
]


@pytest.mark.parametrize("name,args", CONTROLS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(CONTROLS)])
def test_live_control_matches_jax(name, args):
    japp, tapp = _apps(_cell_cfg(), n=100)
    getattr(japp, name)(*args)
    getattr(tapp, name)(*args)
    _same_cfg(tapp.cfg, japp.cfg)
    assert tapp.update_rate == japp.update_rate
    assert tapp.state.n == japp.state.n
    assert (tapp._recheck, tapp._dense) == (japp._recheck, japp._dense)


def test_particle_count_draws_from_the_generator():
    a, b = (SimulationApp(n=50, device="cpu",
                          generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    for app in (a, b):
        app.set_particle_count(20)
        app.set_particle_count(90)
    assert a.state.n == 90
    assert torch.equal(a.state.positions, b.state.positions)
    assert torch.equal(a.state.species, b.state.species)
    st = a.state
    assert P.resize(st, torch.Generator(), 30, a.cfg).n == 30
    assert torch.equal(P.resize(st, torch.Generator(), 30, a.cfg).positions,
                       st.positions[:30])


def test_camera_keys_match_jax():
    japp, tapp = _apps(reference_config(), n=10)
    for keys, dt in (({"w"}, 0.5), ({"left", "up"}, 0.1), ({"d", "e"}, 0.2)):
        japp.handle_keys(keys, dt)
        tapp.handle_keys(keys, dt)
    np.testing.assert_allclose(tapp.camera.position,
                               np.asarray(japp.camera.position), atol=1e-5)
    assert float(tapp.camera.yaw) == pytest.approx(float(japp.camera.yaw))
    assert float(tapp.camera.pitch) == pytest.approx(float(japp.camera.pitch))


@pytest.mark.parametrize("path", ["cadenced", "carry"])
def test_escalation_commits_an_unmasked_batch(path):
    """A clump overflows cap 8 (no sidecar): the batch is rewound and
    re-run at twice the capacity until nothing drops; the committed state
    is that of the committed rung's driver from the batch's start."""
    cfg = from_jax_config(_cell_cfg(cell_capacity=8, overflow_capacity=0))
    pos, vel, sp = _numpy_scene(600, 2, clump=20)
    st = P.from_numpy(pos, vel, sp, device="cpu")
    app = SimulationApp(st, cfg, device="cpu")
    steps = 4 if path == "cadenced" else 1
    app.run_steps(steps)
    assert app._cap_escalated == 32 and not app._cell_fallback
    assert app.capacity_masked == 0
    if path == "cadenced":
        want, _, dropped = TE.simulate_cadenced(st, cfg, np.float32(1 / 60), 4,
                                                rebuild_every=4, cap=32)
        assert int(dropped) == 0
    else:
        want, (_, mis) = TE.simulate_dense(st, cfg, np.float32(1 / 60), 1,
                                           cap=32, ocap=0)
        assert int(mis) == 0
    assert torch.equal(app.state.positions, want.positions)
    assert app.metrics()["cell_capacity"] == 32


def test_fallback_runs_simulate_culled(monkeypatch):
    cfg = from_jax_config(_cell_cfg(cell_capacity=8, overflow_capacity=0))
    pos, vel, sp = _numpy_scene(600, 3, clump=40)
    st = P.from_numpy(pos, vel, sp, device="cpu")
    app = SimulationApp(st, cfg, device="cpu")
    app.max_cap = 16
    calls = _spy(monkeypatch, "simulate_culled")
    app.run_steps(2)
    assert calls == [2] and app._cell_fallback
    want, _ = TE.simulate_culled(st, cfg, np.float32(1 / 60), 2, window=2)
    assert torch.equal(app.state.positions, want.positions)
    assert torch.equal(app.state.velocities, want.velocities)
    assert app.metrics()["cell_fallback"] is True


def test_app_checkpoint_resume(tmp_path):
    """After a cadenced batch both apps rebuild their layout from the same
    state: bit-identical. After a carry batch the original keeps its
    layout, whose slot order differs from a fresh build's: 1e-5."""
    _, app = _apps(_cell_cfg(), n=800, seed=4)
    app.set_gravity(0.0, -1.0, 0.0)
    for first, exact in ((4, True), (1, False)):
        app.run_steps(first)
        path = str(tmp_path / f"ck{first}.npz")
        app.save(path)
        other = SimulationApp.load(path, device="cpu")
        assert other.step_index == app.step_index
        np.testing.assert_array_equal(other.cfg.acceleration, [0, -1, 0])
        nxt = 4 if exact else 1
        app.run_steps(nxt)
        other.run_steps(nxt)
        if exact:
            assert torch.equal(other.state.positions, app.state.positions)
        else:
            np.testing.assert_allclose(other.state.positions.numpy(),
                                       app.state.positions.numpy(), atol=1e-5)




def test_checkpoints_cross_between_packages(tmp_path):
    pos, vel, sp = _numpy_scene(200, 5)
    acc = np.random.default_rng(6).normal(size=(200, 3)).astype(np.float32)
    cfg = _cell_cfg(boundary="clamp", lj_sigma=0.123)
    jst = jax_from_numpy(pos, vel, sp).replace(accel=jnp.asarray(acc))
    jpath = str(tmp_path / "jax.npz")
    JCK.save_checkpoint(jpath, jst, cfg, 7, extra={"note": "jax"})
    st, tcfg, step, extra = TCK.load_checkpoint(jpath, device="cpu")
    assert (step, extra) == (7, {"note": "jax"})
    for name, want in (("positions", pos), ("velocities", vel), ("accel", acc),
                       ("species", sp)):
        np.testing.assert_array_equal(getattr(st, name).numpy(), want)
    _same_cfg(tcfg, cfg)

    tpath = str(tmp_path / "port.npz")
    TCK.save_checkpoint(tpath, st, tcfg, 9, extra={"note": "port"})
    jst2, jcfg2, step2, extra2 = JCK.load_checkpoint(tpath)
    assert (step2, extra2) == (9, {"note": "port"})
    for name in ("positions", "velocities", "accel", "species", "masses"):
        np.testing.assert_array_equal(np.asarray(getattr(jst2, name)),
                                      np.asarray(getattr(jst, name)))
    _same_cfg(tcfg, jcfg2)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype for k in a.files if k != "meta")
        assert json.loads(str(a["meta"])).keys() == json.loads(str(b["meta"])).keys()


def test_trajectories_cross_between_packages(tmp_path):
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(5, 64, 3)).astype(np.float32)
    sp = rng.integers(0, 5, 64).astype(np.int32)
    meta = {"config": TCK._config_to_jsonable(from_jax_config(_cell_cfg())),
            "dt": 0.01}
    for writer, reader, tag in ((JTR.TrajectoryWriter, TTR.TrajectoryReader,
                                 "jax"),
                                (TTR.TrajectoryWriter, JTR.TrajectoryReader,
                                 "port")):
        path = str(tmp_path / f"{tag}.p3t")
        with writer(path, 64, sp, meta) as w:
            w.append(frames[0])
            w.append_batch(frames[1:])
        r = reader(path)
        assert len(r) == 5 and r.meta == meta
        np.testing.assert_array_equal(np.asarray(r.species), sp)
        np.testing.assert_array_equal(np.asarray(r.positions()), frames)
    # the port's writer takes tensors as they are
    path = str(tmp_path / "tensor.p3t")
    with TTR.TrajectoryWriter(path, 64, torch.tensor(sp)) as w:
        w.append_batch(torch.tensor(frames))
    np.testing.assert_array_equal(TTR.TrajectoryReader(path)[4], frames[4])
    with pytest.raises(ValueError, match="frame must be"):
        TTR.TrajectoryWriter(str(tmp_path / "x.p3t"), 64, sp).append(frames[0][:8])
