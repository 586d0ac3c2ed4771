"""Package-level contracts of the PyTorch port: it imports without jax,
converts the JAX package's configs and states, routes CPU tensors to the
plain version of its kernel, and never falls back from CUDA to the CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from particle3d_tpu import reference_config, init_scene as jax_init_scene
from particle3d_tpu.ops.pallas_allpairs import pack_params as jax_pack_params
from particle3d_tpu.utils.metrics import measure_metrics as jax_metrics

import particle3d_tpu_torch as P
from particle3d_tpu_torch import __main__ as cli
from particle3d_tpu_torch.config import ConfigError, from_jax_config
from particle3d_tpu_torch.ops import celllist_sweep as TS
from particle3d_tpu_torch.ops.forces import pad_features, pair_features
from particle3d_tpu_torch.ops.params import pack_params
from particle3d_tpu_torch.utils.metrics import measure_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "particle3d_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, BlockJax())
import particle3d_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print(" ".join(names))
"""


def test_every_module_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    names = out.stdout.split()
    assert len(names) >= 28
    assert {"particle3d_tpu_torch.ops.allpairs_mxu_sweep",
            "particle3d_tpu_torch.ops.celllist",
            "particle3d_tpu_torch.app.driver",
            "particle3d_tpu_torch.app.server",
            "particle3d_tpu_torch.app.headless",
            "particle3d_tpu_torch.render.camera",
            "particle3d_tpu_torch.render.splat",
            "particle3d_tpu_torch.utils.checkpoint",
            "particle3d_tpu_torch.utils.trajio",
            "particle3d_tpu_torch.utils.tune",
            "particle3d_tpu_torch.utils.orbax_ckpt",
            "particle3d_tpu_torch.native",
            "particle3d_tpu_torch.examples.learn_matrix",
            "particle3d_tpu_torch.examples.scaleout",
            "particle3d_tpu_torch.examples.render_demo"} <= set(names)


def test_from_jax_config_round_trip():
    cfg = reference_config(world_size=40.0).replace(
        lj_sigma=0.123, gravity_softening=0.07, coefficient=0.91,
        acceleration=np.array([0.0, -1.5, 0.25], np.float32),
        neighbor="celllist_pallas", cell_grid=24, cell_capacity=32,
        overflow_capacity=128, boundary="clamp", wrap_forces=False)
    for src in (cfg, cfg.as_arrays()):  # python scalars and traced arrays
        port = from_jax_config(src)
        assert [f.name for f in dataclasses.fields(port)] == \
            [f.name for f in dataclasses.fields(cfg)]
        for f in dataclasses.fields(cfg):
            want, got = getattr(cfg, f.name), getattr(port, f.name)
            if isinstance(got, (str, bool, int)) or got is None:
                assert got == want, f.name
            else:
                np.testing.assert_array_equal(
                    np.asarray(got), np.asarray(want, np.float32), f.name)
                assert np.asarray(got).dtype == np.float32, f.name
        port.validate()
        np.testing.assert_array_equal(pack_params(port),
                                      np.asarray(jax_pack_params(src)))


def test_from_jax_state_and_metrics_match():
    cfg = reference_config()
    jst = jax_init_scene(jax.random.PRNGKey(0), 257, cfg)
    jst = jst.replace(velocities=jax.random.normal(jax.random.PRNGKey(1),
                                                   (257, 3)))
    st = P.from_jax_state(jst, device="cpu")
    for name in ("positions", "velocities", "species", "masses", "accel"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    assert st.species.dtype == torch.int64
    got = measure_metrics(st).as_dict()
    want = jax_metrics(jst).as_dict()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_init_scene_is_seeded_and_in_the_box():
    cfg = P.reference_config()
    a = P.init_scene(torch.Generator().manual_seed(7), 500, cfg, "cpu")
    b = P.init_scene(torch.Generator().manual_seed(7), 500, cfg, "cpu")
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.species, b.species)
    assert a.positions.abs().max() <= 5.0
    assert set(a.species.tolist()) == set(range(5))


def test_cpu_tensors_take_the_plain_version():
    cfg = from_jax_config(reference_config(world_size=16.0))
    st = P.make_scene("reference", seed=3, n=400, device="cpu")[0]
    u, v = pad_features(*pair_features(st, cfg))
    ops = TS.prepare_columns(st.positions, u, v, cfg, 8, 16)
    args = (pack_params(cfg), cfg.force_law, True, 8, 16)
    before = TS.KERNEL_LAUNCHES
    got = TS.column_sweep_forces(*ops[:5], *args)
    assert TS.KERNEL_LAUNCHES == before == 0
    assert torch.equal(got, TS.column_sweep_forces_ref(*ops[:5], *args))
    # halo mode needs two more source planes than the whole-grid layout has
    with pytest.raises(ValueError, match=r"post_g: want float32\[80, 3"):
        TS.column_sweep_forces(*ops[:5], *args, halo=True)
    with pytest.raises(ValueError, match="nsc >= 3"):
        TS.column_sweep_forces(*TS.prepare_columns(
            st.positions, u, v, cfg, 2, 16)[:5], *args[:3], 2, 16)


def test_device_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--preset", "reference", "--steps", "1"])


def test_unported_presets_and_bad_configs_raise():
    """Every JAX preset is ported; an unknown name and bad configs raise."""
    from particle3d_tpu.models import list_presets as jax_list_presets

    assert P.list_presets() == [
        "gravity_nbody", "lj_gas", "particle_life_1m", "particle_life_large",
        "particle_life_large_allpairs", "reference", "reference_walls",
        "spring_lattice", "verlet_elastic"]
    assert set(jax_list_presets()) <= set(P.list_presets())
    with pytest.raises(KeyError, match="lj_gas"):
        P.make_scene("lj_liquid")
    with pytest.raises(ConfigError):
        P.reference_config(world_size=1.0)
    with pytest.raises(ConfigError):
        P.reference_config(force_law="magnetism")


def test_pair_coef_keeps_full_float32():
    """The rank-1 coefficient matmul must not drop to TF32 on the card."""
    from particle3d_tpu_torch.ops.forces import pair_coef

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        u = torch.tensor([[1.0 + 2.0 ** -20]])
        assert pair_coef(u, torch.ones(1, 1)).item() == 1.0 + 2.0 ** -20
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """make_scene, from_numpy, from_jax_state, SimulationApp (and its
    load) and the serve, resume and replay commands default to the card
    and raise without one instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jst = jax_init_scene(jax.random.PRNGKey(0), 8, reference_config())
    z = np.zeros((8, 3), np.float32)
    cpu_state = P.from_numpy(z, z, np.zeros(8, np.int32), device="cpu")
    ck = str(tmp_path / "ck.npz")
    P.SimulationApp(cpu_state, P.reference_config(), device="cpu").save(ck)
    for call in (lambda: P.make_scene("reference", n=8),
                 lambda: P.from_numpy(z, z, np.zeros(8, np.int32)),
                 lambda: P.from_jax_state(jst),
                 lambda: P.SimulationApp(n=8),
                 lambda: P.SimulationApp(cpu_state, P.reference_config()),
                 lambda: P.SimulationApp.load(ck),
                 lambda: cli.main(["serve", "--n", "8", "--port", "0"]),
                 lambda: cli.main(["resume", "--checkpoint", "none.npz"]),
                 lambda: cli.main(["replay", "--traj", "none.p3t", "--gif",
                                   "none.gif"]),
                 lambda: cli.main(["run", "--n", "8", "--steps", "1",
                                   "--gif", "none.gif"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert P.make_scene("reference", n=8, device="cpu")[0].n == 8


@pytest.mark.parametrize("name", ["reference_walls",
                                  "particle_life_large_allpairs",
                                  "verlet_elastic", "gravity_nbody",
                                  "spring_lattice", "lj_gas"])
def test_preset_matches_jax_preset(name):
    """Geometry, law, integrator, backend and dt of each ported preset equal
    the JAX preset's, read through from_jax_config; the scene (drawn from
    torch's generator, not jax.random's) has the JAX scene's shapes and
    statistics."""
    from particle3d_tpu.models import make_scene as jax_make_scene

    n = 512
    jst, jcfg, jdt = jax_make_scene(name, n=n)
    st, cfg, dt = P.make_scene(name, seed=0, n=n, device="cpu")
    want = from_jax_config(jcfg)
    for f in dataclasses.fields(want):
        got, ref = getattr(cfg, f.name), getattr(want, f.name)
        if isinstance(ref, (str, bool, int)) or ref is None:
            assert got == ref, f.name
        else:
            np.testing.assert_array_equal(np.asarray(got, np.float32), ref,
                                          err_msg=f.name)
    assert dt == jdt and st.n == jst.n == n
    for field in ("positions", "velocities", "masses"):
        got, ref = getattr(st, field).numpy(), np.asarray(getattr(jst, field))
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert abs(got.std() - ref.std()) <= 0.1 * ref.std() + 1e-6, field
        assert abs(got.mean() - ref.mean()) <= 0.1 * ref.std() + 1e-6, field
    if name == "spring_lattice":  # a deterministic lattice: the same points
        np.testing.assert_allclose(st.positions.numpy(),
                                   np.asarray(jst.positions), atol=1e-6)
    if name == "lj_gas":  # the same lattice, each with its 0.02-sigma jitter
        side = 8  # 8^3 = 512 points
        lin = np.linspace(-15.5, 15.5, side, dtype=np.float32)
        grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                        -1).reshape(-1, 3)
        for pos in (st.positions.numpy(), np.asarray(jst.positions)):
            np.testing.assert_allclose(pos, grid, rtol=0, atol=5 * 0.02)


def test_package_exports_what_the_jax_package_exports():
    import particle3d_tpu
    import particle3d_tpu.utils
    import particle3d_tpu_torch.utils

    assert set(particle3d_tpu.__all__) <= set(P.__all__)
    assert (set(particle3d_tpu.utils.__all__)
            <= set(particle3d_tpu_torch.utils.__all__))
    for name in P.__all__:
        getattr(P, name)
    for name in particle3d_tpu_torch.utils.__all__:
        getattr(particle3d_tpu_torch.utils, name)


def test_kinetic_energy_and_momentum_match_jax():
    """utils.metrics' two diagnostics against the JAX package's, rtol 1e-6,
    on a state with random velocities and masses."""
    from particle3d_tpu.utils.metrics import (kinetic_energy as jax_ke,
                                              total_momentum as jax_mom)
    from particle3d_tpu_torch.utils import kinetic_energy, total_momentum

    cfg = reference_config()
    jst = jax_init_scene(jax.random.PRNGKey(4), 1000, cfg)
    rng = np.random.default_rng(4)
    jst = jst.replace(
        velocities=jax.numpy.asarray(rng.normal(0, 0.5, (1000, 3)),
                                     jax.numpy.float32),
        masses=jax.numpy.asarray(rng.uniform(0.5, 2.0, 1000),
                                 jax.numpy.float32))
    st = P.from_jax_state(jst, device="cpu")
    np.testing.assert_allclose(float(kinetic_energy(st)), float(jax_ke(jst)),
                               rtol=1e-6)
    np.testing.assert_allclose(total_momentum(st).numpy(),
                               np.asarray(jax_mom(jst)), rtol=1e-6, atol=1e-6)


def test_benchmark_steps_and_trace(tmp_path):
    from particle3d_tpu_torch.utils import benchmark_steps, trace

    st, cfg, dt = P.make_scene("reference", n=200, device="cpu")
    calls = []

    def run(s, k):
        calls.append(k)
        return P.simulate(s, cfg, dt, k), (s.positions, [s.velocities])

    sec, (out, _) = benchmark_steps(run, st, 2, warmup=2, iters=3)
    assert sec > 0 and calls == [2] * 5
    assert torch.equal(out.positions, P.simulate(st, cfg, dt, 2).positions)
    with trace(str(tmp_path / "tr")) as prof:
        P.simulate(st, cfg, dt, 1)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
