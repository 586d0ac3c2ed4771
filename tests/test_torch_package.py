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
from particle3d_tpu_torch.ops.forces import pair_features
from particle3d_tpu_torch.ops.params import PAIR_P, pack_params
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
print(len(names))
"""


def test_every_module_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert int(out.stdout.strip()) >= 16


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
    st = P.from_jax_state(jst)
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
    st = P.make_scene("reference", seed=3, n=400)[0]
    u, v = pair_features(st, cfg, pad_p=PAIR_P)
    ops = TS.prepare_columns(st.positions, u, v, cfg, 8, 16)
    args = (pack_params(cfg), cfg.force_law, True, 8, 16)
    before = TS.KERNEL_LAUNCHES
    got = TS.column_sweep_forces(*ops[:5], *args)
    assert TS.KERNEL_LAUNCHES == before == 0
    assert torch.equal(got, TS.column_sweep_forces_ref(*ops[:5], *args))
    with pytest.raises(NotImplementedError, match="halo"):
        TS.column_sweep_forces(*ops[:5], *args, halo=True)
    with pytest.raises(ValueError, match="nsc >= 3"):
        TS.column_sweep_forces(*TS.prepare_columns(
            st.positions, u, v, cfg, 2, 16)[:5], *args[:3], 2, 16)


def test_device_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--preset", "reference", "--steps", "1"])


def test_unported_presets_and_bad_configs_raise():
    with pytest.raises(KeyError, match="particle_life_large"):
        P.make_scene("lj_gas")
    assert P.list_presets() == ["particle_life_1m", "particle_life_large",
                                "reference"]
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
