"""The port's ``bench`` command (``particle3d_tpu_torch/bench.py``) on the
CPU at small sizes: every section runs and gates, the sections' keys are
exactly the JAX harness's (``BENCH_r05.json``'s ``parsed``), the CPU
branch prints the JAX harness's CPU-branch line, the default device never
falls back to the CPU, the re-probe crowd is bench.py's numpy
construction, and the native-parity trajectory matches the JAX package's
``simulate`` from one numpy state."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from particle3d_tpu import from_numpy as jax_from_numpy
from particle3d_tpu import reference_config as jax_reference
from particle3d_tpu import simulate as jax_simulate

import particle3d_tpu_torch as P
from particle3d_tpu_torch import bench as B

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# small geometries: grid >= 3, a few thousand particles, a few steps
CELL = dict(n=2048, world=8.0, grid=6, cap=16)
ONE_M = dict(CELL, ocap=128)
SLAB = dict(n=2048, world=8.0, nsc=6, cap=32, mcap=1024, migcap=512, steps=2)
SECTIONS = [
    (B.section_headline, dict(n=2048, world=8.0, steps=1, iters=1)),
    (B.section_celllist, dict(CELL, steps=2, iters=1)),
    (B.section_1m_windows, dict(ONE_M, short=1, long=2, iters=1)),
    (B.section_1m_ladder, dict(ONE_M, steps=4, chunk=2)),
    (B.section_1m_culled, dict(ONE_M, steps=2)),
    (B.section_ladder, dict(CELL, steps=4, chunk=2)),
    (B.section_reprobe, dict(n=1024, world=6.0, grid=6)),
    (B.section_celllist_vs_allpairs, CELL),
    (B.section_culled_sweep, dict(CELL, iters=1)),
    (B.section_simulate_culled, dict(CELL, steps=2, timed_steps=2)),
    (B.section_sharded_gates, dict(CELL, slab_steps=2, ring_steps=1)),
    (B.section_slab_2m, SLAB),
    (B.section_slab_8m, dict(SLAB, ocap=128)),
    (B.section_allpairs_4k, dict(n=2048, steps=2, iters=1)),
    (B.section_lj_gas, dict(n=1000, steps=2, rebuild_every=2, iters=1)),
    (B.section_native_parity, dict(n=200, steps=10)),
]
CPU_BRANCH_KEYS = {"metric", "value", "unit", "vs_baseline",
                   "allpairs_steps_per_s_N262k",
                   "trajectory_l2_vs_native_N1k_120steps"}


def _bench_r05_keys():
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        return set(json.load(f)["parsed"])


@pytest.fixture(scope="module")
def records():
    """Every section's record at its small size, run once."""
    return {fn.__name__: fn(CPU, **kw) for fn, kw in SECTIONS}


def test_sections_follow_the_harness_order():
    assert [fn for fn, _ in SECTIONS] == list(B.CARD_SECTIONS)


@pytest.mark.parametrize("name", [fn.__name__ for fn, _ in SECTIONS])
def test_section_runs_and_gates(records, name):
    rec = records[name]
    assert set(rec) <= _bench_r05_keys()
    assert not [k for k in rec if k.endswith("_error")]
    for key, value in rec.items():
        if key in ("metric", "unit"):
            assert isinstance(value, str)
            continue
        assert isinstance(value, (int, float)) and math.isfinite(value), key
        if key.endswith("_rel_err"):
            assert 0 <= value < B.GATE, key
        if ("_trouble_" in key or "_lost_" in key
                or key.endswith("_committed_inexact")):
            assert value == 0, key
    if name == "section_reprobe":
        assert rec["reprobe_culled_then_cell_onchip"] == 1


def test_key_set_is_bench_r05s(records):
    keys = [k for rec in records.values() for k in rec]
    assert len(keys) == len(set(keys))
    assert set(keys) == _bench_r05_keys()
    assert len(keys) == 34
    # one-rank meshes only: no section starts a process group
    assert not (torch.distributed.is_available()
                and torch.distributed.is_initialized())


def test_cpu_branch_prints_the_jax_cpu_keys():
    out = subprocess.run(
        [sys.executable, "-m", "particle3d_tpu_torch", "bench", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300,
        check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == CPU_BRANCH_KEYS
    assert rec["metric"] == \
        "pair_interactions_per_sec_allpairs_smallN_cpu_fallback"
    assert rec["unit"] == "pairs/s"
    for key in CPU_BRANCH_KEYS - {"metric", "unit"}:
        assert math.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 1e11)
    assert rec["value"] == pytest.approx(
        4096.0 ** 2 * rec["allpairs_steps_per_s_N262k"])
    assert rec["trajectory_l2_vs_native_N1k_120steps"] < 5e-3
    assert "[bench]" in out.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_never_falls_back_to_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "particle3d_tpu_torch", "bench"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_gate_raises_where_rows_mask():
    # cap 2 on a grid whose cells hold ~10: the window masks rows
    with pytest.raises(AssertionError, match="masked"):
        B.section_celllist(CPU, **dict(CELL, cap=2, steps=1, iters=1))


def test_reprobe_crowd_is_bench_pys_numpy_construction():
    st, cfg = B.reprobe_scene(CPU)
    assert st.n == 16384 and cfg.cell_grid == 16 and cfg.cell_capacity == 8
    assert float(cfg.world_size) == 16.0
    assert not np.asarray(cfg.attraction_matrix).any()
    # bench.py:258-265 on the same uniform scene
    base, _ = B.reprobe_scene(CPU, crowd=0)
    rngr = np.random.default_rng(11)
    crowd = 96
    pos_rp = base.positions.numpy().copy()
    vel_rp = base.velocities.numpy().copy()
    dirs = rngr.normal(size=(crowd, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos_rp[:crowd] = np.float32([1.0, 1.0, 1.0]) + dirs * 0.05
    vel_rp[:crowd] = dirs * 8.0
    np.testing.assert_array_equal(st.positions.numpy(), pos_rp)
    np.testing.assert_array_equal(st.velocities.numpy(), vel_rp)
    np.testing.assert_array_equal(st.species.numpy(), base.species.numpy())


@pytest.mark.parametrize("preset,geometry", [
    ("particle_life_large", dict(world=40.0, grid=24, cap=32)),
    ("particle_life_1m", dict(world=64.0, grid=40, cap=32, ocap=128)),
])
def test_particle_life_scene_is_the_preset(preset, geometry):
    st, cfg = B.particle_life_scene(CPU, 32768, **geometry)
    want, want_cfg, _ = P.make_scene(preset, n=32768, device="cpu")
    for f in dataclasses.fields(cfg):
        assert np.array_equal(np.asarray(getattr(cfg, f.name)),
                              np.asarray(getattr(want_cfg, f.name))), f.name
    for f in ("positions", "velocities", "species", "masses"):
        assert torch.equal(getattr(st, f), getattr(want, f)), f


def test_slab_run_overrides():
    n, cfg, _, kw = P.models.presets.slab_run("slab_8m", n=4096, nsc=6)
    assert n == 4096 and cfg.cell_grid == 6 and kw["nsc"] == 6
    assert kw["cap"] == 64 and kw["ocap"] == 128
    assert float(cfg.world_size) == 100.0


def test_native_parity_trajectory_matches_jax():
    n, steps, dt = 1000, 120, 1.0 / 60.0
    rng = np.random.default_rng(7)
    pos = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    species = rng.integers(0, 5, n).astype(np.int32)
    cfg = P.reference_config()
    l2, out = B.trajectory_vs_native(
        P.from_numpy(pos, vel, species, device="cpu"), cfg, dt, steps)
    want = np.asarray(jax_simulate(jax_from_numpy(pos, vel, species),
                                   jax_reference(), dt, steps).positions)
    world = float(cfg.world_size)
    gap = np.abs(out.positions.numpy() - want).max() / world
    assert gap < 1e-5, gap
    from particle3d_tpu_torch import native

    ref, _ = native.native_simulate(pos, vel, species, cfg, dt, steps)
    jax_l2 = float(np.sqrt(np.mean((want - ref) ** 2)))
    assert l2 < 5e-3 and jax_l2 < 5e-3, (l2, jax_l2)
