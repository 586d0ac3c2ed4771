"""The port's exact main path (``simulate_dense``, the adaptive capacity
ladder and the ``run`` command) against the JAX package, from the same
numpy states.

Trajectory tolerance rtol 1e-4 / atol 1e-5 is the one the JAX package
holds its own dense path to against all-pairs (test_celllist_dense.py):
12 steps of chaotic dynamics amplify the last-bit differences of the
force sums.
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import reference_config, simulate as jax_simulate
from particle3d_tpu.engine.step import simulate_dense as jax_simulate_dense
from particle3d_tpu.state import from_numpy as jax_from_numpy

import particle3d_tpu_torch as P
from particle3d_tpu_torch import __main__ as cli
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.engine import step as engine
from particle3d_tpu_torch.ops import celllist_sweep

W = 16.0
DT = 1 / 30


def _cfg(**kw):
    kw = {"neighbor": "celllist_pallas", "cell_grid": 8, "cell_capacity": 32,
          **kw}
    return reference_config(world_size=W).replace(**kw)


def _states(n, seed, clump=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    if clump:  # cram ``clump`` particles into one cell: capacity overflow
        pos[:clump] = np.float32(1.1) + rng.uniform(0, 0.3, (clump, 3))
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    sp = rng.integers(0, 5, n).astype(np.int32)
    return jax_from_numpy(pos, vel, sp), P.from_numpy(pos, vel, sp, device="cpu")


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("walled,cap,clump", [
    (False, 32, 0), (True, 32, 0),   # plain geometry, wrap and clamp
    (False, 4, 12), (True, 4, 12)])  # overflowing geometry: sidecar active
def test_simulate_dense_matches_jax(walled, cap, clump):
    cfg = _cfg(cell_capacity=cap)
    if walled:
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    jst, tst = _states(400, 0, clump)
    jout, (jmov, jmis) = jax_simulate_dense(jst, cfg, jnp.float32(DT), 12)
    tout, (tmov, tmis) = P.simulate_dense(tst, from_jax_config(cfg), DT, 12)
    assert int(tmis) == int(jmis) == 0
    assert int(jmov) > 0
    _close(tout.positions, jout.positions)
    _close(tout.velocities, jout.velocities)


def test_incremental_layout_equals_full_rebuild_bitwise():
    """Inside the port: after 12 repaired steps every cell holds exactly
    the particles, rows and gates a full rebuild of the same state gives.
    Slots within a cell may be ordered differently (movers take the first
    free slot), which reorders each force sum; the trajectory therefore
    agrees with the per-step rebuild path to the last bits only (1e-6)."""
    from particle3d_tpu_torch.ops.celllist_dense import build_dense, scatter_back

    _, tst = _states(512, 1)
    cfg = from_jax_config(_cfg())
    ds, (mov, mis) = engine._dense_scan(build_dense(tst, cfg, 8, 32), cfg, DT,
                                        12, 8, 32, 1024)
    assert int(mis) == 0 and int(mov) > 0
    state = scatter_back(ds, tst)
    ref = build_dense(state, cfg, 8, 32)

    def per_cell(d):
        pid = d.pid.reshape(-1, 32)
        key = torch.where(pid >= 0, pid, torch.iinfo(torch.int64).max)
        order = torch.argsort(key, dim=1)
        rows = torch.cat([d.data, d.feat, d.r2[:, None]], 1).reshape(-1, 32, 26)
        return (torch.gather(pid, 1, order),
                torch.gather(rows, 1, order[..., None].expand(-1, -1, 26)))

    (pid_a, rows_a), (pid_b, rows_b) = per_cell(ds), per_cell(ref)
    assert torch.equal(pid_a, pid_b)
    live = pid_a >= 0  # vacated slots keep stale rows by design
    assert torch.equal(rows_a[live], rows_b[live])
    fresh = P.simulate(tst, cfg, DT, 12)
    _close(state.positions, fresh.positions, rtol=0, atol=1e-6)
    _close(state.velocities, fresh.velocities, rtol=0, atol=1e-6)


def test_adaptive_escalates_and_stays_exact():
    """Clustering scene at cap 2 with the sidecar off: the ladder rewinds,
    doubles the capacity, commits only mask-free windows and matches the
    JAX package's all-pairs trajectory (test_celllist_dense.py's case)."""
    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    jst, tst = _states(600, 2)
    msgs = []
    out, cap, hist = P.simulate_dense_adaptive(
        tst, from_jax_config(cfg), DT, 40, chunk=10, ocap=0, verbose=msgs.append)
    assert cap > 2 and msgs
    assert all(masked == 0 for _, _, masked in hist)
    assert sum(k for k, _, _ in hist) == 40
    ref = jax_simulate(jst, cfg.replace(neighbor="allpairs"), jnp.float32(DT), 40)
    _close(out.positions, ref.positions, rtol=1e-3, atol=1e-4)


def test_adaptive_raises_when_ladder_ends():
    """Masking at max_cap does not raise: every window falls back to the
    culled rung (K4's plain version here), commits mask-free, and the
    trajectory matches the JAX package's all-pairs trajectory. (The name
    dates from when the ladder's end raised; it is kept so that the test
    stays the same test across versions.)"""
    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    jst, tst = _states(600, 2)
    msgs = []
    out, cap, hist = P.simulate_dense_adaptive(
        tst, from_jax_config(cfg), DT, 40, chunk=10, ocap=0, max_cap=2,
        verbose=msgs.append)
    assert cap == 2 and any("falling back to the culled" in m for m in msgs)
    assert hist == [(10, "allpairs", 0)] * 4
    ref = jax_simulate(jst, cfg.replace(neighbor="allpairs"), jnp.float32(DT), 40)
    _close(out.positions, ref.positions, rtol=1e-3, atol=1e-4)


def test_run_reference_on_cpu(capsys):
    rec = cli.main(["run", "--device", "cpu", "--preset", "reference",
                    "--steps", "5", "--n", "300"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    assert line["n"] == 300 and line["steps"] == 5
    assert line["kernel_launches"] == 0 and line["history"] is None
    assert np.isfinite(line["kinetic_energy"]) and line["kinetic_energy"] > 0


def test_large_preset_routes_to_dense_adaptive(monkeypatch):
    calls = []

    def recorder(state, cfg, dt, steps, **kw):
        calls.append((state.n, cfg.neighbor, cfg.cell_grid, cfg.cell_capacity,
                      steps))
        return state, cfg.cell_capacity, [(steps, cfg.cell_capacity, 0)]

    monkeypatch.setattr(engine, "simulate_dense_adaptive", recorder)
    rec = cli.main(["run", "--device", "cpu", "--preset",
                    "particle_life_large", "--n", "32768", "--steps", "3"])
    assert calls == [(32768, "celllist_pallas", 24, 32, 3)]
    assert rec["history"] == [(3, 32, 0)]


def test_small_large_preset_needs_allpairs_kernel():
    """Below N=32,768 the preset selects the all-pairs kernels (as in the
    JAX package): at N=1,024 it steps on ``allpairs_pallas`` (K3's plain
    version here) and matches the JAX package from the same state."""
    from particle3d_tpu.models import make_scene as jax_make_scene

    st, cfg, dt = P.make_scene("particle_life_large", seed=0, n=1024,
                               device="cpu")
    _, jcfg, jdt = jax_make_scene("particle_life_large", n=1024)
    assert cfg.neighbor == jcfg.neighbor == "allpairs_pallas" and dt == jdt
    jst = jax_from_numpy(st.positions.numpy(), st.velocities.numpy(),
                         st.species.numpy())
    out = P.simulate(st, cfg, dt, 3)
    ref = jax_simulate(jst, jcfg, jnp.float32(jdt), 3)
    _close(out.positions, ref.positions)
    _close(out.velocities, ref.velocities)


def test_cpu_main_path_launches_no_kernel():
    _, tst = _states(300, 3)
    before = celllist_sweep.KERNEL_LAUNCHES
    P.simulate_dense(tst, from_jax_config(_cfg()), DT, 3)
    assert celllist_sweep.KERNEL_LAUNCHES == before == 0


def test_profile_window_times_the_main_path(tmp_path):
    """On the CPU the profiler gives wall times and leaves the device
    fields unmeasured (None)."""
    from particle3d_tpu_torch.utils.profiling import profile_window

    _, tst = _states(300, 4)
    trace = tmp_path / "trace.json"
    rec, ka = profile_window(tst, from_jax_config(_cfg()), DT, steps=2,
                             trace_path=str(trace))
    assert rec["n"] == 300 and rec["steps"] == 2
    assert rec["window_ms_per_step"] > 0 and rec["window2_ms_per_step"] > 0
    assert rec["profiled_wall_ms_per_step"] > 0
    assert rec["device_busy_ms_per_step"] is None
    assert rec["device_idle_share"] is None
    assert trace.stat().st_size > 0 and len(ka) > 0


def test_stale_rows_stay_inert_under_lennard_jones():
    """An empty slot keeps a stale copy of the particle that left it. Under
    Lennard-Jones a stale row on top of a live particle gets an infinite
    force; it must be selected away (inf * 0 is NaN, which would integrate
    and then reach live neighbours as a source), so every row stays finite
    and the live rows' forces do not change."""
    from particle3d_tpu_torch.config import SimConfig
    from particle3d_tpu_torch.ops.celllist_dense import (OCAP, build_dense,
                                                         sidecar_indices)

    cfg = SimConfig(force_law="lennard_jones", lj_epsilon=0.2, lj_sigma=0.15,
                    particle_effect_radius=0.5, world_size=8.0,
                    integrator="velocity_verlet", coefficient=0.0,
                    neighbor="celllist_pallas", cell_grid=8,
                    cell_capacity=16).validate()
    rng = np.random.default_rng(4)
    lin = (np.arange(8) - 3.5) * 0.45
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = (g + rng.normal(0, 0.02, g.shape)).astype(np.float32)
    n = pos.shape[0]
    st = P.from_numpy(pos, rng.normal(0, 0.1, (n, 3)).astype(np.float32),
                      np.zeros(n, np.int32), device="cpu")
    ds = build_dense(st, cfg, 8, 16)
    live = torch.nonzero(ds.pid >= 0)[0, 0]
    cell = int(live) // 16
    empty = (torch.nonzero(ds.pid[cell * 16:(cell + 1) * 16] < 0)[0, 0]
             + cell * 16)
    before = engine.dense_pair_forces(ds.pos, ds, sidecar_indices(ds), cfg, 8,
                                      16, OCAP)
    data = ds.data.clone()
    data[empty] = data[live]
    data[empty, :3] += 1e-6  # a stale row just off the live one
    ds = ds.replace(data=data)
    f = engine.dense_pair_forces(ds.pos, ds, sidecar_indices(ds), cfg, 8, 16,
                                 OCAP)
    assert bool(torch.isfinite(f).all())
    assert torch.equal(f[ds.pid >= 0], before[ds.pid >= 0])
    out, _ = engine._dense_scan(ds, cfg, 1e-3, 3, 8, 16, 64)
    assert bool(torch.isfinite(out.data).all())
