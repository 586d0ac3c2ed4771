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
    return jax_from_numpy(pos, vel, sp), P.from_numpy(pos, vel, sp)


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
    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    _, tst = _states(600, 2)
    with pytest.raises(RuntimeError, match="K4"):
        P.simulate_dense_adaptive(tst, from_jax_config(cfg), DT, 40, chunk=10,
                                  ocap=0, max_cap=2)


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
    """Below N=32,768 the preset selects the all-pairs kernel (as in the
    JAX package), which is not ported yet."""
    st, cfg, dt = P.make_scene("particle_life_large", seed=0, n=1024)
    assert cfg.neighbor == "allpairs_pallas"
    with pytest.raises(NotImplementedError, match="K2"):
        P.simulate(st, cfg, dt, 1)


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
