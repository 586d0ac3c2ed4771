"""``correct`` comes out false when the timed path is broken underneath:
each cell driven on the CPU at a small size (the harness's look for a chip
skipped), with one fault planted in the program, and the control (the
reference in the next lower precision, in the program's place) fails the
cells' limits. The run on the card at full size is ``control.py``'s."""

import concurrent.futures
import multiprocessing

import pytest
import torch

from p3dbench import harness

# the program's CPU path takes ~0.4 s a step at these sizes: episodes of
# 64 steps, long enough that a state left unchanged or half of it lies
# past the limits set for the cell's 256
SMALL = {
    "pl262k.run": {"config": {"n": 2048, "world_size": 8.0, "cell_grid": 4},
                   "traffic": {"steps": 64, "chunk": 16, "scenes": 1}},
    "pl262k.app": {"config": {"n": 2048, "world_size": 8.0, "cell_grid": 4},
                   "traffic": {"warmup_frames": 3, "sample_every": 1,
                               "width": 160, "height": 120, "trace_frames": 3,
                               "control_lead": 20}},
}


def _plant(fault: str):
    """Break the program's timed path in this process."""
    import particle3d_tpu_torch as P
    from particle3d_tpu_torch.app import driver

    if fault == "run.unchanged":
        P.simulate_dense_adaptive = lambda st, cfg, dt, k, **kw: (
            st, cfg.cell_capacity, [(k, cfg.cell_capacity, 0)])
    elif fault == "run.half":
        real = P.simulate_dense_adaptive

        def broken(st, cfg, dt, k, **kw):
            out, cap, hist = real(st, cfg, dt, k, **kw)
            pos = out.positions.clone()
            pos[st.n // 2:] = st.positions[st.n // 2:]
            return out.replace(positions=pos), cap, hist

        P.simulate_dense_adaptive = broken
    elif fault == "run.altered":
        # the forces between two species altered where the sweep makes
        # them: the pair law reads a wrong coefficient
        real = P.simulate_dense_adaptive

        def broken(st, cfg, dt, k, **kw):
            a = cfg.attraction_matrix.copy()
            a[0, 1] = -a[0, 1]
            return real(st, cfg.replace(attraction_matrix=a), dt, k, **kw)

        P.simulate_dense_adaptive = broken
    elif fault == "app.unchanged":
        driver.SimulationApp.run_steps = lambda self, n: None
    elif fault == "app.half":
        real = driver.SimulationApp.run_steps

        def broken(self, n):
            before = self.state.positions
            real(self, n)
            pos = self.state.positions.clone()
            pos[::2] = before[::2]
            self.state = self.state.replace(positions=pos)

        driver.SimulationApp.run_steps = broken
    elif fault == "app.altered":
        real = driver.SimulationApp.render

        def broken(self, *a, **kw):
            img = real(self, *a, **kw).copy()
            img[50:60, 70:80] = 255
            return img

        driver.SimulationApp.render = broken
    else:
        raise ValueError(fault)


def small_cell(workload, seed, fault=None):
    torch.set_num_threads(2)
    if fault:
        _plant(fault)
    return harness.run_cell(workload, seed, 1.0, False, torch.device("cpu"),
                            overrides=SMALL[workload])


def isolated(target, args):
    """``target(*args)`` in a fresh process, so that a fault planted in one
    test never reaches another."""
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        return ex.submit(target, *args).result(timeout=900)


FAULTS = [("run.unchanged", "pl262k.run"), ("run.half", "pl262k.run"),
          ("run.altered", "pl262k.run"), ("app.unchanged", "pl262k.app"),
          ("app.half", "pl262k.app"), ("app.altered", "pl262k.app")]


@pytest.mark.parametrize("fault,workload", FAULTS, ids=[f[0] for f in FAULTS])
def test_fault_makes_correct_false(fault, workload):
    result, checks = isolated(small_cell, (workload, 91, fault))
    assert result["correct"] is False, checks


@pytest.mark.parametrize("workload", ["pl262k.run", "pl262k.app"])
def test_sound_small_run_is_correct(workload):
    result, checks = isolated(small_cell, (workload, 92))
    assert result["correct"] is True, checks


# the control's gap grows with the steps it runs: an episode of the cell's
# own length (the reference alone runs, fast enough on the CPU)
CONTROL = {**SMALL, "pl262k.run": {**SMALL["pl262k.run"],
                                   "traffic": {"steps": 256}}}


def control_readings(workload, seed):
    from p3dbench.control import readings

    torch.set_num_threads(2)
    return readings(workload, seed, "control", CONTROL[workload],
                    torch.device("cpu"))


@pytest.mark.parametrize("workload", ["pl262k.run", "pl262k.app"])
def test_control_fails_a_limit(workload):
    got = isolated(control_readings, (workload, 93))
    w, _ = harness.cell_spec(harness.load_benchmark(), workload)
    limits = harness.load_traffic(w["traffic"])["limits"]
    assert any(got[k] > v for k, v in limits.items()), got


@pytest.mark.chip
def test_cells_on_the_card():
    """Each cell runs once, briefly, on the card and is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for w in harness.load_benchmark()["workloads"]:
        result, _ = harness.run_cell(w["name"], 94, 2.0, False,
                                     torch.device("cuda", 0))
        assert result["correct"] is True
