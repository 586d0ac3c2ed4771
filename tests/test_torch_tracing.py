"""The port's own spans and counters (``utils.profiling``): recorded only
while a ``torch.profiler`` session records, on the host's clock, at the
ladder's windows, the dense step's phases and every host
synchronisation of the run and app paths; and the profiling command's
tables of them.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import particle3d_tpu_torch as P
from particle3d_tpu_torch.app import SimulationApp
from particle3d_tpu_torch.utils import profiling as prof

W = 16.0
DT = 1 / 30


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _state(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    sp = rng.integers(0, 5, n).astype(np.int32)
    return P.from_numpy(pos, vel, sp, device="cpu")


def _cfg(**kw):
    kw = {"neighbor": "celllist_pallas", "cell_grid": 8, "cell_capacity": 32,
          **kw}
    return P.reference_config(world_size=W).replace(**kw)


def _syncs(rec):
    return [s.name for s in rec.spans if s.name.startswith("sync.")]


def test_flag_is_set_and_cleared_by_a_session():
    """The recorder keys on torch's own flag: a torch that stops setting it
    must fail here, not record nothing in silence."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with _session():
        assert flag() is True
    assert flag() is False


def test_nothing_records_without_a_session():
    before = prof.recorded()
    n_spans, counters = len(before.spans), dict(before.counters)
    assert prof.span("a") is prof.span("b", x=1) is prof.host_sync("sync.c")
    with prof.span("a") as s:
        s.set(path="x")
    prof.count("c", 3)
    P.simulate_dense(_state(300, 1), _cfg(), DT, 2)
    after = prof.recorded()
    assert after is before
    assert len(after.spans) == n_spans and after.counters == counters


def test_each_session_starts_empty():
    with _session():
        with prof.span("first"):
            prof.count("first")
    assert [s.name for s in prof.recorded().spans] == ["first"]
    with _session():
        prof.count("second", 2)
    rec = prof.recorded()
    assert rec.spans == [] and rec.counters == {"second": 2}


def test_self_time_is_duration_less_children():
    with _session():
        with prof.span("a"):
            with prof.span("b"):
                with prof.span("c"):
                    pass
            with prof.span("d", k=1):
                pass
        with prof.span("e"):
            pass
    rec = prof.recorded()
    names = [s.name for s in rec.spans]
    assert names == ["a", "b", "c", "d", "e"]
    a, b, c, d, e = rec.spans
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 0, -1]
    assert d.attrs == {"k": 1}
    dur = [s.end - s.start for s in rec.spans]
    want = [dur[0] - dur[1] - dur[3], dur[1] - dur[2], dur[2], dur[3], dur[4]]
    assert rec.self_seconds() == pytest.approx(want, abs=1e-12)
    assert all(t >= 0 for t in rec.self_seconds())
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start
    assert d.end <= a.end <= e.start
    table = prof.span_table(rec, 2)
    assert set(table) == set(names)
    assert table["a"] == pytest.approx([want[0] * 1e3 / 2, 0.5])


def test_ladder_counts_its_windows_and_rewinds():
    """test_torch_main_path's escalating scene (N=600, cap 2, no sidecar):
    committed steps are the steps run less the steps rewound, the rewound
    windows are the rewinds the ladder logs, and every sync span is
    counted."""
    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    msgs = []
    with _session():
        _, _, hist = P.simulate_dense_adaptive(
            _state(600, 2), cfg, DT, 40, chunk=10, ocap=0,
            verbose=msgs.append)
    rec = prof.recorded()
    c = rec.counters
    assert sum(k for k, _, _ in hist) == 40
    assert c["ladder.steps_run"] - c["ladder.steps_rewound"] == 40
    rewinds = [m for m in msgs if "rewind" in m]
    assert rewinds and c["ladder.windows_rewound"] == len(rewinds)
    windows = [s for s in rec.spans if s.name == "ladder.window"]
    assert sum(s.attrs["steps"] for s in windows) == c["ladder.steps_run"]
    assert sum(s.attrs["outcome"] == "rewound"
               for s in windows) == len(rewinds)
    assert sum(s.attrs["outcome"] == "probe"
               for s in windows) == c.get("ladder.probes", 0)
    syncs = _syncs(rec)
    assert len(syncs) == c["host_syncs"]
    # each cell window reads its masked count and waits for its timer
    cell = [s for s in windows if s.attrs["cap"] != "allpairs"]
    assert syncs.count("sync.ladder_masked") == len(cell)
    assert syncs.count("sync.ladder_timer") == len(windows)
    # each dense step's phases, under its window
    steps = sum(s.attrs["steps"] for s in cell)
    rebinds = [s for s in rec.spans if s.name == "dense.rebind"]
    assert len(rebinds) == steps
    assert all(rec.spans[s.parent].name == "ladder.window" for s in rebinds)
    assert sum(s.name == "dense.build" for s in rec.spans) == len(cell)


def test_app_frames_count_their_syncs():
    """Two frames of a CPU app on the cadenced path: every blocking call of
    a batch and of a render, once each, in order."""
    app = SimulationApp(_state(500, 3), _cfg(), device="cpu")
    with _session():
        for _ in range(2):
            app.run_steps(2)
            app.render(64, 48)
    rec = prof.recorded()
    batches = [s for s in rec.spans if s.name == "app.batch"]
    assert [s.attrs for s in batches] == [{"steps": 2,
                                           "path": "cadenced"}] * 2
    frame = ["sync.app_speed", "sync.features", "sync.app_dropped",
             "sync.app_drift", "sync.app_batch_end", "sync.render_upload",
             "sync.render_upload", "sync.render_palette", "sync.render_copy"]
    assert _syncs(rec) == frame * 2
    assert rec.counters == {"host_syncs": 2 * len(frame)}


def test_app_carry_path_counts_its_syncs():
    """A batch on the kept dense layout: its build's drop check, the
    masked count read twice (the rewind check, then the record), and the
    dense step's phases."""
    app = SimulationApp(_state(500, 3), _cfg(), device="cpu")
    app._per_step_rebuild = True
    with _session():
        app.run_steps(2)
    rec = prof.recorded()
    assert rec.spans[0].name == "app.batch"
    assert rec.spans[0].attrs["path"] == "carry"
    assert _syncs(rec) == ["sync.app_speed", "sync.features",
                           "sync.app_build_drop", "sync.app_masked",
                           "sync.app_masked", "sync.app_batch_end"]
    names = [s.name for s in rec.spans]
    assert names.count("dense.forces") == names.count("dense.rebind") == 2
    assert names.count("dense.sidecar") == 2 and "dense.build" in names


@pytest.mark.parametrize("path", ["dense", "adaptive", "app", "culled"])
def test_profile_window_tables_the_spans(path):
    """The profiling command's span and counter tables on the CPU, where
    the device fields stay unmeasured."""
    rec, _ = prof.profile_window(_state(300, 4),
                                 _cfg(cell_grid=4, cell_capacity=16), DT,
                                 steps=2, path=path, rebuild_every=2)
    spans = rec["span_self_ms_per_step"]
    want = {"dense": {"dense.build", "dense.forces", "dense.sidecar",
                      "dense.rebind", "sync.features"},
            "adaptive": {"ladder.window", "dense.build", "dense.rebind",
                         "sync.ladder_masked", "sync.ladder_timer"},
            "app": {"app.batch", "cadenced.build", "cadenced.drift",
                    "sync.app_speed", "sync.app_batch_end"},
            "culled": {"culled.window", "sync.worklist",
                       "sync.features"}}[path]
    assert want <= set(spans)
    assert all(ms >= 0 and calls > 0 for ms, calls in spans.values())
    assert rec["counters_per_step"]["host_syncs"] > 0
    assert rec["device_busy_ms_per_step"] is None
    assert rec["device_idle_share"] is None


def test_profiling_command_prints_the_spans(tmp_path):
    """``python -m`` runs the module a second time under ``__main__``; its
    tables must still read the recording the port's spans write."""
    out = subprocess.run(
        [sys.executable, "-m", "particle3d_tpu_torch.utils.profiling",
         "--device", "cpu", "--preset", "reference", "--n", "300",
         "--steps", "2", "--path", "culled", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, check=True,
        cwd=Path(__file__).resolve().parents[1]).stdout
    assert "span culled.window:" in out and "span sync.worklist:" in out
    assert "counter host_syncs:" in out


def test_union_counts_overlap_once():
    assert prof._union_s([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0),
                          (5.5, 5.7)]) == pytest.approx(4.0)
    assert prof._union_s([]) == 0.0
