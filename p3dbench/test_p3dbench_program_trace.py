"""The readers of the program's own spans and counters, on synthetic
recordings: each one's arithmetic, and None where there is nothing to
read."""

from types import SimpleNamespace as NS

import pytest

from p3dbench import harness, program_trace

RUN = ("rerun_share.run", "host_syncs_per_step.run", "rebind_host_ms.run",
       "sidecar_host_ms.run")
APP = ("host_syncs_per_step", "host_wait_share", "render_wait_ms")


def _span(name, start, end, parent=-1):
    return NS(name=name, start=start, end=end, parent=parent)


def _recording(monkeypatch, spans, counters):
    from particle3d_tpu_torch.utils import profiling

    rec = NS(spans=spans, counters=counters)
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    return rec


def _read(name, steps, window_s=2.0):
    return harness.load_reader(name).read({"steps": steps,
                                           "window_s": window_s})


def test_run_readers(monkeypatch):
    # two windows, one rewound; a rebind with one child span, and a
    # sidecar under a forces span
    spans = [_span("ladder.window", 0.0, 1.0),
             _span("dense.rebind", 0.1, 0.4, parent=0),
             _span("inner", 0.2, 0.3, parent=1),
             _span("dense.forces", 0.4, 0.9, parent=0),
             _span("dense.sidecar", 0.5, 0.6, parent=3),
             _span("dense.rebind", 1.1, 1.3),
             _span("sync.ladder_masked", 1.3, 1.4)]
    _recording(monkeypatch, spans, {"ladder.steps_run": 384,
                                    "ladder.steps_rewound": 128,
                                    "host_syncs": 18})
    assert _read("rerun_share.run", 256) == pytest.approx(100 / 3)
    assert _read("host_syncs_per_step.run", 256) == pytest.approx(18 / 256)
    # rebind self time (0.3 - 0.1) + 0.2 = 0.4 s over 384 steps run
    assert _read("rebind_host_ms.run", 256) == pytest.approx(400 / 384)
    assert _read("sidecar_host_ms.run", 256) == pytest.approx(100 / 384)


def test_app_readers(monkeypatch):
    # two frames: uploads, palette and copy; another sync between them
    spans = [_span("sync.app_speed", 0.0, 0.5),
             _span("sync.render_upload", 1.0, 1.1),
             _span("sync.render_palette", 1.2, 1.5),
             _span("sync.render_copy", 1.5, 1.6),
             _span("app.batch", 2.0, 3.0),
             _span("sync.app_batch_end", 2.5, 2.9, parent=4),
             _span("sync.render_palette", 3.0, 3.1),
             _span("sync.render_copy", 3.1, 3.2)]
    _recording(monkeypatch, spans, {"host_syncs": 7})
    assert _read("host_syncs_per_step", 4) == pytest.approx(7 / 4)
    # sync spans 0.5 + 0.1 + 0.3 + 0.1 + 0.4 + 0.1 + 0.1 = 1.6 s of 4 s
    assert _read("host_wait_share", 4, 4.0) == pytest.approx(40.0)
    # frames wait 0.5 and 0.2 s
    assert _read("render_wait_ms", 4) == pytest.approx(350.0)


@pytest.mark.parametrize("name", RUN + APP)
def test_nothing_recorded_reads_none(monkeypatch, name):
    _recording(monkeypatch, [], {})
    assert _read(name, 256) is None


def test_run_readers_need_the_ladder(monkeypatch):
    _recording(monkeypatch, [_span("dense.rebind", 0.0, 1.0)],
               {"host_syncs": 3})
    for name in ("rerun_share.run", "rebind_host_ms.run",
                 "sidecar_host_ms.run"):
        assert _read(name, 256) is None
    assert _read("host_syncs_per_step.run", 256) == pytest.approx(3 / 256)
    assert _read("render_wait_ms", 4) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    from particle3d_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    assert program_trace.recording() is None
    for name in RUN + APP:
        assert _read(name, 256) is None


def test_the_program_records_in_a_profiled_window():
    """The recorder keys on the profiler session that ``trace.traced``
    opens, with the device's activity alone (here the CPU's)."""
    import torch

    from p3dbench import trace as tr
    from particle3d_tpu_torch.utils import profiling

    with tr.traced(torch.device("cpu")):
        with profiling.host_sync("sync.x"):
            pass
    rec = program_trace.recording()
    assert [s.name for s in rec.spans] == ["sync.x"]
    assert rec.counters == {"host_syncs": 1}
