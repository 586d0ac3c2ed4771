"""The harness finds every piece of a cell by its name, and nothing of it
loads JAX or the JAX package."""

import ast
import json
from pathlib import Path

import pytest

from p3dbench import harness

HERE = Path(__file__).resolve().parent
BENCH = harness.load_benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves(workload):
    w, centry = harness.cell_spec(BENCH, workload)
    config = harness.load_config(centry)
    traffic = harness.load_traffic(w["traffic"])
    driver = harness.load_driver(traffic["driver"])
    assert hasattr(driver, "Cell") and hasattr(driver, "control_checks")
    assert config["n"] > 0 and traffic["limits"]
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = {m["name"] for m in harness.metrics_of(BENCH, workload, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, workload, True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_and_silent_without_data(metric):
    reader = harness.load_reader(metric)
    empty = {"steps": 0, "window_s": 0.0, "busy_s": 0.0, "launches": 0,
             "force_s": 0.0, "pairs": 0, "n": 0, "wrap": True}
    assert reader.read(empty) is None


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.cell_spec(BENCH, "no.such.cell")


def test_metrics_of_follows_workload_lists():
    run = {m["name"] for m in harness.metrics_of(BENCH, "pl262k.run", False)}
    app = {m["name"] for m in harness.metrics_of(BENCH, "pl262k.app", False)}
    assert "memory_peak_gb" in run and "steps_per_s" not in run
    assert "frame_ms_p95" not in run and "memory_peak_gb" not in app
    assert {"steps_per_s", "frame_ms_p95", "setup_s"} <= app
    traced = {m["name"] for m in harness.metrics_of(BENCH, "pl262k.run", True)}
    assert "steps_per_s.run" in traced and "launches_per_step" not in traced


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    m = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
        e2e = {e["name"] for e in harness.metrics_of(BENCH, w, False)}
        assert m["moves"] in e2e, (metric, w)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "particle3d_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "particle3d_tpu_torch" not in _imports(path)
    assert _imports(path) <= {"__future__", "math", "numpy", "torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "particle3d_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert json.loads((harness.ROOT / c["file"]).read_text())
