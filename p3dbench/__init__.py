"""The benchmark of ``particle3d_tpu_torch`` on the H100.

    python3 p3dbench/run.py --workload pl262k.run --seed 7 --seconds 30 --trace 0

``BENCHMARK.json`` at the repository root names the cells; each cell's
configuration (``configs/<name>.json``), traffic mix (``traffic/<name>.json``,
whose ``driver`` names a module of ``drivers/``) and per-layer metrics
(``metrics/<name>.py``) are found by name. The yardstick lives here: the
scene recipe (``scene``), the peaks and per-pair counts (``bounds``), the
reading of profiler events (``trace``), the plain references and the
comparisons that decide ``correct`` (``reference/``). Nothing here imports
JAX or the JAX package; the references import nothing of the program.
"""
