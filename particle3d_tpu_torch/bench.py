"""The ``bench`` command: the JAX package's benchmark harness (the root
``bench.py``) on the port.

    python -m particle3d_tpu_torch bench                 # on the card
    python -m particle3d_tpu_torch bench --device cpu    # the small CPU run

Prints ``[bench] ...`` context lines on stderr and ONE JSON line on
stdout with the keys of the JAX harness's full run (``BENCH_r05.json``'s
``parsed``), in its units and meanings: the headline is the pair
interactions per second of the all-pairs step at N=262,144 (K2), against
the 1e11 pairs/s target of ``BASELINE.json`` (``vs_baseline``); beside it
the steps per second of the exact cell-list windows (K1) at 262k and 1M,
the two capacity ladders, the culled rung (K4) at 262k and 1M, the
cluster-then-disperse re-probe, the one-rank slab runs (K1 halo) at 2M
and 8M, N=4,096 all-pairs, and seven exactness gates (max abs error over
the reference's largest value < 5e-5): the cell kernel, the culled sweep
and the culled rung against all-pairs or the dense path, the one-rank
slab (periodic and walled), the ring (K3) and the sharded exact rung
against all-pairs. ``lj_gas`` on the cadenced path is timed on stderr
only, and the trajectory is held to the C++ reference engine.

One function per section of the JAX harness, in its order; each takes
the device and its scene sizes (bench.py's values by default) and returns
its keys. ``main`` runs them at the defaults. Times are host clocks over
whole calls, each ending in a device sync (``timed``): all-in seconds per
call, as the JAX harness's host-forced fence gave. The first call of each
timed function is a warm call with the same shapes; it also absorbs the
first-use builds of the kernels (``utils.cuda_build``).

Where it deliberately differs from the JAX harness:

- no fallback to the CPU: without a card the default ``--device cuda``
  fails and prints no JSON line. ``--device cpu``, asked for explicitly,
  runs the JAX harness's non-TPU branch: N=4,096 on plain ``allpairs``, 2
  steps, 1 timed call, under the metric
  ``pair_interactions_per_sec_allpairs_smallN_cpu_fallback`` and the key
  ``allpairs_steps_per_s_N262k`` (the JAX harness's name at that N), then
  the native-parity gate;
- no swallowed sections: a failed gate or section raises and the command
  exits non-zero, and no ``*_error`` key exists (nor does a missing native
  engine skip its gate: ``native.NativeUnavailable`` propagates);
- no ``wp_cap``: the port's ``simulate_culled`` builds the exact worklist
  every step (its stats report ``wp_cap`` = ``max_count``, ``retries`` 0);
- seeds: ``jax.random.PRNGKey(k)`` becomes a CPU ``torch.Generator``
  seeded with k, so the scenes match the JAX harness's in distribution,
  not in bits; the re-probe's crowd is numpy's ``default_rng(11)`` and
  matches bit for bit;
- no persistent compile cache and no tunnel probe: the kernels build at
  first use into ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

BASELINE_PAIRS_PER_S = 1e11  # BASELINE.json: >= 1e11 pair interactions/s
GATE = 5e-5                  # max abs error / scale of every exactness gate
DT = 1.0 / 60.0


def say(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, iters: int, device):
    """``(seconds per call, last result)``: one warm call with the same
    shapes, then ``iters`` calls, each ending in a device sync, under one
    host clock."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
        sync(device)
    return (time.perf_counter() - t0) / iters, out


def wall(fn, device):
    """``(seconds, result)`` of one call ending in a device sync."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def rel_err(got, want, floor: float) -> float:
    """max |got - want| over max(floor, max |want|): the JAX harness's
    gate metric (floor 1e-6 for forces, 1.0 for positions)."""
    got, want = got.double(), want.double()
    scale = max(floor, float(want.abs().max()))
    return float((got - want).abs().max()) / scale


def _gate(name: str, rel: float):
    assert rel < GATE, f"{name}: rel err {rel:.2e} (limit {GATE:g})"


def _exact_windows(label: str, hist):
    assert all(m == 0 for _, _, m in hist), (
        f"{label} committed an inexact window: {hist}")


def free(device):
    """Release the cached blocks of the sections before (their tensors
    died with their frames)."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def particle_life_scene(device, n: int, world: float, grid=None, cap=None,
                        ocap=None, neighbor="celllist_pallas", seed: int = 0):
    """``(state, cfg)``: particle life from ``reference_config(world_size=
    world)``, drawn as ``init_scene`` draws from a CPU generator seeded
    with ``seed``. At N=262,144, world 40, grid 24, cap 32 it is the
    ``particle_life_large`` preset; at 1,048,576, 64, 40, 32, ocap 128
    ``particle_life_1m``; with ``neighbor="allpairs_pallas"`` and no grid
    the JAX harness's headline scene."""
    from .config import reference_config
    from .state import init_scene

    cfg = reference_config(world_size=world).replace(
        neighbor=neighbor, cell_grid=grid, cell_capacity=cap,
        overflow_capacity=ocap)
    return init_scene(torch.Generator().manual_seed(seed), n, cfg,
                      device), cfg


def reprobe_scene(device, n: int = 16384, crowd: int = 96,
                  world: float = 16.0, grid: int = 16):
    """``(state, cfg)`` of the re-probe scenario (bench.py:252-267): N
    uniform particles (seed 9) in a 16^3 box on a 16^3 grid at cap 8 with
    a zero attraction matrix, the first ``crowd`` of them packed within
    0.05 of (1, 1, 1) and flying outward at speed 8 (numpy,
    ``default_rng(11)``)."""
    from .config import SimConfig
    from .state import init_scene

    cfg = SimConfig(world_size=world, neighbor="celllist_pallas",
                    cell_grid=grid, cell_capacity=8,
                    attraction_matrix=np.zeros((5, 5), np.float32)).validate()
    st = init_scene(torch.Generator().manual_seed(9), n, cfg, device)
    rng = np.random.default_rng(11)
    pos = st.positions.cpu().numpy().copy()
    vel = st.velocities.cpu().numpy().copy()
    dirs = rng.normal(size=(crowd, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos[:crowd] = np.float32([1.0, 1.0, 1.0]) + dirs * 0.05
    vel[:crowd] = dirs * 8.0
    dev = st.positions.device
    return st.replace(positions=torch.from_numpy(pos).to(dev),
                      velocities=torch.from_numpy(vel).to(dev)), cfg


# ---------------------------------------------------------------------------
# the sections, in the JAX harness's order
# ---------------------------------------------------------------------------

def section_headline(device, n: int = 262144, world: float = 40.0,
                     neighbor: str = "allpairs_pallas", steps: int = 5,
                     iters: int = 3,
                     metric: str = "pair_interactions_per_sec_allpairs_N262k"):
    """bench.py:78-97: the all-pairs step (K2 under ``allpairs_pallas``),
    its pair interactions per second against the 1e11 target."""
    from .engine.step import simulate

    st, cfg = particle_life_scene(device, n, world, neighbor=neighbor)
    sec, _ = timed(lambda: simulate(st, cfg, DT, steps), iters, device)
    rate = steps / sec
    pairs = float(n) * float(n) * rate
    say(f"N={n} brute-force all-pairs ({neighbor}): {rate:.3f} steps/s = "
        f"{pairs:.3e} pair-interactions/s")
    return {"metric": metric, "value": pairs, "unit": "pairs/s",
            "vs_baseline": pairs / BASELINE_PAIRS_PER_S,
            "allpairs_steps_per_s_N262k": rate}


def section_celllist(device, n: int = 262144, world: float = 40.0,
                     grid: int = 24, cap: int = 32, steps: int = 16,
                     iters: int = 2):
    """bench.py:99-118: the exact 16-step window of ``simulate_dense`` (K1)
    on ``particle_life_large``, asserted mask-free, and its effective N^2
    rate."""
    from .engine.step import simulate_dense

    st, cfg = particle_life_scene(device, n, world, grid, cap)
    sec, (_, (mov, mis)) = timed(lambda: simulate_dense(st, cfg, DT, steps),
                                 iters, device)
    assert int(mis) == 0, (f"{n} production window must be exact: "
                           f"{int(mis)} masked")
    rate = steps / sec
    eff = float(n) * float(n) * rate
    say(f"N={n} particle-life, cell list (simulate_dense, exact): "
        f"{rate:.2f} steps/s = {eff:.3e} effective pair-interactions/s (max "
        f"movers/step {int(mov)}, capacity-masked {int(mis)})")
    return {"celllist_steps_per_s_N262k_exact": rate,
            "effective_pair_interactions_per_sec_N262k_celllist": eff}


def section_1m_windows(device, n: int = 1_048_576, world: float = 64.0,
                       grid: int = 40, cap: int = 32, ocap: int = 128,
                       short: int = 8, long: int = 16, iters: int = 2):
    """bench.py:129-146: ``particle_life_1m``'s exact windows of 8 and 16
    steps from init, each asserted mask-free; the steady rate is their
    slope (the one-time build and scatter cancel), the 16-step window's
    all-in rate its own key."""
    from .engine.step import simulate_dense

    st, cfg = particle_life_scene(device, n, world, grid, cap, ocap)
    secs = {}
    for k in (short, long):
        secs[k], (_, (_, mis)) = timed(lambda: simulate_dense(st, cfg, DT, k),
                                       iters, device)
        assert int(mis) == 0, (f"1M window-{k} must be exact: {int(mis)} "
                               f"masked")
    slope = (secs[long] - secs[short]) / (long - short)
    say(f"N={n} particle-life production path: {1 / slope:.2f} steps/s "
        f"steady-state (exact-window marginal, {slope * 1e3:.3f} ms/step; "
        f"window-{short} {secs[short] * 1e3:.3f} ms, window-{long} "
        f"{secs[long] * 1e3:.3f} ms), window-{long} all-in "
        f"{long / secs[long]:.2f} steps/s, masked 0")
    return {"steps_per_s_N1M": 1 / slope,
            "steps_per_s_N1M_window16": long / secs[long]}


def section_1m_ladder(device, n: int = 1_048_576, world: float = 64.0,
                      grid: int = 40, cap: int = 32, ocap: int = 128,
                      steps: int = 48, chunk: int = 16):
    """bench.py:156-183: the adaptive ladder across 1M's exactness horizon,
    48 steps from init in windows of 16; every committed window exact. The
    key is the second (warm) run's wall; the first goes to stderr."""
    from .engine.step import simulate_dense_adaptive

    st, cfg = particle_life_scene(device, n, world, grid, cap, ocap)
    run = lambda: simulate_dense_adaptive(st, cfg, DT, steps,  # noqa: E731
                                          chunk=chunk, verbose=say)
    cold, (_, _, hist) = wall(run, device)
    _exact_windows("1M ladder", hist)
    warm, (_, cap_end, hist) = wall(run, device)
    _exact_windows("1M ladder", hist)
    say(f"1M adaptive ladder ({steps} steps from init, chunk {chunk}): "
        f"{warm:.3f} s wall warm ({cold:.3f} s cold), end cap {cap_end}, "
        f"windows {[c for _, c, _ in hist]}, every committed window exact")
    return {"ladder_1m_48steps_wall_s": warm, "ladder_1m_committed_inexact": 0}


def section_1m_culled(device, n: int = 1_048_576, world: float = 64.0,
                      grid: int = 40, cap: int = 32, ocap: int = 128,
                      steps: int = 8):
    """bench.py:185-196: the culled rung (K4) from the 1M scene, one warm
    and one timed 8-step call (window 8)."""
    from .engine.step import simulate_culled

    st, cfg = particle_life_scene(device, n, world, grid, cap, ocap)
    simulate_culled(st, cfg, DT, steps, window=steps)
    sync(device)
    sec, (_, stats) = wall(
        lambda: simulate_culled(st, cfg, DT, steps, window=steps), device)
    ms = sec / steps * 1e3
    say(f"worklist-culled fallback at N={n} (simulate_culled, {steps} "
        f"steps): {ms:.3f} ms/step all-in ({1e3 / ms:.2f} steps/s), mean pair "
        f"frac {stats['mean_pair_frac']:.4f}, largest worklist "
        f"{stats['max_count']} tile pairs")
    return {"simulate_culled_ms_per_step_N1M": ms}


def section_ladder(device, n: int = 262144, world: float = 40.0,
                   grid: int = 24, cap: int = 32, steps: int = 64,
                   chunk: int = 16):
    """bench.py:201-227: the adaptive ladder on ``particle_life_large``, 64
    steps in windows of 16, warm second run; every window exact."""
    from .engine.step import simulate_dense_adaptive

    st, cfg = particle_life_scene(device, n, world, grid, cap)
    run = lambda: simulate_dense_adaptive(st, cfg, DT, steps,  # noqa: E731
                                          chunk=chunk, verbose=say)
    _, (_, _, hist) = wall(run, device)
    _exact_windows("adaptive ladder", hist)
    sec, (_, cap_end, hist) = wall(run, device)
    _exact_windows("adaptive ladder", hist)
    say(f"adaptive ladder (N={n}, {steps} steps, chunk {chunk}): {sec:.3f} s "
        f"wall warm, end cap {cap_end}, windows {[c for _, c, _ in hist]}, "
        f"every committed window exact")
    return {"ladder_64steps_wall_s": sec, "ladder_committed_inexact": 0}


def section_reprobe(device, n: int = 16384, crowd: int = 96,
                    world: float = 16.0, grid: int = 16, steps: int = 48,
                    chunk: int = 4, max_cap: int = 32):
    """bench.py:242-297: cluster-then-disperse (``reprobe_scene``) through
    the adaptive driver at dt 1/30 with the sidecar off: the blob must
    force the culled rung and the dispersal re-probe must return to the
    cell path, every window exact (the JAX harness's three assertions);
    warm second run."""
    from .engine.step import simulate_dense_adaptive

    st, cfg = reprobe_scene(device, n, crowd, world, grid)
    run = lambda: simulate_dense_adaptive(  # noqa: E731
        st, cfg, 1.0 / 30.0, steps, chunk=chunk, max_cap=max_cap, ocap=0,
        verbose=say)
    _, (_, _, hist) = wall(run, device)
    _exact_windows("re-probe scenario", hist)
    sec, (_, _, hist) = wall(run, device)
    backends = [c for _, c, _ in hist]
    say(f"re-probe scenario windows: {backends}")
    _exact_windows("re-probe scenario", hist)
    assert "allpairs" in backends, (
        f"blob never forced the culled backend: {hist}")
    i_cul = backends.index("allpairs")
    assert any(b != "allpairs" for b in backends[i_cul:]), (
        f"dispersal re-probe never returned to the cell path: {hist}")
    say(f"bidirectional re-probe (N={n} blob cluster->disperse, {steps} "
        f"steps): culled and a later cell window both ran, every window "
        f"exact, {sec:.3f} s wall")
    return {"reprobe_culled_then_cell_onchip": 1,
            "reprobe_scenario_wall_s": sec}


def section_celllist_vs_allpairs(device, n: int = 262144, world: float = 40.0,
                                 grid: int = 24, cap: int = 32):
    """bench.py:302-320: one force sweep of the cell path (K1 and the
    sidecar, ``fresh_celllist_forces``) against triangular all-pairs (K2)."""
    from .ops import forces as F
    from .ops.allpairs_sweep import pallas_allpairs_forces_tri
    from .ops.celllist_sweep import fresh_celllist_forces

    st, cfg = particle_life_scene(device, n, world, grid, cap)
    u, v = F.pair_features(st, cfg)
    f_cell = fresh_celllist_forces(st.positions, u, v, cfg)
    f_tri = pallas_allpairs_forces_tri(st.positions, u, v, cfg)
    rel = rel_err(f_cell, f_tri, 1e-6)
    say(f"cell list vs triangular all-pairs (N={n}, 1 force sweep): max rel "
        f"err {rel:.2e}")
    _gate("celllist vs triangular all-pairs", rel)
    return {"celllist_vs_allpairs_rel_err": rel}


def section_culled_sweep(device, n: int = 262144, world: float = 40.0,
                         grid: int = 24, cap: int = 32, iters: int = 3):
    """bench.py:324-339: the Morton-culled all-pairs sweep (K2 with its
    tile mask) against triangular all-pairs, and its ms a sweep."""
    from .ops import forces as F
    from .ops.allpairs_sweep import (pallas_allpairs_forces_culled,
                                     pallas_allpairs_forces_tri)

    st, cfg = particle_life_scene(device, n, world, grid, cap)
    u, v = F.pair_features(st, cfg)
    f_tri = pallas_allpairs_forces_tri(st.positions, u, v, cfg)
    f_culled, frac = pallas_allpairs_forces_culled(st.positions, u, v, cfg,
                                                   with_stats=True)
    relc = rel_err(f_culled, f_tri, 1e-6)
    del f_tri, f_culled
    sec, _ = timed(lambda: pallas_allpairs_forces_culled(st.positions, u, v,
                                                         cfg), iters, device)
    say(f"culled all-pairs (N={n}): {sec * 1e3:.3f} ms/sweep, surviving "
        f"tile-pair frac {float(frac):.4f}, max rel err vs triangular "
        f"{relc:.2e}")
    _gate("allpairs_culled vs triangular all-pairs", relc)
    return {"culled_sweep_ms_N262k": sec * 1e3,
            "culled_vs_allpairs_rel_err": relc}


def section_simulate_culled(device, n: int = 262144, world: float = 40.0,
                            grid: int = 24, cap: int = 32, steps: int = 8,
                            timed_steps: int = 16):
    """bench.py:344-377: 8 steps of the culled rung (K4) against 8 of the
    dense path (K1), then a warm and a timed 16-step call (window 8)."""
    from .engine.step import simulate_culled, simulate_dense

    st, cfg = particle_life_scene(device, n, world, grid, cap)
    ref, _ = simulate_dense(st, cfg, DT, steps)
    out, stats = simulate_culled(st, cfg, DT, steps, window=8)
    relw = rel_err(out.positions, ref.positions, 1.0)
    del ref
    _gate("simulate_culled vs simulate_dense", relw)
    assert stats["retries"] == 0 or stats["max_count"] > 0
    simulate_culled(out, cfg, DT, timed_steps, window=8)
    sync(device)
    sec, (_, stats) = wall(
        lambda: simulate_culled(out, cfg, DT, timed_steps, window=8), device)
    ms = sec / timed_steps * 1e3
    say(f"worklist-culled fallback (simulate_culled, N={n}): {ms:.3f} "
        f"ms/step all-in ({1e3 / ms:.2f} steps/s), mean pair frac "
        f"{stats['mean_pair_frac']:.4f}, largest worklist "
        f"{stats['max_count']} tile pairs, rel err vs dense path {relw:.2e}")
    return {"simulate_culled_ms_per_step_N262k": ms,
            "simulate_culled_vs_dense_rel_err": relw}


def section_sharded_gates(device, n: int = 262144, world: float = 40.0,
                          grid: int = 24, cap: int = 32, slab_steps: int = 4,
                          ring_steps: int = 2):
    """bench.py:386-503, on a one-rank mesh (no process group): the slab
    path (K1 halo + sidecar) periodic and walled against ``simulate_dense``
    at the preset's geometry, unserved rows 0 on both sides; the ring (K3
    a hop) against all-pairs (K2) on the headline scene; the sharded exact
    rung (``sharded_exact_steps`` at rcap = N, K3) against all-pairs."""
    from .engine.step import simulate, simulate_dense
    from .parallel import (build_sharded_dense, gather_sharded_dense,
                           make_mesh, shard_state, sharded_dense_simulate,
                           sharded_exact_steps, sharded_simulate)

    st, cfg = particle_life_scene(device, n, world, grid, cap)
    mesh = make_mesh(1, device=device)
    rec = {}
    for key, label, c in (
            ("slab_halo_vs_dense_rel_err", "slab halo", cfg),
            ("slab_walls_vs_dense_rel_err", "walled slab halo",
             cfg.replace(boundary="clamp", wrap_forces=False))):
        out, (_, mask, limbo, lost, _) = sharded_dense_simulate(
            st, c, DT, slab_steps, mesh, nsc=grid, cap=cap)
        ref, (_, mis) = simulate_dense(st, c, DT, slab_steps, nsc=grid,
                                       cap=cap)
        rel = rel_err(out.positions, ref.positions, 1.0)
        assert int(lost) == 0, f"{label}: {int(lost)} rows lost"
        assert int(mask) == 0 and int(limbo) == 0 and int(mis) == 0, (
            f"{label} gate must be exact (the sidecar serves overflow): "
            f"slab unserved masked {int(mask)} limbo {int(limbo)}, dense "
            f"masked {int(mis)}")
        _gate(f"{label} vs simulate_dense", rel)
        say(f"{label} (1-rank mesh, N={n}, {slab_steps} steps, ({grid}, "
            f"{cap})): rel err vs simulate_dense {rel:.2e}, unserved 0, "
            f"lost 0")
        rec[key] = rel

    ring_cfg = cfg.replace(neighbor="allpairs_pallas", cell_grid=None,
                           cell_capacity=None)
    ref = simulate(st, ring_cfg, DT, ring_steps)
    out = sharded_simulate(shard_state(st, mesh), ring_cfg, DT, ring_steps,
                           mesh)
    rel = rel_err(out.positions, ref.positions, 1.0)
    _gate("ring sweep vs all-pairs", rel)
    say(f"ring sweep (1-rank mesh, N={n}, {ring_steps} steps): rel err vs "
        f"all-pairs {rel:.2e}")
    rec["ring_vs_allpairs_rel_err"] = rel
    del out

    carry = build_sharded_dense(st, cfg, mesh)
    carry, ovf = sharded_exact_steps(carry, cfg, DT, ring_steps, mesh, rcap=n)
    assert int(ovf) == 0, f"sharded exact rung overflowed by {int(ovf)}"
    out = gather_sharded_dense(carry, st, mesh)
    del carry
    rel = rel_err(out.positions, ref.positions, 1.0)
    _gate("sharded exact rung vs all-pairs", rel)
    say(f"sharded exact terminal rung (1-rank mesh, N={n}, {ring_steps} "
        f"steps, rcap {n}): rel err vs all-pairs {rel:.2e}, overflow 0")
    rec["sharded_exact_rung_vs_allpairs_rel_err"] = rel
    return rec


def _slab(device, name: str, steps: int, sizes: dict):
    """The stay-sharded slab run ``name`` of ``models.presets.SLAB_RUNS``
    (``sizes`` overriding its entries) on one rank: the carry drawn from
    seed 5, ``steps`` warm steps, then ``steps`` timed."""
    from .models.presets import slab_run
    from .parallel import init_sharded_dense, make_mesh, sharded_dense_steps

    n, cfg, dt, kw = slab_run(name, **{k: v for k, v in sizes.items()
                                       if v is not None})
    mesh = make_mesh(1, device=device)
    carry = init_sharded_dense(5, n, cfg, mesh, nsc=kw["nsc"], cap=kw["cap"],
                               migcap=kw["migcap"])
    carry_bytes = sum(int(a.nbytes) for a in carry[:4])
    carry, _ = sharded_dense_steps(carry, cfg, dt, steps, mesh, n=n, **kw)
    sync(device)
    sec, (carry, (_, mask, limbo, lost, _)) = wall(
        lambda: sharded_dense_steps(carry, cfg, dt, steps, mesh, n=n, **kw),
        device)
    sec /= steps
    used = (torch.cuda.memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    trouble = int(mask) + int(limbo)
    say(f"slab stay-sharded N={n} ({name}, 1 rank, grid {kw['nsc']}, cap "
        f"{kw['cap']}, ocap {kw['ocap']}): {1 / sec:.3f} steps/s, carry "
        f"{carry_bytes / 1e9:.3f} GB, device in-use {used / 1e9:.3f} GB, "
        f"masked {int(mask)} limbo {int(limbo)} lost {int(lost)}")
    return 1 / sec, carry_bytes, trouble, int(lost)


def section_slab_2m(device, n=None, world=None, nsc=None, cap=None, mcap=None,
                    migcap=None, ocap=None, steps: int = 10):
    """bench.py:507-564: ``slab_2m`` (N=2,097,152; grid 44, cap 64, no
    sidecar) on one rank; force-frozen rows (masked + limbo) asserted 0."""
    rate, nbytes, trouble, lost = _slab(
        device, "slab_2m", steps,
        dict(n=n, world_size=world, nsc=nsc, cap=cap, mcap=mcap,
             migcap=migcap, ocap=ocap))
    assert trouble == 0, (f"slab 2M window committed {trouble} force-frozen "
                          f"rows")
    return {"slab_steps_per_s_N2M": rate, "slab_carry_bytes_N2M": nbytes,
            "slab_lost_N2M": lost, "slab_trouble_N2M": trouble}


def section_slab_8m(device, n=None, world=None, nsc=None, cap=None, mcap=None,
                    migcap=None, ocap=None, steps: int = 10):
    """bench.py:576-614: ``slab_8m`` (N=8,388,608; grid 68, cap 64, sidecar
    128) on one rank; force-frozen and lost rows asserted 0."""
    rate, nbytes, trouble, lost = _slab(
        device, "slab_8m", steps,
        dict(n=n, world_size=world, nsc=nsc, cap=cap, mcap=mcap,
             migcap=migcap, ocap=ocap))
    assert trouble == 0 and lost == 0, (
        f"slab 8M window committed {trouble} force-frozen rows, lost {lost}")
    return {"slab_steps_per_s_N8M": rate, "slab_carry_bytes_N8M": nbytes,
            "slab_trouble_N8M": trouble}


def section_allpairs_4k(device, n: int = 4096, steps: int = 200,
                        iters: int = 2):
    """bench.py:620-625: the reference scene at N=4,096 (seed 1) on
    ``allpairs_pallas`` (K2)."""
    from .config import reference_config
    from .engine.step import simulate
    from .state import init_scene

    cfg = reference_config().replace(neighbor="allpairs_pallas")
    st = init_scene(torch.Generator().manual_seed(1), n, cfg, device)
    sec, _ = timed(lambda: simulate(st, cfg, DT, steps), iters, device)
    say(f"N={n} all-pairs: {steps / sec:.1f} steps/s")
    return {"allpairs_steps_per_s_N4k": steps / sec}


def section_lj_gas(device, n=None, steps: int = 32, rebuild_every: int = 16,
                   iters: int = 2):
    """bench.py:628-639: ``lj_gas`` (BASELINE config 3) on the cadenced
    cell path (K1 on a frozen layout); stderr only, no key."""
    from .engine.step import simulate_cadenced, warmup
    from .models import make_scene

    st, cfg, dt = make_scene("lj_gas", n=n, device=device)
    st = warmup(st, cfg)
    sec, _ = timed(lambda: simulate_cadenced(st, cfg, dt, steps,
                                             rebuild_every=rebuild_every),
                   iters, device)
    say(f"N={st.n} LJ cell-list (cadenced, rebuilt every {rebuild_every}): "
        f"{steps / sec:.2f} steps/s")
    return {}


def trajectory_vs_native(state, cfg, dt, steps: int):
    """``(L2, final state)``: ``simulate`` from ``state`` against the C++
    reference engine (``native.native_simulate``) from the same arrays;
    raises ``native.NativeUnavailable`` when the engine cannot be built."""
    from . import native
    from .engine.step import simulate

    out = simulate(state, cfg, dt, steps)
    ref_pos, _ = native.native_simulate(
        state.positions.cpu().numpy(), state.velocities.cpu().numpy(),
        state.species.cpu().numpy(), cfg, dt, steps)
    l2 = float(np.sqrt(np.mean((out.positions.cpu().numpy() - ref_pos) ** 2)))
    return l2, out


def section_native_parity(device, n: int = 1000, steps: int = 120):
    """bench.py:642-663: the reference scene (seed 7) on its default
    backend against the C++ reference engine."""
    from .config import reference_config
    from .state import init_scene

    cfg = reference_config()
    st = init_scene(torch.Generator().manual_seed(7), n, cfg, device)
    l2, _ = trajectory_vs_native(st, cfg, DT, steps)
    say(f"trajectory L2 vs reference-exact native engine (N={n}, {steps} "
        f"steps): {l2:.2e}")
    return {"trajectory_l2_vs_native_N1k_120steps": l2}


CARD_SECTIONS = (section_headline, section_celllist, section_1m_windows,
                 section_1m_ladder, section_1m_culled, section_ladder,
                 section_reprobe, section_celllist_vs_allpairs,
                 section_culled_sweep, section_simulate_culled,
                 section_sharded_gates, section_slab_2m, section_slab_8m,
                 section_allpairs_4k, section_lj_gas, section_native_parity)


def run(device) -> dict:
    """Every section at bench.py's sizes on the card; on the CPU the JAX
    harness's non-TPU branch. Returns the record, keys in its order."""
    device = torch.device(device)
    if device.type != "cuda":
        rec = section_headline(
            device, n=4096, neighbor="allpairs", steps=2, iters=1,
            metric="pair_interactions_per_sec_allpairs_smallN_cpu_fallback")
        rec.update(section_native_parity(device))
        return rec
    rec = {}
    for section in CARD_SECTIONS:
        t0 = time.perf_counter()
        rec.update(section(device))
        free(device)
        say(f"{section.__name__}: {time.perf_counter() - t0:.1f} s")
    return rec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="particle3d_tpu_torch bench",
        description="Time the port's paths and assert their exactness "
                    "gates; one JSON line on stdout.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    from .state import resolve_device

    device = resolve_device(a.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    say(f"device={device} ({name}), torch {torch.__version__}")
    t0 = time.perf_counter()
    rec = run(device)
    say(f"all sections: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
