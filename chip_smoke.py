#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (particle3d_tpu_torch) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and builds the port's kernels from their
sources: the column sweep K1 (particle3d_tpu_torch/csrc/celllist_sweep.cu),
the all-pairs kernels K2, K3 and K4 (csrc/allpairs_sweep.cu), the
ghost-image sweep K5 (csrc/allpairs_mxu.cu) and the renderer's splat
kernels (csrc/splat.cu), and the C++ reference engine (native/oracle.cpp). Phases, in order; any failure exits non-zero:

  1. device: name, and power limit as nvidia-smi reports it;
  2. build the four kernel libraries with nvcc and the reference engine
     with g++, in parallel (seconds, registers and spills of every kernel);
  3. K1 against its plain torch version on the same operands: the
     particle_life_large layout at N=262,144 (grid 24), periodic and
     walled at cap 32 and periodic at cap 64, then Lennard-Jones, gravity
     and spring at N=32,768, Lennard-Jones at cap 16, particle life at
     cap 512 (the capacity ladder's top rung), an odd grid that no block
     height divides (nsc 17, cap 32), a walled scene with its x >= 0 half
     empty (whole empty columns), and a lattice that fills every supercell
     exactly to cap 8; every K1 comparison in this script also requires
     exactly 0 on the dead receiver rows (own gate <= 0), and the idle-lane
     share of K1's sweep loop on the 262k layout is printed (a model from
     the layout's occupancy and the library's launch geometry);
  4. main path: a 16-step simulate_dense window at N=262,144 (no masked
     rows, one K1 launch per step, finite state), its step-0 forces on
     4,096 particles against a plain all-pairs sweep over all sources, a
     bit-identical rerun, and ms/step;
  5. the `run` command (capacity ladder) for 48 steps at N=262,144, then
     the ms/step of a 16-step window at the capacity it ended on;
  6. a 16-step simulate_dense window at N=1,048,576;
  7. K3 against its plain version: 4,096 sampled receivers against all
     262,144 sources of a particle_life_large_allpairs scene, then
     same-set sweeps at N=1,536 for the four laws and with 12 species, and
     at N=1,000 (a ragged receiver block);
  8. K2 against its plain version at N=32,768 (particle life periodic and
     walled, gravity with random masses, spring, Lennard-Jones on a
     jittered lattice), at N=12,345 (97 tiles: odd count, ragged last
     tile) and at N=262,144 (whole, run twice on the same operands for
     bit-identical outputs, and on 4,096 sampled receivers against the
     plain rectangular sweep), then its mask mode against dense K2 on
     a clustered N=32,768 scene, and a scene with padded rows at the
     origin and a real particle 1e-4 from them under Lennard-Jones (N=300:
     finite, and equal to plain all-pairs);
  9. K4 against its plain version at N=32,768 (particle life periodic and
     walled, Lennard-Jones on a jittered lattice) and N=12,345, and at
     N=262,144 against dense K2 on the Morton-sorted particle_life_large
     scene (the worklist's runs a receiver tile, mean and longest, the
     shares S of a run and the blocks launched printed), and on phase 8's
     padded-row scene with the lower-triangular worklist (the padded tile
     as a receiver, entries j < i);
 10. the all-pairs paths: `run --preset particle_life_large_allpairs
     --steps 4` (4 K2 launches), two steps of it rerun bit-identically, the
     flagship step (reference scene, N=4,096) against plain all-pairs and
     its ms/step,
     particle_life_large at N=1,536 (K3), verlet_elastic and gravity_nbody,
     2 steps of simulate on particle_life_large with the allpairs_culled
     backend (K2 in mask mode), and simulate_culled on particle_life_large
     (16 steps, one K4 launch a step, a bit-identical rerun);
 11. the capacity ladder's terminal rung: simulate_dense_adaptive at
     N=262,144 with a dense blob, no sidecar and max_cap 64 falls back to
     the culled rung;
 12. K1's halo mode (the slab decomposition's kernel) against its plain
     version at the particle_life_large geometry (grid 24, cap 32),
     periodic and walled: on the 1-rank extended operands (576 receiver
     columns, 624 source columns, plus the dummy when walled), on an
     interior-split call (528 receiver columns, the pack itself as
     sources), on a one-plane call (one receiver plane, three source
     planes), and at feature width 16 (12 species); halo K1 against
     non-halo K1 on the same layout; K1 against its plain version at
     width 16;
 13. the 1-rank slab gates: sharded_dense_simulate against simulate_dense
     (4 steps at N=262,144, periodic and walled: unserved 0, lost 0,
     max |dpos| / scale < 5e-5), sharded_simulate against simulate on the
     flagship N=4,096 on allpairs_pallas (2 steps, K3), and
     sharded_exact_steps against simulate(allpairs_pallas) at N=32,768;
 14. full width, stay-sharded on one rank: the JAX bench's N=8,388,608
     (world 100, grid 68, cap 64, sidecar 128) and N=2,097,152 (world 64,
     grid 44, cap 64) runs: init_sharded_dense, 10 warm steps, 10 timed
     steps (masked + limbo 0, lost 0), ms/step, carry bytes, peak device
     memory, host synchronisations per step, and K1 halo's time per launch
     at 8M against its plain version, with its modelled idle-lane share;
 15. K5 against its plain version: the four laws of phase 8 at N=32,768
     (periodic, with ghost images) and particle life walled (no ghosts),
     N=12,345 (a ragged last tile), 12 species (feature width 16); fast
     mode against a direct all-pairs sweep on the JAX test's N=200 scenes
     (world 10, periodic and walled) and at N=32,768 in a world of 20; then
     the particle_life_large_allpairs scene at N=262,144 with its 66,432
     ghost rows, timed against the plain version and run twice for
     bit-identical outputs, and fast mode there (its error printed, not
     gated);
 16. the K5 path at full width: 4 steps of simulate on that scene with
     neighbor="allpairs_mxu" (4 K5 launches, finite state, ms/step, peak
     device memory), two steps rerun bit-identically, its step-0 forces
     against the K2 path's, and the ghost count within capacity before and
     after;
 17. lj_gas: `run --preset lj_gas --steps 16` at N=262,144 (K1 with the
     Lennard-Jones law, velocity Verlet, the capacity ladder; masked 0)
     and the ms/step of a 16-step window; K1 against its plain version on
     its layout (cap 16); the XLA-style `celllist` backend on CUDA tensors
     against the K2 path on a 4,096-particle block of the lj_gas lattice;
     fresh_celllist_forces at cell_grid=2 against the plain all-pairs
     sweep; then the cadenced path as the JAX bench times Lennard-Jones:
     simulate_cadenced, 32 steps, layout rebuilt every 16 (one K1 launch
     a step, nothing dropped, drift inside the budget of 0.25, a
     bit-identical rerun), against simulate_dense from the same state
     (max |dpos| / world <= 1e-5), ms/step beside the dense path's;
 18. the app path at full width, particle_life_large (N=262,144, grid
     24): layout_forces on a fresh cap-64 layout bit-identical to
     fresh_celllist_forces (no sidecar), dense_forces exactly 0 on dead
     slots; simulate_cadenced at cap 64, 16 steps, rebuilt every 4, as in
     phase 17 against simulate_dense (the drift of an 8-step cadence is
     printed, not gated: from rest it exceeds the budget); a SimulationApp at the preset's cap
     32: the rows a cap-32 build drops, a first 4-step batch that rewinds
     and escalates, a cadenced 4-step batch, two 1-step carry batches
     (simulate_dense_carry; the second reuses the kept layout: no dense
     build), one K1 launch a step and masked 0 in each, ms per batch; the
     terminal fallback: phase 11's blob in an app with max_cap 64 escalates,
     then commits on simulate_culled (K4), bit-identical to simulate_culled
     from the same start; the splat kernels (csrc/splat.cu) against the
     plain torch renderer, both on the card, at 640x480 on the app's
     state: every pixel equal at the app's pose (with and without the
     border), inside the box at its centre (footprints 7, 5 and 3: radii
     reach footprint / 2, so every offset of the dilate covers) and
     inside the box turned (particles behind the camera and off screen),
     and at the app's pose from positions that are a view of wider rows,
     one launch of each kernel a frame; both paths' CUDA-event ms and
     device operations a frame, each kernel's ms against its bytes'
     bound, and 20 profiled frames' render.frame spans all on the kernel
     path; app.render at 640x480, both methods, against
     the same frame rendered on the CPU (>= 99.9% of pixels equal),
     ms/frame; app.save, SimulationApp.load and four more steps against
     the uninterrupted app (bit-identical when both rebuild their layout);
 19. the HTTP server (ThreadingHTTPServer on 127.0.0.1, a free port) on
     phase 18's app: GET / and /gl, /config, /positions.bin (8 + 13 N
     bytes, decoding to the app's positions and species), /frame.png at
     320x240 (its IDAT decoding to app.render), POST /control (set_drag,
     keys; /config shows the drag), /metrics (the step advanced); wall ms
     per request;
 20. the adaptive slab driver on slab_2m (the `slab` command's seed-0
     scene, N=2,097,152, grid 44, cap 64, no sidecar), one rank, 32 steps
     in windows of 16: cap 64 masks first at step 14 (checked by two
     prefix windows); the first window rewinds, recaps to 128 and commits
     masked 0 (one rewind, one K1 halo launch a step run, the host syncs
     counted); the recap's ms, ms/step at each capacity, peak device
     memory; the committed carry, gathered, against sharded_dense_steps at
     cap 128 from the same start (max |dpos| / world <= 1e-5);
 20b. its exact terminal rung on phase 11's blob (262k, max_cap 64, ocap
     0, 16 steps in windows of 8): the ladder ends, the exact windows run
     K3 once a step and never the plain sweep on a CUDA tensor, every
     committed window has masked 0, positions within rtol 1e-4 / atol 1e-5
     of simulate_dense_adaptive; the "exact_replicated" rung (K4) against
     it too; ms/step on the rung (and on re-entry, if the blob disperses),
     K3's ms per launch at 262,144 x 262,144 and its bound; K3 at that
     shape held against its plain version on 4,096 receivers (the blob's
     2,000 and a sample) against all sources, unmasked and on
     ring.masked_rect_operands with a quarter of the sources at r2 = -1;
 21. the column-slab cell path, sharded_cell_simulate on
     particle_life_large at cap 64, rebuilt every 4, 16 steps, one rank:
     one K1 halo launch a step, against simulate_cadenced (max |dpos| /
     world <= 1e-5, bit-identity reported), ms/step beside
     simulate_cadenced's in the same run;
 22. the 2-level ring, sharded_simulate_2level on a 1 x 1 mesh on the
     flagship scene (N=4,096, allpairs_pallas): two K3 launches, against
     simulate;
 22b. with two or more cards: dryrun_multichip(2) (and (4) with four
     cards) on NCCL (among its steps the 2-level ring on a 2 x D/2 mesh,
     point-to-point on subgroups), and `torchrun -m particle3d_tpu_torch.parallel.dryrun
     --slab-parity slab_2m` at D = 2 (and 4): the gathered state against
     D = 1 (max |dpos| / world <= 1e-5, masked, limbo and lost 0); the
     scale-out launcher (examples/scaleout.py) at full N: `--ring-parity
     ring2m` at D = 2 and 4 and `--ring-parity ring2level` on a 2 x 2 mesh,
     one step from one scene against ring2m on one card (max |dpos| /
     world and max |dvel| / max |vel| <= 1e-5), and, with four cards,
     `torchrun -m particle3d_tpu_torch.examples.scaleout slab16m --full
     --checkpoint DIR` twice at D = 4 (a fresh run saved, then resumed and
     saved; masked, limbo and lost 0), then the step of the second save
     saved again by two ranks into DIR (parallel.dryrun.carry_resume at
     N=16,777,216) and restored at D = 2, bit-identical to the run
     continued in memory; with one card, a line saying it was not run;
 23. the geometry tuner (utils.tune, the `tune` command's function) on
     particle_life_large: its 8 default candidates (grid 40 at capacities
     6, 7, 9, 11, 13, 17 and grid 39 at 6, 7) and the preset's hand-tuned
     (24, 32), 8-step windows, one warm and 3 timed each, run twice: the
     ranked table (grid, cap, ms/step, masked) of each run, K1 launched
     candidates x 4 x 8 times in each, whether the top candidate repeats
     and where the hand-tuned geometry ranks; then every geometry's step-0
     forces on 4,096 sampled rows against the plain all-pairs sweep over
     the particles its layout places (a geometry that masks leaves the
     others out of both sides);
 24. autograd: the gradient of the capped snapshot loss with respect to
     the attraction matrix at tests/test_learn_matrix.py's size (N=96, 2
     scenes, 2 species) on the card against the CPU (rel. L2 <= 1e-4);
     python -m particle3d_tpu_torch.examples.learn_matrix at its defaults
     (N=256, 4 scenes, 12 steps, a snapshot every 3, 300 iterations of
     clipped Adam): final loss < 0.05 x the first, max matrix error
     printed; allpairs_pallas, allpairs_culled, allpairs_mxu and
     celllist_pallas raise under grad before any kernel launch, and step
     under torch.no_grad;
 25. checkpoints (utils.orbax_ckpt): particle_life_large after 4 steps
     saved synchronously and asynchronously, restored bit-identically, 4
     more steps from each bit-identical (8 K1 launches); a slab_2m carry
     at one rank saved after 4 steps, restored and run 4 more, bit-
     identical to the run continued in memory and to 8 uninterrupted
     steps (20 K1 halo launches); save and restore MB/s; with two or more
     cards the same resume at D = 2 on NCCL with async saves;
 26. utils.profiling.benchmark_steps on phase 5's 16-step window, beside
     phase 5's time; utils.profiling.trace of one window, whose file and
     kernel events hold K1 (16 launches); utils.metrics' kinetic_energy
     and total_momentum on the card against float64 sums on the host
     (rel 1e-5);
 27. native parity (bench.py's gate): the reference scene at N=1,000, 120
     steps, simulate on the card on allpairs (plain torch) and on
     allpairs_pallas (K3, 120 launches), each against the C++ reference
     engine native/oracle.cpp (built with g++ in phase 2), L2 < 5e-3;
 28. ring2m, BASELINE config 4 (examples/scaleout.py): gravity at
     N=2,097,152 (world 40, radius 20, leapfrog): K3 at 2,097,152^2, one
     launch timed, held against its plain version on 2,048 sampled
     receivers against all sources, and both against a float64 sum on them
     (K3's relative L2 at most twice the plain version's); the launcher's
     run_ring on one rank, 1 untimed + 2 timed steps (one K3 launch a
     step), ms/step and pair interactions a second; the D = 1 ring at
     N=262,144 against simulate on the K2 path, 2 steps (max |dpos| /
     scale < 5e-5, max |dvel| / max |vel| <= 1e-4);
 29. slab16m, BASELINE config 5's direction (examples/scaleout.py): particle
     life at N=16,777,216, grid 64, cap 161 (42.2M slots), one rank: the
     launcher's run_slab with --checkpoint, 1 untimed + 4 timed steps
     (masked, limbo and lost 0, one K1 halo launch a step), ms/step, peak
     device memory, the carry's bytes and save MB/s; K1 halo timed on the
     whole layout and held against its plain version on receiver planes
     0, 32 and 63; the saved carry restored bit-identically into a fresh
     carry, 2 steps from it bit-identical to 2 continued in memory,
     restore MB/s; the directory deleted;
 30. examples/render_demo.py on particle_life_large: 16 warm steps, 8
     frames of 4 steps at 480x360 into a GIF under build/chip_smoke/ (8
     frames), one K1 launch a step and one launch of each splat kernel a
     frame, ms a frame;
 31. the bench command: particle3d_tpu_torch.bench.main, the function
     `python -m particle3d_tpu_torch bench` runs, in process with every
     launch count at 0: its one JSON line (logged) holds exactly the keys
     of BENCH_r05.json's "parsed", every *_rel_err < 5e-5, every
     *_trouble_*, *_lost_* and *_committed_inexact 0, and
     reprobe_culled_then_cell_onchip 1; K1, K1 halo, K2, K3 and K4 each
     launched (K5 not), the phase's seconds; then K4 at N=1,048,576
     (particle_life_1m, Morton-sorted) timed and held against its plain
     version, with its worklist and bound;
 32. host synchronisations (utils.profiling's recorder): on
     particle_life_large at N=262,144, a 256-step ladder episode from cap
     32, a ladder held at cap 16 (every window masks: culled windows, a
     rewound cell re-probe), and app frames (run_steps(2) and a 640x480
     render) on the cadenced, carry and culled paths, under a
     torch.profiler session with torch's GPU trace on: every stream,
     device or event synchronisation made from the port's code falls
     inside one of the recorder's sync.* spans and every such span holds
     one at least (the sites and the syncs a span, logged); the
     recorder's cost a call on this host, off and on.

Tolerance for every force comparison: relative L2 error <= 1e-5 and max
abs error <= 1e-4 * max|F|. Between a kernel and its plain version only
the order of the sums differs. A comparison also fails if max|F| exceeds
1e6: such a scene is dominated by one near-singular pair, and the bounds
would then pass a wrong kernel. K5 sums in factored form (|p|-sized terms
that cancel), so its exact mode is held to relative L2 <= 3e-5 and max abs
<= 1e-4 * max|F|, against its plain version and against the K2 path. Its
fast mode is held to max abs <= 3e-3 * max|F| against a direct sweep on
the JAX test's scenes (its own bound, tests/test_pallas_mxu.py), and to
relative L2 <= 1e-3 (the JAX module's stated accuracy) at N=32,768, where
one pair at distance 0.012 puts the formulation's own max abs error at
3.3e-3 * max|F| (its plain version on the CPU against a float64 sum).

The second-to-last line is a JSON record of each kernel (K1 and its halo
mode are separate entries): launches on the path that drives it (each
path runs with every count set to 0 just before it; K1 halo's is the 8M
timed window), and, under "launches_by_path", on phases 20-31's paths;
error against the plain version, its time and the plain
version's at the stated shape, and the bound: the larger of the operations
over their peak rates (the rank-1 coefficients, and K5 fast mode's Gram
product, at 495 TFLOP/s TF32, the rest at 67 TFLOP/s FP32; counted per pair
on the unpadded feature width, particle3d_tpu_torch/utils/bounds.py) and
the bytes over 3.35 TB/s; K5's pairs are those of its live rows, reals and
the ghosts in use. Each bound is also printed with every operation at the
FP32 rate, as the port counted before its tensor-core kernels. The last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from particle3d_tpu_torch.utils.bounds import (bound, ops_mxu, ops_one_sided,
                                               ops_two_sided)

DEVICE = "cuda"
TOL_REL_L2 = 1e-5
TOL_MAX_ABS = 1e-4  # times max|F|
# K5's factored sums (see the docstring); fast mode's Gram-form d^2: the
# JAX test's bound on its own scenes, the JAX module's stated relative
# accuracy beyond them
K5_REL_L2 = 3e-5
FAST_MAX_ABS = 3e-3  # times max|F|, no relative L2 gate
FAST_REL_L2 = 1e-3
# A scene whose largest force exceeds this is degenerate (near-coincident
# pairs under a singular law): one pair would dominate both error bounds
MAX_PLAUSIBLE_F = 1e6
N_LARGE = 262_144
N_SMALL = 32_768
N_DENSE = 20_000  # ~312 occupants per cell of a 4^3 grid
N_ODD = 78_608    # 16 a supercell of a 17^3 grid
STEPS = 16
N_SAMPLE = 4096   # receivers sampled for checks against all sources
N_RECT = 1536     # same-set K3 sweeps (below the N=2,048 switch to K2)
# a ragged last tile and an odd tile count (97 tiles of 128; K3: 8 blocks)
N_RAGGED = 12_345
N_RAGGED_RECT = 1000
N_FLAGSHIP = 4096
N_BLOB = 2000     # particles packed into one cell for the terminal rung
SLAB_STEPS = 10   # warm and timed windows of the full-width slab runs


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def timed_ms(fn, reps, warm=True):
    """Mean ms per call of ``fn`` on the card (CUDA events), after one
    warm-up call with the same arguments unless ``warm`` is False."""
    if warm:
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps, out


def compare(name, got, want, rel_l2_tol=TOL_REL_L2, max_abs_tol=TOL_MAX_ABS,
            gate=True):
    """Fail unless ``got`` matches ``want`` within the stated tolerance
    (``rel_l2_tol`` None: no relative L2 gate; ``gate`` False: print the
    error only)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    scale = want.abs().max().item()
    rel_l2 = (torch.linalg.vector_norm(got - want)
              / torch.linalg.vector_norm(want)).item()
    max_abs = err.max().item()
    ok = (bool(torch.isfinite(got).all())
          and (rel_l2_tol is None or rel_l2 <= rel_l2_tol)
          and max_abs <= max_abs_tol * scale and 0 < scale <= MAX_PLAUSIBLE_F)
    if not gate:
        log(f"  {name}: rel_l2={rel_l2:.3e} max_abs={max_abs:.3e} "
            f"({max_abs / max(scale, 1e-30):.3e} of max|F|={scale:.3e}), "
            f"not gated")
        return max_abs
    log(f"  {name}: rel_l2={rel_l2:.3e} max_abs={max_abs:.3e} "
        f"max|F|={scale:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside tolerance, or max|F| "
                             f"not in (0, {MAX_PLAUSIBLE_F:g}]")
    return max_abs


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[1] device: {name} (count {torch.cuda.device_count()}); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name, smi


def phase_build():
    from particle3d_tpu_torch import native
    from particle3d_tpu_torch.ops import (allpairs_mxu_sweep, allpairs_sweep,
                                          celllist_sweep)
    from particle3d_tpu_torch.render import splat

    def build_native():
        native.load()
        return ""

    t0 = time.perf_counter()
    libs = {"K1": celllist_sweep.build_kernel,
            "K2-K4": allpairs_sweep.build_kernel,
            "K5": allpairs_mxu_sweep.build_kernel,
            "splat": splat.build_kernel, "native": build_native}
    with ThreadPoolExecutor(len(libs)) as pool:  # one compiler per source
        logs = dict(zip(libs, pool.map(lambda build: build(), libs.values())))
    log(f"[2] K1, K2-K4, K5, the splat kernels (nvcc) and the native "
        f"reference engine (g++) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, build_log in logs.items():
        for line in _ptxas_summary(build_log):
            log(f"  {name}: {line}")


_LAWS = ("particle_life", "lennard_jones", "gravity", "spring")


def _ptxas_summary(build_log):
    """One line per compiled kernel (family, law, wrap, feature width; the
    splat kernels' species type or window): registers, spill bytes and
    shared memory, from nvcc's -Xptxas -v."""
    out, entry, spills = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"(column_sweep|rect|tri|pairlist|mxu)_kernelI"
                      r"((?:L[ib]\d+E)+)", line)
        splat = re.search(r"(seed|dilate)_kernelI(i|l|Li(\d)E)E", line)
        if splat:
            arg = {"i": "int32", "l": "int64"}.get(splat.group(2),
                                                   f"HALF={splat.group(3)}")
            entry = f"{splat.group(1)}<{arg}>"
        elif m:
            args = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(2))]
            extra = {2: "", 3: f", P={args[-1]}",
                     4: f", halo={args[2]}, P={args[-1]}"}[len(args)]
            flag = "fast" if m.group(1) == "mxu" else "wrap"
            entry = (f"{m.group(1)}<{_LAWS[args[0]]}, {flag}={args[1]}"
                     f"{extra}>")
        elif entry and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            spills = f"spills {st}/{ld} B"
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{entry}: {regs} registers, {spills}, smem "
                       f"{smem.group(1) if smem else 0} B")
            entry = None
        elif line.startswith("["):
            out.append(line.strip())
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_text(b):
    return (f"bound {b[0]:.4f} ms ({b[1]}; with every operation at the FP32 "
            f"rate {b[2]:.4f} ms)")


def feature_width(state, cfg):
    """Columns of U (and V) that coef = U.V needs: 5 for five-species
    particle life. The kernels see them zero-padded to 8 or 16."""
    from particle3d_tpu_torch.ops import forces as F

    return F.pair_features(state, cfg)[0].shape[1]


def k1_pairs(r2, nsc, cap):
    """Ordered pairs K1 must evaluate on a periodic layout with gate ``r2``
    (one entry per slot): each occupied aligned slot against the other
    occupants of its 27 neighbouring supercells."""
    occ = (r2 > 0).reshape(nsc, nsc, nsc, cap).sum(-1).to(torch.float64)
    nbr = sum(torch.roll(occ, (dx, dy, dz), (0, 1, 2))
              for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    return float((occ * nbr).sum() - occ.sum())


def k1_idle_lane_share(live, nsc, cap, p=8):
    """Share of K1's sweep-loop lane slots that evaluate no live pair on a
    periodic layout with own gates ``live`` [nsc^2, nsc*cap] and feature
    width ``p``: a model computed from this run's occupancy and the block
    geometry the library reports (``launch_geometry``), not a count taken
    on the device. Blocks of zr supercells, R receivers of one supercell a
    thread, and each warp runs a neighbour window as long as its longest
    lane, so a lane is idle on a second receiver its supercell lacks and
    while its neighbours finish longer windows (stage splits are not
    counted)."""
    import torch.nn.functional as tnf
    from particle3d_tpu_torch.ops.celllist_sweep import launch_geometry

    ncol = nsc * nsc
    geo = launch_geometry(nsc, cap, ncol, p)
    if geo["nsub"] != 1:
        raise ValueError(f"idle-lane model: cap {cap} splits supercells")
    zr, nzb, rpt = geo["zr"], geo["nzb"], geo["receivers_per_thread"]
    occ = live.reshape(nsc, nsc, nsc, cap).sum(-1)            # [x, y, z]
    zwin = occ + occ.roll(1, 2) + occ.roll(-1, 2)
    win = torch.stack([zwin.roll((-dx, -dy), (0, 1)) for dx in (-1, 0, 1)
                       for dy in (-1, 0, 1)], 2).reshape(ncol, 9, nsc)
    occ_c = occ.reshape(ncol, nsc)
    t = (occ_c + rpt - 1) // rpt                              # tasks
    tb = tnf.pad(t, (0, nzb * zr - nsc)).reshape(ncol, nzb, zr)
    start = (tb.cumsum(-1) - tb).reshape(ncol, -1)[:, :nsc].reshape(-1)
    block = (torch.arange(ncol, device=live.device)[:, None] * nzb
             + torch.arange(nsc, device=live.device)[None] // zr).reshape(-1)
    tf = t.reshape(-1)
    sc = torch.repeat_interleave(torch.arange(ncol * nsc, device=live.device),
                                 tf)
    first = tf.cumsum(0) - tf
    local = start[sc] + torch.arange(sc.shape[0], device=live.device) - first[sc]
    warps = -(-int(tb.sum(-1).max()) // 32)                   # per block, all passes
    key = block[sc] * warps + local // 32                     # the warp
    w = win.permute(0, 2, 1).reshape(ncol * nsc, 9)[sc]
    mx = torch.zeros((int(key.max()) + 1, 9), dtype=w.dtype,
                     device=live.device).scatter_reduce_(
        0, key[:, None].expand(-1, 9), w, "amax")
    useful = (occ_c * win.sum(1)).sum().item()
    return 1.0 - useful / (32 * rpt * mx.sum().item())


def _dead_rows_zero(label, got, live):
    """Fail unless K1 left exactly 0 on every receiver row whose own gate
    is <= 0 (``live`` [NCOL, CS] is the own gate > 0)."""
    dead = got.permute(0, 2, 1)[~live]
    if not bool((dead == 0).all()):
        raise AssertionError(f"{label}: {int((dead != 0).any(-1).sum())} dead "
                             f"receiver rows are not exactly 0")
    log(f"  {label}: {dead.shape[0]} dead receiver rows, all exactly 0")


def _sweep_case(label, state, cfg, reps, idle_share=False):
    """Time and compare K1 with its plain version on one dense layout."""
    from particle3d_tpu_torch.ops import celllist_sweep as S
    from particle3d_tpu_torch.ops.celllist_dense import build_dense, sweep_operands
    from particle3d_tpu_torch.ops.params import pack_params

    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    ds = build_dense(state, cfg, nsc, cap)
    ops = sweep_operands(ds.pos, ds, cfg, nsc, cap)
    args = (pack_params(cfg), cfg.force_law, bool(cfg.wrap_forces), nsc, cap)
    ms, got = timed_ms(lambda: S.column_sweep_forces(*ops, *args), reps)
    plain_ms, want = timed_ms(lambda: S.column_sweep_forces_ref(*ops, *args), 2)
    live = (ds.r2 > 0).reshape(nsc * nsc, nsc * cap)  # occupied, aligned
    pick = lambda f: f.permute(0, 2, 1)[live]  # noqa: E731
    b = bound(k1_pairs(ds.r2, nsc, cap),
              ops_one_sided(feature_width(state, cfg), False), nbytes(*ops, got))
    log(f"  {label}: {int(live.sum())} receivers, K1 {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, {bound_text(b)}")
    err = compare(label, pick(got), pick(want))
    _dead_rows_zero(label, got, live)
    if idle_share:
        log(f"  {label}: idle-lane share of K1's sweep loop (model from "
            f"the occupancy and the launch geometry) "
            f"{k1_idle_lane_share(live, nsc, cap):.4f}")
    return err, ms, plain_ms, b


def phase_sweeps():
    from particle3d_tpu_torch.config import reference_config
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.state import init_scene

    log(f"[3] K1 against its plain version (N={N_LARGE}, grid 24, cap 32)")
    st, cfg, _ = make_scene("particle_life_large", seed=0, n=N_LARGE,
                            device=DEVICE)
    main = _sweep_case("particle_life wrap", st, cfg, reps=20,
                       idle_share=True)
    _sweep_case("particle_life walled", st,
                cfg.replace(boundary="clamp", wrap_forces=False), reps=5)
    # the rung the `run` command commits at this N (phase 5)
    _sweep_case("particle_life wrap cap 64", st,
                cfg.replace(cell_capacity=64), reps=10)
    gen = torch.Generator().manual_seed(1)
    base = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=16, cell_capacity=32)
    small = {
        "lennard_jones": base.replace(force_law="lennard_jones",
                                      particle_effect_radius=0.5,
                                      lj_sigma=0.1, lj_epsilon=0.5),
        "gravity": base.replace(force_law="gravity", particle_effect_radius=1.0,
                                gravity_softening=0.05),
        "spring": base.replace(force_law="spring", particle_effect_radius=0.75),
    }
    # a jittered 32^3 lattice (spacing 0.5): uniform random points would
    # put near-coincident pairs under the LJ core (forces ~1e18)
    side = round(N_SMALL ** (1 / 3))
    lin = (torch.arange(side) + 0.5) * (16.0 / side) - 8.0
    lattice = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    lattice = lattice.reshape(-1, 3) + 0.05 * torch.randn(N_SMALL, 3, generator=gen)
    for law, c in small.items():
        s = init_scene(gen, N_SMALL, c, DEVICE)
        s = s.replace(masses=0.5 + torch.rand(N_SMALL, generator=gen).to(DEVICE))
        if law == "lennard_jones":
            s = s.replace(positions=lattice.to(DEVICE))
        _sweep_case(f"{law} wrap (N={N_SMALL}, grid 16)", s, c, reps=5)
        if law == "lennard_jones":  # 8 particles a supercell
            _sweep_case(f"{law} wrap cap 16 (N={N_SMALL}, grid 16)", s,
                        c.replace(cell_capacity=16), reps=5)
    # the capacity ladder's top rung: at cap 512 each block serves its
    # receivers in two passes of 256 threads, and cells hold > 256 occupants
    dense = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=4, cell_capacity=512)
    _sweep_case(f"particle_life wrap (N={N_DENSE}, grid 4, cap 512)",
                init_scene(gen, N_DENSE, dense, DEVICE), dense, reps=5)
    # an odd grid that no block height divides: 17 supercells a column
    odd = reference_config(world_size=25.5).replace(
        neighbor="celllist_pallas", cell_grid=17, cell_capacity=32)
    _sweep_case(f"particle_life wrap (N={N_ODD}, grid 17, cap 32)",
                init_scene(gen, N_ODD, odd, DEVICE), odd, reps=5)
    # walled, the x >= 0 half empty: whole columns without a particle
    half = base.replace(boundary="clamp", wrap_forces=False)
    s = init_scene(gen, N_SMALL, half, DEVICE)
    pos = s.positions.clone()
    pos[:, 0] = -pos[:, 0].abs()
    _sweep_case(f"particle_life walled, x >= 0 empty (N={N_SMALL}, grid 16)",
                s.replace(positions=pos), half, reps=5)
    # every supercell filled exactly to cap: a 16^3 lattice of spacing 1 in
    # a grid of 8 cells of 2
    full = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=8, cell_capacity=8)
    lin = torch.arange(16) - 7.5
    lat = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    lat = lat.reshape(-1, 3) + 0.05 * torch.randn(4096, 3, generator=gen)
    s = init_scene(gen, 4096, full, DEVICE).replace(positions=lat.to(DEVICE))
    _sweep_case("particle_life wrap, every supercell full (N=4096, grid 8, "
                "cap 8)", s, full, reps=5)
    return main


def _step0_forces_check(state, cfg, n_sample=4096, label=""):
    """Dense-path step-0 pair forces against a plain all-pairs sweep over
    the particles the layout places (a slot or the sidecar): a geometry
    that masks rows leaves the others out of both sides of its sweep.
    With every particle placed this is the sweep over all of them."""
    from particle3d_tpu_torch.engine.step import dense_pair_forces
    from particle3d_tpu_torch.ops import forces as F
    from particle3d_tpu_torch.ops.allpairs import allpairs_forces
    from particle3d_tpu_torch.ops.celllist_dense import (OCAP, build_dense,
                                                         sidecar_indices)

    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    ds = build_dense(state, cfg, nsc, cap)
    f_slot = dense_pair_forces(ds.pos, ds, sidecar_indices(ds), cfg, nsc, cap, OCAP)
    f = torch.zeros_like(state.positions)
    occ = ds.pid >= 0
    f[ds.pid[occ]] = f_slot[occ]
    placed = torch.zeros(state.n, dtype=torch.bool, device=DEVICE)
    placed[ds.pid[occ]] = True
    rows = torch.nonzero(placed.cpu())[:, 0]
    gen = torch.Generator().manual_seed(2)
    idx = rows[torch.randperm(rows.numel(), generator=gen)[:n_sample]].to(DEVICE)
    u, v = F.pair_features(state, cfg)
    want = allpairs_forces(state.positions[idx], u[idx], v, cfg, block_i=128,
                           src_positions=state.positions, src_v=v,
                           src_valid=None if bool(placed.all()) else placed)
    compare(f"{label}step-0 forces of {idx.numel()} particles vs all-pairs "
            f"({state.n - rows.numel()} unplaced)", f[idx], want)


def phase_main_path():
    from particle3d_tpu_torch.engine.step import simulate_dense
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import celllist_sweep as S
    from particle3d_tpu_torch.ops import reset_kernel_launches

    log(f"[4] main path: simulate_dense, {STEPS} steps, N={N_LARGE}")
    st, cfg, dt = make_scene("particle_life_large", seed=0, n=N_LARGE,
                             device=DEVICE)
    sync()
    reset_kernel_launches()
    out, (mov, mis) = simulate_dense(st, cfg, dt, STEPS)
    sync()
    launches = S.KERNEL_LAUNCHES
    log(f"  max_movers={int(mov)} max_masked={int(mis)} K1 launches={launches}")
    if int(mis) != 0:
        raise AssertionError(f"{int(mis)} rows masked on the exact path")
    if launches != STEPS:
        raise AssertionError(f"K1 launched {launches} times in {STEPS} steps")
    for name in ("positions", "velocities"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"non-finite {name}")
    _step0_forces_check(st, cfg)
    ms, again = timed_ms(lambda: simulate_dense(st, cfg, dt, STEPS)[0], 1)
    if not (torch.equal(again.positions, out.positions)
            and torch.equal(again.velocities, out.velocities)):
        raise AssertionError("a rerun from the same state is not bit-identical")
    log(f"  rerun bit-identical; {ms / STEPS:.3f} ms/step "
        f"({STEPS}-step window incl. layout build and write-back, CUDA events)")
    return launches, ms / STEPS


def phase_ladder():
    from particle3d_tpu_torch.__main__ import main as cli

    log(f"[5] python -m particle3d_tpu_torch run --preset particle_life_large "
        f"--steps 48")
    rec = cli(["run", "--preset", "particle_life_large", "--steps", "48",
               "--device", DEVICE])
    if rec["n"] != N_LARGE or not rec["history"] or any(
            masked for _, _, masked in rec["history"]):
        raise AssertionError(f"ladder run not exact: {rec['history']}")
    if rec["kernel_launches"] < 48:
        raise AssertionError(f"{rec['kernel_launches']} K1 launches in 48 steps")
    # the capacity `run` ends on is what its users' steps cost
    cap = rec["history"][-1][1]
    return cap, _window_ms_per_step("particle_life_large", cap)


def _window_ms_per_step(preset, cap=None):
    """All-in ms/step of a mask-free STEPS-step simulate_dense window."""
    from particle3d_tpu_torch.engine.step import simulate_dense
    from particle3d_tpu_torch.models import make_scene

    st, cfg, dt = make_scene(preset, seed=0, device=DEVICE)
    if cap is not None:
        cfg = cfg.replace(cell_capacity=cap)
    out, (mov, mis) = simulate_dense(st, cfg, dt, STEPS)
    sync()
    log(f"  {preset} cap {cfg.cell_capacity}: max_movers={int(mov)} "
        f"max_masked={int(mis)}")
    if int(mis) != 0 or not bool(torch.isfinite(out.positions).all()):
        raise AssertionError(f"{preset} window not exact or not finite")
    ms, _ = timed_ms(lambda: simulate_dense(st, cfg, dt, STEPS)[0], 1)
    log(f"  {ms / STEPS:.3f} ms/step ({STEPS}-step window at cap "
        f"{cfg.cell_capacity}, incl. layout build and write-back, CUDA events)")
    return ms / STEPS


def phase_1m():
    log(f"[6] simulate_dense, {STEPS} steps, N=1,048,576 (grid 40, cap 32)")
    return _window_ms_per_step("particle_life_1m")


def _sample(n, k, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:k].to(DEVICE)


def _law_scenes(n, gen):
    """(label, state, cfg) of particle life, Lennard-Jones, gravity (random
    masses) and spring at N=n in a periodic box of side 0.5 * ceil(n^(1/3))
    (world 16 at N=32,768; at least 4), Lennard-Jones on a jittered lattice
    of spacing 0.5: uniform points would put near-coincident pairs under
    its core."""
    from particle3d_tpu_torch.config import reference_config
    from particle3d_tpu_torch.state import init_scene

    side = round(n ** (1 / 3))
    while side ** 3 < n:
        side += 1
    w = max(4.0, 0.5 * side)  # particle life's radius 2 needs w >= 4
    base = reference_config(world_size=w)
    cfgs = {
        "particle_life": base,
        "lennard_jones": base.replace(force_law="lennard_jones",
                                      particle_effect_radius=0.5,
                                      lj_sigma=0.1, lj_epsilon=0.5),
        "gravity": base.replace(force_law="gravity", particle_effect_radius=1.0,
                                gravity_softening=0.05),
        "spring": base.replace(force_law="spring", particle_effect_radius=0.75),
    }
    lin = (torch.arange(side) + 0.5) * 0.5 - w / 2
    lattice = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    lattice = lattice.reshape(-1, 3)[:n] + 0.05 * torch.randn(n, 3, generator=gen)
    out = []
    for law, c in cfgs.items():
        st = init_scene(gen, n, c, DEVICE)
        st = st.replace(masses=0.5 + torch.rand(n, generator=gen).to(DEVICE))
        if law == "lennard_jones":
            st = st.replace(positions=lattice.to(DEVICE))
        out.append((law, st, c))
    return out


def _wide_scene(n, gen):
    """Particle life with 12 species: 12 feature columns, padded to 16."""
    from particle3d_tpu_torch.config import SimConfig
    from particle3d_tpu_torch.state import init_scene

    side = round(n ** (1 / 3)) + 1
    m = (torch.rand(12, 12, generator=gen) * 2 - 1).numpy()
    cfg = SimConfig(id_count=12, world_size=max(4.0, 0.5 * side),
                    attraction_matrix=m).validate()
    return "particle_life, 12 species", init_scene(gen, n, cfg, DEVICE), cfg


def phase_rect():
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F

    log(f"[7] K3 against its plain version ({N_SAMPLE} receivers x {N_LARGE} "
        f"sources, then same-set at N={N_RECT})")
    st, cfg, _ = make_scene("particle_life_large_allpairs", seed=0, n=N_LARGE,
                            device=DEVICE)
    u, v = F.pair_features(st, cfg)
    idx = _sample(N_LARGE, N_SAMPLE, 3)
    ops = A.rect_operands(st.positions[idx], u[idx], st.positions, v, cfg)
    ms, got = timed_ms(lambda: A.rect_sweep(*ops), 10)
    plain_ms, want = timed_ms(lambda: A.rect_sweep_ref(*ops), 2)
    b = bound(N_SAMPLE * N_LARGE, ops_one_sided(u.shape[1], True),
              nbytes(*ops[:5], got))
    log(f"  K3 {ms:.3f} ms, plain {plain_ms:.3f} ms, {bound_text(b)}")
    err = compare(f"K3 {N_SAMPLE} x {N_LARGE}", got, want)
    gen = torch.Generator().manual_seed(4)
    scenes = [(n, *x) for n in (N_RECT,) for x in _law_scenes(n, gen)]
    scenes += [(N_RECT, *_wide_scene(N_RECT, gen)),
               (N_RAGGED_RECT, *_law_scenes(N_RAGGED_RECT, gen)[0])]
    for n, label, s, c in scenes:
        su, sv = F.pair_features(s, c)
        o = A.rect_operands(s.positions, su, s.positions, sv, c)
        compare(f"K3 {label} (N={n}, P={o[1].shape[1]})",
                A.rect_sweep(*o), A.rect_sweep_ref(*o))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": b,
            "shape": f"{N_SAMPLE} receivers x {N_LARGE} sources"}


def _tri_pair(st, cfg, mask=None):
    """K2 and its plain version on the same operands: (forces, plain
    forces)."""
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F

    u, v = F.pair_features(st, cfg)
    ops = A.tri_operands(st.positions, u, v, cfg, A.KERNEL_TILE)
    args = (cfg.force_law, bool(cfg.wrap_forces), A.KERNEL_TILE)
    n = st.n
    got = A.tri_forces(*A.tri_sweep(*ops, *args, mask=mask))[:n]
    want = A.tri_forces(*A.tri_sweep_ref(*ops, *args, mask=mask))[:n]
    return got, want


def _morton_sorted(st, cfg):
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.state import ParticleState

    order = torch.argsort(A.morton_keys(st.positions, cfg.world_size),
                          stable=True)
    return ParticleState(*(getattr(st, f)[order]
                           for f in ParticleState.__dataclass_fields__))


def _padded_origin_scene():
    """N=300 under Lennard-Jones (sigma 0.1, epsilon 0.5, cutoff 0.5) in a
    periodic box of 10: one particle at (1e-4, 0, 0) in tile 0, 299 on a
    lattice at least 0.35 from it, and 84 padded rows at the origin in the
    last of three tiles of 128. A padded row and that particle have an
    infinite pair scale, which K2's and K4's j-side must select away."""
    from particle3d_tpu_torch.config import SimConfig
    from particle3d_tpu_torch.state import from_numpy

    cfg = SimConfig(force_law="lennard_jones", lj_sigma=0.1, lj_epsilon=0.5,
                    particle_effect_radius=0.5, world_size=10.0,
                    wrap_forces=True).validate()
    lin = (torch.arange(7) - 3) * 0.45 + 0.2
    g = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    gen = torch.Generator().manual_seed(12)
    pos = torch.cat([torch.tensor([[1e-4, 0.0, 0.0]]), g.reshape(-1, 3)[:299]
                     + 0.01 * torch.randn(299, 3, generator=gen)])
    st = from_numpy(pos.numpy(), torch.zeros(300, 3).numpy(),
                    torch.zeros(300, dtype=torch.int32).numpy(), device=DEVICE)
    return st, cfg


def phase_tri():
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F

    log(f"[8] K2 against its plain version (N={N_SMALL} and N={N_LARGE})")
    gen = torch.Generator().manual_seed(5)
    scenes = _law_scenes(N_SMALL, gen)
    pl_st, pl_cfg = scenes[0][1], scenes[0][2]
    scenes.insert(1, ("particle_life walled", pl_st,
                      pl_cfg.replace(boundary="clamp", wrap_forces=False)))
    for label, s, c in scenes:
        compare(f"K2 {label} (N={N_SMALL})", *_tri_pair(s, c))
    ragged = _law_scenes(N_RAGGED, gen)[0]
    compare(f"K2 particle_life (N={N_RAGGED}, "
            f"{-(-N_RAGGED // A.KERNEL_TILE)} tiles)",
            *_tri_pair(ragged[1], ragged[2]))

    st, cfg, _ = make_scene("particle_life_large_allpairs", seed=0, n=N_LARGE,
                            device=DEVICE)
    u, v = F.pair_features(st, cfg)
    ops = A.tri_operands(st.positions, u, v, cfg, A.KERNEL_TILE)
    args = (cfg.force_law, True, A.KERNEL_TILE)
    ms, (oa, ob) = timed_ms(lambda: A.tri_sweep(*ops, *args), 3)
    got = A.tri_forces(oa, ob)
    b = bound(N_LARGE * (N_LARGE - 1) / 2, ops_two_sided(u.shape[1], True),
              nbytes(*ops[:5], oa, ob))
    oa2, ob2 = A.tri_sweep(*ops, *args)
    _bit_identical(f"K2 N={N_LARGE} rerun", (oa, ob), (oa2, ob2))
    del oa, ob, oa2, ob2
    plain_ms, (pa, pb) = timed_ms(lambda: A.tri_sweep_ref(*ops, *args), 1,
                                  warm=False)
    want = A.tri_forces(pa, pb)
    del pa, pb
    log(f"  K2 {ms:.3f} ms, plain {plain_ms:.3f} ms, {bound_text(b)}; out_b "
        f"{ops[0].shape[0] // A.KERNEL_TILE // 2 + 1} x 3 x "
        f"{ops[0].shape[0]} floats")
    err = compare(f"K2 N={N_LARGE}", got, want)
    idx = _sample(N_LARGE, N_SAMPLE, 6)
    rect = A.rect_sweep_ref(*A.rect_operands(st.positions[idx], u[idx],
                                             st.positions, v, cfg))
    compare(f"K2 N={N_LARGE} on {N_SAMPLE} receivers vs plain rectangular",
            got[idx], rect)
    del got, want

    # mask mode: a clustered scene, Morton-sorted, against dense K2
    c = scenes[0][2]
    blob = scenes[0][1]
    pos = blob.positions.clone()
    half = N_SMALL // 2
    pos[:half] = pos[:half] * 0.2 + 3.0
    s = _morton_sorted(blob.replace(positions=pos), c)
    su, sv = F.pair_features(s, c)
    o = A.tri_operands(s.positions, su, sv, c, A.KERNEL_TILE)
    mask, frac = A.culled_tile_mask(A._pad_rows(s.positions, o[0].shape[0]),
                                    N_SMALL, A.KERNEL_TILE, c)
    frac = float(frac)
    if not frac < 1.0:
        raise AssertionError(f"mask mode culled nothing (fraction {frac})")
    a2 = (c.force_law, True, A.KERNEL_TILE)
    masked = A.tri_forces(*A.tri_sweep(*o, *a2, mask=mask))
    compare(f"K2 mask mode (surviving fraction {frac:.3f}) vs dense K2",
            masked, A.tri_forces(*A.tri_sweep(*o, *a2)))
    compare("K2 mask mode vs its plain version", masked,
            A.tri_forces(*A.tri_sweep_ref(*o, *a2, mask=mask)))

    from particle3d_tpu_torch.ops.allpairs import allpairs_forces

    ps, pc = _padded_origin_scene()
    pu, pv = F.pair_features(ps, pc)
    got, want = _tri_pair(ps, pc)
    compare("K2 padded rows at the origin, a particle 1e-4 away (N=300, "
            "Lennard-Jones) vs plain all-pairs", got,
            allpairs_forces(ps.positions, pu, pv, pc))
    compare("K2 padded rows at the origin vs its plain version", got, want)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": b,
            "shape": f"N={N_LARGE}, same set"}


def _worklist_operands(st, cfg):
    """K4's arguments for a Morton-sorted state, and the worklist size."""
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F

    t = A.KERNEL_TILE
    u, v = F.pair_features(st, cfg)
    ops = A.tri_operands(st.positions, u, v, cfg, t)
    np_ = ops[0].shape[0]
    mask = A.pair_survival_mask(A._pad_rows(st.positions, np_), st.n, t,
                                np_ // t, cfg)
    wp, count = A.build_pair_worklist(mask, np_ // t)
    wi, wj = A.unpack_worklist(wp)
    return (*ops[:5], wi, wj, ops[5], cfg.force_law, bool(cfg.wrap_forces),
            t), count


def phase_pairlist():
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F

    log(f"[9] K4 against its plain version (N={N_SMALL}), and against dense "
        f"K2 at N={N_LARGE}")
    gen = torch.Generator().manual_seed(7)
    small = _law_scenes(N_SMALL, gen)
    _, pl_st, pl_cfg = small[0]
    scenes = [(N_SMALL, *small[0]),
              (N_SMALL, "particle_life walled", pl_st,
               pl_cfg.replace(boundary="clamp", wrap_forces=False)),
              (N_SMALL, *small[1]),
              (N_RAGGED, *_law_scenes(N_RAGGED, gen)[0])]
    for n, label, s, c in scenes:
        args, count = _worklist_operands(_morton_sorted(s, c), c)
        wj = args[6]
        compare(f"K4 {label} (N={n}, {count} tile pairs)",
                A.pairlist_forces(*A.pairlist_sweep(*args), wj)[:n],
                A.pairlist_forces(*A.pairlist_sweep_ref(*args), wj)[:n])

    st, cfg, _ = make_scene("particle_life_large", seed=0, n=N_LARGE,
                            device=DEVICE)
    st = _morton_sorted(st, cfg)
    args, count = _worklist_operands(st, cfg)
    wj = args[6]
    ms, (oa, ob) = timed_ms(lambda: A.pairlist_sweep(*args), 5)
    got = A.pairlist_forces(oa, ob, wj)
    t = A.KERNEL_TILE
    u, v = F.pair_features(st, cfg)
    nt = N_LARGE // t  # one self entry per tile: t (t - 1) / 2 pairs each
    pairs = (count - nt) * t * t + nt * t * (t - 1) / 2
    b = bound(pairs, ops_two_sided(u.shape[1], True),
              nbytes(*args[:7], oa, ob))
    plain_ms, (pa, pb) = timed_ms(lambda: A.pairlist_sweep_ref(*args), 1)
    runs = A.worklist_row_start(args[5], nt).diff()
    splits = A.pairlist_splits(count, nt)
    log(f"  K4 {ms:.3f} ms over {count} tile pairs (of "
        f"{(N_LARGE // t) * (N_LARGE // t + 1) // 2}), plain {plain_ms:.3f} "
        f"ms, {bound_text(b)}")
    share = -(-runs // splits)
    busy = int((-(-runs // share.clamp(min=1))).sum())
    log(f"  worklist runs a receiver tile: mean {count / nt:.2f}, longest "
        f"{int(runs.max())}; S = {splits} shares a run, {nt * splits} blocks "
        f"launched, {busy} with entries, at most {int(share.max())} entries "
        f"a block")
    err = compare(f"K4 N={N_LARGE} vs its plain version", got,
                  A.pairlist_forces(pa, pb, wj))
    del pa, pb
    compare(f"K4 N={N_LARGE} (step-0 forces of the culled rung) vs dense K2",
            got, A.pallas_allpairs_forces_tri(st.positions, u, v, cfg))
    del got, oa, ob

    from particle3d_tpu_torch.ops.allpairs import allpairs_forces

    # the lower-triangular worklist, so that the padded tile is a receiver
    ps, pc = _padded_origin_scene()
    pu, pv = F.pair_features(ps, pc)
    ops = A.tri_operands(ps.positions, pu, pv, pc, t)
    pnt = ops[0].shape[0] // t
    wi, wj = (torch.tensor(x, dtype=torch.int32, device=DEVICE) for x in
              zip(*[(i, j) for i in range(pnt) for j in range(i + 1)]))
    pargs = (*ops[:5], wi, wj, ops[5], pc.force_law, True, t)
    pg = A.pairlist_forces(*A.pairlist_sweep(*pargs), wj)[:ps.n]
    compare("K4 padded rows at the origin, lower-triangular worklist (N=300, "
            "Lennard-Jones) vs plain all-pairs", pg,
            allpairs_forces(ps.positions, pu, pv, pc))
    compare("K4 padded rows at the origin vs its plain version", pg,
            A.pairlist_forces(*A.pairlist_sweep_ref(*pargs), wj)[:ps.n])
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": b,
            "shape": f"N={N_LARGE}, {count} surviving tile pairs of {t}"}


def _bit_identical(label, first, second):
    """Fail unless two runs on the same operands gave the same bits."""
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label}: not bit-identical")
    log(f"  {label}: bit-identical")


def _finite(label, state):
    for name in ("positions", "velocities"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{label}: non-finite {name}")


def _nonzero(launches):
    return {k: c for k, c in launches.items() if c}


def _expect(label, launches, want):
    """Fail unless the path launched exactly the kernels in ``want``."""
    got = _nonzero(launches)
    log(f"  {label}: launches {got}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def phase_allpairs_paths():
    from particle3d_tpu_torch.__main__ import main as cli
    from particle3d_tpu_torch.engine.step import (simulate, simulate_culled,
                                                  step, warmup)
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches

    log("[10] all-pairs paths")
    launches = {}
    log(f"  python -m particle3d_tpu_torch run --preset "
        f"particle_life_large_allpairs --steps 4 (N={N_LARGE})")
    sync()
    reset_kernel_launches()
    rec = cli(["run", "--preset", "particle_life_large_allpairs", "--steps",
               "4", "--device", DEVICE])
    by = rec["kernel_launches_by_kernel"]
    _expect("run particle_life_large_allpairs", by, {"allpairs_tri": 4})
    launches["allpairs_tri"] = by["allpairs_tri"]
    stats = [rec["kinetic_energy"], rec["max_speed"], *rec["momentum"]]
    if rec["n"] != N_LARGE or not all(math.isfinite(x) for x in stats):
        raise AssertionError(f"run record not finite: {rec}")
    log(f"  {rec['wall_s'] / 4 * 1e3:.3f} ms/step (host clock, 4 steps)")

    st, cfg, dt = make_scene("particle_life_large_allpairs", seed=0,
                             n=N_LARGE, device=DEVICE)
    ms, a = timed_ms(lambda: simulate(st, cfg, dt, 2), 1, warm=False)
    again = simulate(st, cfg, dt, 2)
    _finite("simulate allpairs_pallas", a)
    if not (torch.equal(a.positions, again.positions)
            and torch.equal(a.velocities, again.velocities)):
        raise AssertionError("simulate(allpairs_pallas): rerun not bit-identical")
    log(f"  simulate(allpairs_pallas) N={N_LARGE}: {ms / 2:.3f} ms/step "
        f"(CUDA events), rerun bit-identical")

    st, cfg, dt = make_scene("reference", seed=0, n=N_FLAGSHIP, device=DEVICE)
    cfg = cfg.replace(neighbor="allpairs_pallas")
    reset_kernel_launches()
    out = step(st, cfg, dt)
    sync()
    _expect(f"flagship step (reference, N={N_FLAGSHIP})", kernel_launches(),
            {"allpairs_tri": 1})
    ref = step(st, cfg.replace(neighbor="allpairs"), dt)
    compare("flagship step velocities vs plain all-pairs", out.velocities,
            ref.velocities)
    ms, _ = timed_ms(lambda: step(st, cfg, dt), 20)
    log(f"  flagship step: {ms:.3f} ms/step (CUDA events, mean of 20)")

    st, cfg, dt = make_scene("particle_life_large", seed=0, n=N_RECT,
                             device=DEVICE)
    reset_kernel_launches()
    out = simulate(st, cfg, dt, 4)
    sync()
    _expect(f"particle_life_large N={N_RECT}, 4 steps", kernel_launches(),
            {"allpairs_rect": 4})
    launches["allpairs_rect"] = kernel_launches()["allpairs_rect"]
    _finite("particle_life_large small", out)

    for preset, steps in (("verlet_elastic", 4), ("gravity_nbody", 4)):
        st, cfg, dt = make_scene(preset, seed=0, device=DEVICE)
        reset_kernel_launches()
        ms, out = timed_ms(lambda: simulate(warmup(st, cfg), cfg, dt, steps),
                           1, warm=False)
        _expect(f"{preset} N={st.n}, warm-up + {steps} steps",
                kernel_launches(), {"allpairs_tri": steps + 1})
        _finite(preset, out)
        log(f"  {preset}: {ms / steps:.3f} ms/step (CUDA events)")

    st, cfg, dt = make_scene("particle_life_large", seed=0, device=DEVICE)
    culled = cfg.replace(neighbor="allpairs_culled")
    sync()
    reset_kernel_launches()
    ms, out = timed_ms(lambda: simulate(st, culled, dt, 2), 1, warm=False)
    _expect(f"simulate(allpairs_culled) N={st.n}, 2 steps", kernel_launches(),
            {"allpairs_tri": 2})
    _finite("simulate allpairs_culled", out)
    log(f"  simulate(allpairs_culled) (K2 in mask mode): {ms / 2:.3f} ms/step "
        f"(CUDA events, 2 steps incl. the Morton sort and the mask)")
    sync()
    reset_kernel_launches()
    out, stats = simulate_culled(st, cfg, dt, STEPS)
    sync()
    _expect(f"simulate_culled N={st.n}, {STEPS} steps", kernel_launches(),
            {"allpairs_pairlist": STEPS})
    launches["allpairs_pairlist"] = kernel_launches()["allpairs_pairlist"]
    _finite("simulate_culled", out)
    log(f"  stats: {stats}")
    ms, again = timed_ms(lambda: simulate_culled(st, cfg, dt, STEPS)[0], 1,
                         warm=False)
    if not (torch.equal(again.positions, out.positions)
            and torch.equal(again.velocities, out.velocities)):
        raise AssertionError("simulate_culled: rerun not bit-identical")
    log(f"  simulate_culled: {ms / STEPS:.3f} ms/step ({STEPS} steps incl. "
        f"the Morton sort, CUDA events), rerun bit-identical")
    return launches


def _blob_scene():
    """particle_life_large at N=262,144 with N_BLOB particles packed into
    one cell: denser than any capacity up to 64."""
    from particle3d_tpu_torch.models import make_scene

    st, cfg, dt = make_scene("particle_life_large", seed=0, device=DEVICE)
    gen = torch.Generator().manual_seed(8)
    pos = st.positions.clone()
    w = float(cfg.world_size)
    cell = w / cfg.cell_grid
    centre = -w / 2 + (cfg.cell_grid // 2 + 0.5) * cell
    pos[:N_BLOB] = (centre + (torch.rand(N_BLOB, 3, generator=gen) - 0.5)
                    * 0.9 * cell).to(DEVICE)
    return st.replace(positions=pos), cfg, dt


def phase_terminal_rung():
    from particle3d_tpu_torch.engine.step import simulate_dense_adaptive
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches

    log(f"[11] terminal rung: simulate_dense_adaptive N={N_LARGE}, "
        f"{N_BLOB} particles in one cell, ocap 0, max_cap 64")
    st, cfg, dt = _blob_scene()
    sync()
    reset_kernel_launches()
    out, cap, hist = simulate_dense_adaptive(st, cfg, dt, STEPS, chunk=8,
                                             max_cap=64, ocap=0,
                                             verbose=lambda m: log(f"  {m}"))
    sync()
    got = kernel_launches()
    log(f"  history {hist}, cap {cap}, launches "
        f"{ {k: c for k, c in got.items() if c} }")
    if not any(c == "allpairs" for _, c, _ in hist) or any(
            m for _, _, m in hist) or sum(k for k, _, _ in hist) != STEPS:
        raise AssertionError(f"terminal rung not taken or not exact: {hist}")
    if got["allpairs_pairlist"] < 1:
        raise AssertionError("the culled rung did not launch K4")
    _finite("terminal rung", out)


def count_syncs(fn):
    """(fn(), the host synchronisations it made, where they were made),
    counted by PyTorch's sync debug mode (one warning per synchronising
    call, attributed to the Python line that made it)."""
    import collections
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in rec if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                                for w in hits)
    return out, len(hits), dict(where)


def _slab_operands(st, cfg, split=False):
    """K1 halo operands on a 1-rank mesh from ``st`` (None: the carry is
    given instead), with the gate r2 of the receivers. ``split``: the
    interior-split call (receivers without the edge planes, the pack itself
    as sources), or "plane": one receiver plane (the second) against the
    pack's first three planes; else the single call on the extended planes.
    Returns (operands, receiver r2 [ncol, cs], pack, pos_d, u_d,
    geometry)."""
    from particle3d_tpu_torch.ops.celllist_sweep import bin_sid
    from particle3d_tpu_torch.ops.params import r2_gate
    from particle3d_tpu_torch.parallel import build_sharded_dense, make_mesh
    from particle3d_tpu_torch.parallel import domain_sharded as DS

    mesh = make_mesh(1, device=DEVICE)
    carry = st if isinstance(st, tuple) else build_sharded_dense(st, cfg, mesh)
    data, pid = carry[0], carry[1]
    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    g = DS._geometry(cfg, mesh, pid.shape[0], nsc, cap, None, None,
                     carry[3].shape[0])
    cell_of = torch.arange(g.s_loc, device=DEVICE) // cap
    aligned = (pid >= 0) & (bin_sid(data[:, :3], cfg, nsc) == cell_of)
    r2 = torch.where(aligned, float(r2_gate(cfg)), -1.0)
    pos_d, u_d, pack = DS.slab_pack(data[:, :3], data, r2, cfg, g, 0)
    r2c = r2.reshape(g.cols_local, g.cs)
    if split == "plane":
        ops = DS.halo_call_operands(pos_d[nsc:2 * nsc], u_d[nsc:2 * nsc],
                                    pack[:3 * nsc], cfg, cap)
        r2c = r2c[nsc:2 * nsc]
    elif split:
        ops = DS.halo_call_operands(pos_d[nsc:-nsc], u_d[nsc:-nsc], pack, cfg,
                                    cap)
        r2c = r2c[nsc:-nsc]
    else:
        fl, fr = DS.fix_halos(pack[-nsc:], pack[:nsc], cfg, g.d, 0)
        ops = DS.halo_call_operands(pos_d, u_d, torch.cat([fl, pack, fr]),
                                    cfg, cap)
    return ops, r2c, pack, pos_d, u_d, g


def _halo_case(label, st, cfg, split=False, against_full=False):
    """K1 halo against its plain version on one slab layout; optionally
    also against non-halo K1 on the same layout (expected bit-equal)."""
    from particle3d_tpu_torch.ops import celllist_sweep as S
    from particle3d_tpu_torch.ops.params import pack_params

    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    ops, r2c, pack, pos_d, u_d, g = _slab_operands(st, cfg, split)
    args = (pack_params(cfg), cfg.force_law, bool(cfg.wrap_forces), nsc, cap)
    got = S.column_sweep_forces(*ops, *args, halo=True)
    want = S.column_sweep_forces_ref(*ops, *args, halo=True)
    live = r2c > 0
    pick = lambda f: f.permute(0, 2, 1)[live]  # noqa: E731
    log(f"  {label}: {ops[0].shape[0]} receiver columns, "
        f"{ops[2].shape[0]} source columns, P={ops[1].shape[1]}")
    compare(label, pick(got), pick(want))
    _dead_rows_zero(label, got, live)
    if against_full:
        p = u_d.shape[-1]
        post_g, vt_g, r2_g = S.ghost_columns(pos_d, pack[..., 3:3 + p],
                                             pack[..., 3 + p], cfg, cap)
        full = S.column_sweep_forces(ops[0], ops[1], post_g, vt_g, r2_g, *args)
        a, b = pick(got), pick(full)
        same = torch.equal(a, b)
        log(f"  {label}: halo K1 vs non-halo K1 on the same layout: "
            f"{'bit-identical' if same else 'max |diff| %.3e' % (a - b).abs().max().item()}")
        compare(f"{label} vs non-halo K1", a, b)


def _wide_cfg(cfg, gen, species=12):
    """``cfg`` with ``species`` species and a random attraction matrix:
    feature width 16 after padding."""
    m = (torch.rand(species, species, generator=gen) * 2 - 1).numpy()
    return cfg.replace(id_count=species, attraction_matrix=m, colors=None)


def phase_halo():
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.state import init_scene

    log(f"[12] K1 halo mode against its plain version (N={N_LARGE}, grid 24, "
        f"cap 32, one rank)")
    st, cfg, _ = make_scene("particle_life_large", seed=0, n=N_LARGE,
                            device=DEVICE)
    walled = cfg.replace(boundary="clamp", wrap_forces=False)
    for label, c in (("periodic", cfg), ("walled", walled)):
        _halo_case(f"halo {label}, extended operands", st, c,
                   against_full=True)
        _halo_case(f"halo {label}, interior-split call", st, c, split=True)
        _halo_case(f"halo {label}, one-plane call", st, c, split="plane")
    gen = torch.Generator().manual_seed(9)
    wide = _wide_cfg(cfg, gen).validate()
    wst = init_scene(gen, N_LARGE, wide, DEVICE)
    _halo_case("halo periodic, P=16 (12 species)", wst, wide,
               against_full=True)
    _halo_case("halo walled, P=16 interior-split", wst,
               wide.replace(boundary="clamp", wrap_forces=False), split=True)
    _sweep_case("K1 (non-halo) P=16 (12 species)", wst, wide, reps=3)


def _rel_pos(got, want):
    scale = max(1.0, want.positions.abs().max().item())
    return (got.positions - want.positions).abs().max().item() / scale


def phase_slab_gates():
    from particle3d_tpu_torch.engine.step import simulate, simulate_dense
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.parallel import (
        build_sharded_dense, gather_sharded_dense, make_mesh, shard_state,
        sharded_dense_simulate, sharded_exact_steps, sharded_simulate)

    log("[13] 1-rank slab gates")
    mesh = make_mesh(1, device=DEVICE)
    st, cfg, dt = make_scene("particle_life_large", seed=0, n=N_LARGE,
                             device=DEVICE)
    launches = 0
    for label, c in (("periodic", cfg),
                     ("walled", cfg.replace(boundary="clamp",
                                            wrap_forces=False))):
        sync()
        reset_kernel_launches()
        out, (mov, mask, limbo, lost, _) = sharded_dense_simulate(
            st, c, dt, 4, mesh)
        sync()
        k = kernel_launches()
        ref, (_, mis) = simulate_dense(st, c, dt, 4)
        rel = _rel_pos(out, ref)
        log(f"  sharded_dense_simulate {label} vs simulate_dense, 4 steps: "
            f"max_movers {int(mov)} masked {int(mask)} limbo {int(limbo)} "
            f"lost {int(lost)} (dense masked {int(mis)}), "
            f"max|dpos|/scale {rel:.3e}, K1 halo launches {k['celllist_halo']}")
        if int(mask) or int(limbo) or int(lost) or int(mis) or not rel < 5e-5:
            raise AssertionError(f"slab gate {label} failed")
        if k["celllist_halo"] != 4:
            raise AssertionError(f"K1 halo launched {k['celllist_halo']} "
                                 f"times in 4 one-rank steps")
        launches += k["celllist_halo"]

    fst, fcfg, fdt = make_scene("reference", seed=0, n=N_FLAGSHIP,
                                device=DEVICE)
    fcfg = fcfg.replace(neighbor="allpairs_pallas")
    ref = simulate(fst, fcfg, fdt, 2)
    sync()
    reset_kernel_launches()
    out = sharded_simulate(shard_state(fst, mesh), fcfg, fdt, 2, mesh)
    sync()
    k = kernel_launches()
    rel = _rel_pos(out, ref)
    log(f"  sharded_simulate vs simulate (allpairs_pallas, N={N_FLAGSHIP}, "
        f"2 steps): max|dpos|/scale {rel:.3e}, K3 launches "
        f"{k['allpairs_rect']}")
    if k["allpairs_rect"] != 2 or not rel < 5e-5:
        raise AssertionError("ring gate failed")

    xst, xcfg, xdt = make_scene("particle_life_large", seed=1, n=N_SMALL,
                                device=DEVICE)
    carry = build_sharded_dense(xst, xcfg, mesh)
    carry, ovf = sharded_exact_steps(carry, xcfg, xdt, 2, mesh, rcap=N_SMALL)
    out = gather_sharded_dense(carry, xst, mesh)
    ref = simulate(xst, xcfg.replace(neighbor="allpairs_pallas"), xdt, 2)
    rel = _rel_pos(out, ref)
    log(f"  sharded_exact_steps (rcap {N_SMALL}) vs simulate(allpairs_pallas), "
        f"2 steps: overflow {int(ovf)}, max|dpos|/scale {rel:.3e}")
    if int(ovf) or not rel < 5e-5:
        raise AssertionError("exact-rung gate failed")
    return launches


def _slab_run(name, kernel_row=False):
    """One SLAB_RUNS configuration, stay-sharded on one rank: init, a warm
    window and a timed window of SLAB_STEPS steps; returns the K1 halo
    kernel record at its shape when ``kernel_row``."""
    from particle3d_tpu_torch.models.presets import slab_run
    from particle3d_tpu_torch.ops import celllist_sweep as S
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.ops.params import pack_params
    from particle3d_tpu_torch.parallel import (init_sharded_dense, make_mesh,
                                               sharded_dense_steps)

    n, cfg, dt, kw = slab_run(name)
    mesh = make_mesh(1, device=DEVICE)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry = init_sharded_dense(5, n, cfg, mesh, nsc=kw["nsc"], cap=kw["cap"],
                               migcap=kw["migcap"])
    sync()
    t_init = time.perf_counter() - t0
    live = int((carry[1] >= 0).sum()) + int((carry[3] >= 0).sum())
    carry_bytes = nbytes(*carry[:4])
    log(f"  {name}: N={n}, grid {kw['nsc']}, cap {kw['cap']}, ocap "
        f"{kw['ocap']}: init {t_init:.2f} s, {live} rows live (lost "
        f"{int(carry[4])}), carry {carry_bytes / 1e9:.3f} GB")
    if live + int(carry[4]) != n or int(carry[4]):
        raise AssertionError(f"{name}: init placed {live} of {n} rows")
    steps = dict(kw, n=n)
    t0 = time.perf_counter()
    carry, d = sharded_dense_steps(carry, cfg, dt, SLAB_STEPS, mesh, **steps)
    sync()
    warm_s = time.perf_counter() - t0
    # one step from the warm carry, counted and thrown away (the step
    # functions never write their inputs): the timed window starts from
    # the same carry, so the run is the JAX bench's 20 steps
    _, syncs, where = count_syncs(
        lambda: sharded_dense_steps(carry, cfg, dt, 1, mesh, **steps))
    sync()
    reset_kernel_launches()
    t0 = time.perf_counter()
    carry, (mov, mask, limbo, lost, _) = sharded_dense_steps(
        carry, cfg, dt, SLAB_STEPS, mesh, **steps)
    sync()
    ms = (time.perf_counter() - t0) / SLAB_STEPS * 1e3
    halo_launches = kernel_launches()["celllist_halo"]
    peak = torch.cuda.max_memory_allocated()
    log(f"  {name}: warm window {warm_s / SLAB_STEPS * 1e3:.1f} ms/step; timed "
        f"{SLAB_STEPS} steps {ms:.3f} ms/step (host clock, synchronised), "
        f"max_movers {int(mov)} masked {int(mask)} limbo {int(limbo)} lost "
        f"{int(lost)}; K1 halo launches {halo_launches}; peak device memory "
        f"{peak / 1e9:.3f} GB; host syncs in one step {syncs} {where}")
    trouble = int(mask) + int(limbo) + int(d[1]) + int(d[2])
    if trouble or int(lost) or int(d[3]) or int(carry[4]):
        raise AssertionError(f"{name}: masked/limbo {trouble}, lost "
                             f"{int(lost)}")
    if halo_launches != SLAB_STEPS:
        raise AssertionError(f"{name}: K1 halo launched {halo_launches} "
                             f"times in {SLAB_STEPS} steps")
    occ = carry[1] >= 0
    if not bool(torch.isfinite(carry[0][occ][:, :6]).all()):
        raise AssertionError(f"{name}: non-finite rows")
    rec = {"ms_per_step": ms, "launches": halo_launches, "syncs": syncs}
    ops, r2c, *_ = _slab_operands(carry, cfg)
    args = (pack_params(cfg), cfg.force_law, True, kw["nsc"], kw["cap"])
    k_ms, got = timed_ms(lambda: S.column_sweep_forces(*ops, *args, halo=True),
                         3)
    log(f"  {name}: K1 halo {k_ms:.3f} ms per launch ({ops[0].shape[0]} "
        f"receiver columns, CUDA events)")
    if kernel_row:
        plain_ms, want = timed_ms(
            lambda: S.column_sweep_forces_ref(*ops, *args, halo=True), 1,
            warm=False)
        live = r2c > 0
        pick = lambda f: f.permute(0, 2, 1)[live]  # noqa: E731
        err = compare(f"K1 halo at {name}", pick(got), pick(want))
        _dead_rows_zero(f"K1 halo at {name}", got, live)
        log(f"  K1 halo at {name}: idle-lane share of K1's sweep loop "
            f"(model from the occupancy and the launch geometry) "
            f"{k1_idle_lane_share(live, kw['nsc'], kw['cap']):.4f}")
        del want
        # particle life's unpadded features: one column per species
        b = bound(k1_pairs(r2c.reshape(-1), kw["nsc"], kw["cap"]),
                  ops_one_sided(int(cfg.id_count), False), nbytes(*ops, got))
        log(f"  K1 halo {k_ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"{bound_text(b)}")
        rec.update(max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound=b,
                   shape=f"N={n}, grid {kw['nsc']}, cap {kw['cap']}, one rank "
                         f"({ops[0].shape[0]} receiver columns)")
    del carry, ops, got
    torch.cuda.empty_cache()
    return rec


def phase_slab_full():
    log(f"[14] full width, stay-sharded on one rank ({SLAB_STEPS} warm + "
        f"{SLAB_STEPS} timed steps)")
    rec8 = _slab_run("slab_8m", kernel_row=True)
    _slab_run("slab_2m")
    return rec8


def _mxu_pair(st, cfg, fast=False):
    """K5 and its plain version on the same operands: (forces, plain
    forces), after holding the ghost count to its capacity."""
    from particle3d_tpu_torch.ops import allpairs_mxu_sweep as M
    from particle3d_tpu_torch.ops import forces as F

    gcap = _check_ghosts("", st, cfg)
    u, v = F.pair_features(st, cfg)
    ops = M.mxu_operands(st.positions, u, v, cfg, gcap, M.KERNEL_TILE)
    args = (cfg.force_law, fast, M.KERNEL_TILE)
    n = st.n
    got = M.tri_forces(*M.mxu_sweep(*ops, *args))[:n]
    want = M.tri_forces(*M.mxu_sweep_ref(*ops, *args))[:n]
    return got, want


def _check_ghosts(label, st, cfg):
    """The recommended ghost capacity, after failing unless the frame's
    ghost count fits it (beyond it wrap interactions would be dropped)."""
    from particle3d_tpu_torch.ops import allpairs_mxu_sweep as M

    if not cfg.wrap_forces:
        return None
    gcap = M.recommended_ghost_capacity(cfg, st.n)
    count = int(M.ghost_count(st.positions, cfg))
    if label:
        log(f"  {label}: ghost_count {count} <= capacity {gcap}")
    if count > gcap:
        raise AssertionError(f"ghost count {count} exceeds capacity {gcap}")
    return gcap


def phase_mxu():
    from particle3d_tpu_torch.config import reference_config
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import allpairs_mxu_sweep as M
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F
    from particle3d_tpu_torch.ops.allpairs import allpairs_forces
    from particle3d_tpu_torch.state import init_scene

    log(f"[15] K5 against its plain version (N={N_SMALL} and N={N_LARGE} "
        f"with ghost images)")
    k5 = dict(rel_l2_tol=K5_REL_L2)
    fast = dict(rel_l2_tol=None, max_abs_tol=FAST_MAX_ABS)
    gen = torch.Generator().manual_seed(10)
    scenes = _law_scenes(N_SMALL, gen)
    pl_st, pl_cfg = scenes[0][1], scenes[0][2]
    scenes.insert(1, ("particle_life walled", pl_st,
                      pl_cfg.replace(boundary="clamp", wrap_forces=False)))
    for label, s, c in scenes:
        compare(f"K5 {label} (N={N_SMALL})", *_mxu_pair(s, c), **k5)
    ragged = _law_scenes(N_RAGGED, gen)[0]
    compare(f"K5 particle_life (N={N_RAGGED}, ragged last tile)",
            *_mxu_pair(ragged[1], ragged[2]), **k5)
    label, s, c = _wide_scene(N_RAGGED, gen)
    compare(f"K5 {label} (N={N_RAGGED}, P=16)", *_mxu_pair(s, c), **k5)

    # fast mode: the JAX test's scenes and bound; at N=32,768 in a world of
    # 20 the closest pair comes within ~0.01, where the Gram-form d^2 is
    # mostly noise, so the max abs error is printed and the relative L2
    # error gated at the JAX module's stated accuracy
    wide = dict(rel_l2_tol=FAST_REL_L2, max_abs_tol=float("inf"))
    for label, c, n, tol in (
            ("periodic", reference_config(), 200, fast),
            ("walled", reference_config().replace(boundary="clamp",
                                                  wrap_forces=False), 200,
             fast),
            ("periodic, world 20", reference_config(world_size=20.0),
             N_SMALL, wide)):
        s = init_scene(gen, n, c, DEVICE)
        u, v = F.pair_features(s, c)
        got, want = _mxu_pair(s, c, fast=True)
        direct = (allpairs_forces(s.positions, u, v, c) if n < A.TRI_MIN_N
                  else A.pallas_allpairs_forces_tri(s.positions, u, v, c))
        compare(f"K5 fast {label} (N={n}) vs a direct sweep", got, direct,
                **tol)
        compare(f"K5 fast {label} (N={n}) vs its plain version", got, want,
                **tol)

    st, cfg, _ = make_scene("particle_life_large_allpairs", seed=0, n=N_LARGE,
                            device=DEVICE)
    gcap = _check_ghosts(f"N={N_LARGE}", st, cfg)
    u, v = F.pair_features(st, cfg)
    ops = M.mxu_operands(st.positions, u, v, cfg, gcap, M.KERNEL_TILE)
    args = (cfg.force_law, False, M.KERNEL_TILE)
    mp = ops[0].shape[0]
    # the live rows: reals and the ghosts in use (the rest are dead tiles'
    # or invalid rows' parked pairs)
    m = N_LARGE + int(M.ghost_count(st.positions, cfg))
    ms, (oa, ob) = timed_ms(lambda: M.mxu_sweep(*ops, *args), 3)
    got = M.tri_forces(oa, ob)[:N_LARGE]
    p = u.shape[1]
    b = bound(m * (m - 1) / 2, ops_mxu(p, False), nbytes(*ops[:5], oa, ob))
    b_k2 = bound(N_LARGE * (N_LARGE - 1) / 2, ops_two_sided(p, True), 0)
    oa2, ob2 = M.mxu_sweep(*ops, *args)
    _bit_identical(f"K5 N={N_LARGE} + ghosts rerun", (oa, ob), (oa2, ob2))
    del oa, ob, oa2, ob2
    plain_ms, (pa, pb) = timed_ms(lambda: M.mxu_sweep_ref(*ops, *args), 1,
                                  warm=False)
    want = M.tri_forces(pa, pb)[:N_LARGE]
    del pa, pb
    log(f"  K5 {ms:.3f} ms over {mp} rows, {m} live ({mp // M.KERNEL_TILE} "
        f"tiles), plain {plain_ms:.3f} ms, {bound_text(b)}; K2's on the same "
        f"scene {bound_text(b_k2)}; out_b "
        f"{mp // M.KERNEL_TILE // 2 + 1} x 3 x {mp} floats")
    err = compare(f"K5 N={N_LARGE} + {gcap} ghost rows vs its plain version",
                  got, want, **k5)
    del want
    fo = M.tri_forces(*M.mxu_sweep(*ops[:5], ops[5], cfg.force_law, True,
                                   M.KERNEL_TILE))[:N_LARGE]
    compare(f"K5 fast N={N_LARGE} vs exact K5", fo, got, gate=False)
    del got, fo, ops
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": b,
            "shape": f"N={N_LARGE} + {gcap} ghost rows, same set"}


def phase_mxu_path():
    from particle3d_tpu_torch.engine.step import pair_accel, simulate
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches

    log(f"[16] the K5 path: simulate, 4 steps, N={N_LARGE}, "
        f"neighbor=allpairs_mxu")
    st, cfg, dt = make_scene("particle_life_large_allpairs", seed=0,
                             n=N_LARGE, device=DEVICE)
    cfg = cfg.replace(neighbor="allpairs_mxu")
    _check_ghosts("start", st, cfg)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    ms, out = timed_ms(lambda: simulate(st, cfg, dt, 4), 1, warm=False)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    _expect("simulate(allpairs_mxu), 4 steps", launches, {"allpairs_mxu": 4})
    _finite("simulate allpairs_mxu", out)
    _check_ghosts("after 4 steps", out, cfg)
    log(f"  {ms / 4:.3f} ms/step (CUDA events, 4 steps incl. the ghost "
        f"build and the k-sum); peak device memory {peak / 1e9:.3f} GB")
    a, again = simulate(st, cfg, dt, 2), simulate(st, cfg, dt, 2)
    if not (torch.equal(a.positions, again.positions)
            and torch.equal(a.velocities, again.velocities)):
        raise AssertionError("simulate(allpairs_mxu): rerun not bit-identical")
    log("  two steps rerun bit-identical")
    f5 = pair_accel(st.positions, st, cfg)
    f2 = pair_accel(st.positions, st, cfg.replace(neighbor="allpairs_pallas"))
    compare(f"step-0 accelerations, K5 path vs K2 path (N={N_LARGE})", f5, f2,
            rel_l2_tol=K5_REL_L2)
    return launches["allpairs_mxu"], ms / 4


def phase_lj_gas():
    from particle3d_tpu_torch.__main__ import main as cli
    from particle3d_tpu_torch.config import reference_config
    from particle3d_tpu_torch.engine.step import pair_accel, warmup
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import forces as F
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.ops.allpairs import allpairs_forces
    from particle3d_tpu_torch.ops.celllist_sweep import fresh_celllist_forces
    from particle3d_tpu_torch.state import ParticleState

    log(f"[17] python -m particle3d_tpu_torch run --preset lj_gas --steps 16 "
        f"(N={N_LARGE})")
    sync()
    reset_kernel_launches()
    rec = cli(["run", "--preset", "lj_gas", "--steps", "16", "--device",
               DEVICE])
    by = {k: c for k, c in rec["kernel_launches_by_kernel"].items() if c}
    log(f"  history {rec['history']}, launches {by}, "
        f"{rec['wall_s'] / 16 * 1e3:.3f} ms/step (host clock, incl. the "
        f"warm-up force evaluation and the layout build)")
    hist = rec["history"] or []
    if (rec["n"] != N_LARGE or not hist or any(mk for _, _, mk in hist)
            or sum(k for k, _, _ in hist) != 16):
        raise AssertionError(f"lj_gas run not exact: {hist}")
    if set(by) != {"celllist_sweep"} or by["celllist_sweep"] < 17:
        raise AssertionError(f"lj_gas: launches {by}, expected K1 alone, at "
                             f"least 17 times (warm-up + 16 steps)")
    stats = [rec["kinetic_energy"], rec["max_speed"], *rec["momentum"]]
    if not all(math.isfinite(x) for x in stats):
        raise AssertionError(f"lj_gas run record not finite: {rec}")
    ms = _window_ms_per_step("lj_gas", [c for _, c, _ in hist
                                        if isinstance(c, int)][-1])
    st, cfg, dt = make_scene("lj_gas", seed=0, device=DEVICE)
    _sweep_case("K1 on the lj_gas layout (Lennard-Jones, cap 16)", st, cfg,
                reps=5)
    # the cadenced path, as the JAX bench times Lennard-Jones
    cad = _cadenced_check("lj_gas", warmup(st, cfg), cfg, dt, 32, 16, 1e-5)
    log(f"  lj_gas: cadenced {cad:.3f} ms/step against the dense path's "
        f"{ms:.3f} ms/step")

    # the XLA-style cell list on the card: a 16^3 block of the lj_gas
    # lattice (spacing 0.49 < the 0.5 cutoff; the N=4,096 preset's lattice
    # is too sparse to hold a pair in range)
    side = round(N_LARGE ** (1 / 3))
    ijk = torch.stack(torch.meshgrid(*[torch.arange(16)] * 3, indexing="ij"),
                      -1).reshape(-1, 3)
    idx = ((ijk[:, 0] * side + ijk[:, 1]) * side + ijk[:, 2]).to(DEVICE)
    sub = ParticleState(*(getattr(st, f)[idx]
                          for f in ParticleState.__dataclass_fields__))
    reset_kernel_launches()
    f_cell = pair_accel(sub.positions, sub, cfg.replace(neighbor="celllist"))
    sync()
    _expect("celllist backend (plain torch)", kernel_launches(), {})
    f_k2 = pair_accel(sub.positions, sub,
                      cfg.replace(neighbor="allpairs_pallas"))
    compare(f"celllist backend vs K2 path (lj_gas lattice block, "
            f"N={sub.n}, grid {cfg.cell_grid}, cap {cfg.cell_capacity})",
            f_cell, f_k2)

    c = reference_config().replace(neighbor="celllist_pallas", cell_grid=2)
    s = make_scene("reference", seed=0, n=N_FLAGSHIP, device=DEVICE)[0]
    u, v = F.pair_features(s, c)
    reset_kernel_launches()
    got = fresh_celllist_forces(s.positions, u, v, c)
    sync()
    _expect("fresh_celllist_forces at cell_grid=2", kernel_launches(), {})
    compare(f"fresh_celllist_forces cell_grid=2 vs all-pairs (N={s.n})", got,
            allpairs_forces(s.positions, u, v, c))
    return rec, ms


def _pos_gap(got, want, world):
    """max |dpos| (minimum image) over the world size."""
    from particle3d_tpu_torch.ops.forces import min_image

    return min_image(got.positions - want.positions,
                     world).abs().max().item() / world


def _cadenced_check(label, st, cfg, dt, steps, rebuild_every, gap_tol):
    """simulate_cadenced against simulate_dense from the same state: one K1
    launch a step, nothing dropped, drift inside the budget, finite, and
    positions within ``gap_tol`` of the world; returns ms/step."""
    from particle3d_tpu_torch.engine.step import simulate_cadenced, simulate_dense
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.ops.celllist_sweep import drift_budget

    world = float(cfg.world_size)
    sync()
    reset_kernel_launches()
    out, drift, dropped = simulate_cadenced(st, cfg, dt, steps,
                                            rebuild_every=rebuild_every)
    sync()
    _expect(f"{label}: simulate_cadenced, {steps} steps", kernel_launches(),
            {"celllist_sweep": steps})
    budget = drift_budget(cfg, cfg.cell_grid)
    log(f"  {label}: dropped {int(dropped)}, max drift {float(drift):.6f} "
        f"(budget {budget:.6f})")
    if int(dropped) != 0 or not float(drift) < budget:
        raise AssertionError(f"{label}: cadenced window not exact")
    _finite(label, out)
    ref, (_, mis) = simulate_dense(st, cfg, dt, steps)
    gap = _pos_gap(out, ref, world)
    log(f"  {label}: max |dpos| / world against simulate_dense {gap:.3e} "
        f"(bound {gap_tol:g}; the two layouts order the sums differently)")
    if int(mis) != 0 or not gap <= gap_tol:
        raise AssertionError(f"{label}: cadenced trajectory off simulate_dense")
    ms, again = timed_ms(lambda: simulate_cadenced(
        st, cfg, dt, steps, rebuild_every=rebuild_every)[0], 1)
    _bit_identical(f"{label}: rerun", (out.positions, out.velocities),
                   (again.positions, again.velocities))
    log(f"  {label}: {ms / steps:.3f} ms/step ({steps}-step window, layout "
        f"built every {rebuild_every} steps, CUDA events)")
    return ms / steps


def _timed_batch(app, steps):
    """One app batch, its wall ms from the app's own update timer (the
    batch ends with the card synchronised)."""
    with app.update_timer:
        app.run_steps(steps)
    return app.update_timer.last_s * 1e3


def _app_batch(label, app, steps, k1_launches, branch, builds=None,
               counter=None):
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches

    sync()
    reset_kernel_launches()
    n_builds = len(counter) if counter is not None else 0
    ms = _timed_batch(app, steps)
    _expect(f"{label}", kernel_launches(), {"celllist_sweep": k1_launches})
    if builds is not None and len(counter) - n_builds != builds:
        raise AssertionError(f"{label}: {len(counter) - n_builds} dense "
                             f"layout builds, expected {builds}")
    if app.capacity_masked != 0:
        raise AssertionError(f"{label}: capacity_masked {app.capacity_masked}")
    if (app._dense is None) != (branch == "cadenced"):
        raise AssertionError(f"{label}: not on the {branch} branch")
    _finite(label, app.state)
    log(f"  {label}: {ms:.3f} ms for the batch (update_timer), capacity "
        f"{app.metrics()['cell_capacity']}, masked 0")
    return ms


APP_CK = "build/chip_smoke/app_checkpoint.npz"


def phase_app():
    """The app path at full width (particle_life_large, N=262,144)."""
    import os

    from particle3d_tpu_torch.app.driver import SimulationApp
    from particle3d_tpu_torch.engine.step import simulate_cadenced, simulate_culled
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import celllist_dense as D
    from particle3d_tpu_torch.ops import celllist_sweep as S
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.ops import forces as F
    from particle3d_tpu_torch.render.splat import render_frame
    from particle3d_tpu_torch.state import to_device

    log(f"[18] the app path: particle_life_large, N={N_LARGE}")
    st, cfg, dt = make_scene("particle_life_large", seed=0, n=N_LARGE,
                             device=DEVICE)
    nsc = cfg.cell_grid
    log(f"  world {float(cfg.world_size):g}, grid {nsc}, preset cap "
        f"{cfg.cell_capacity}")
    c64 = cfg.replace(cell_capacity=64, overflow_capacity=0)
    u, v = F.pair_features(st, c64)
    lay = S.build_layout(st.positions, u, v, c64, nsc, 64)
    placed = int((lay.slot_particle >= 0).sum())
    got = S.layout_forces(lay, st.positions, c64, nsc, 64)
    want = S.fresh_celllist_forces(st.positions, u, v, c64)
    if placed != N_LARGE or not torch.equal(got, want):
        raise AssertionError(f"layout_forces at cap 64 ({placed} placed) is "
                             f"not bit-identical to fresh_celllist_forces")
    log(f"  layout_forces (cap 64, {placed} placed) bit-identical to "
        f"fresh_celllist_forces (overflow_capacity=0)")
    slot = lay.slot_particle.reshape(-1)
    f_slots = S.dense_forces(lay, torch.where(
        (slot >= 0)[:, None], st.positions[slot.clamp(min=0)], 0.0), c64, nsc, 64)
    dead = f_slots[slot < 0]
    if not bool((dead == 0).all()):
        raise AssertionError("dense_forces: dead slots are not exactly 0")
    log(f"  dense_forces: {dead.shape[0]} dead slots, all exactly 0")
    c64w = cfg.replace(cell_capacity=64)
    # from rest, the scene's particles outrun an 8-step cadence's budget
    # (0.3885 against 0.3333 on the H100): printed, not gated; the
    # checked window rebuilds every 4 steps, the app's batch
    _, drift8, _ = simulate_cadenced(st, c64w, dt, STEPS, rebuild_every=8)
    log(f"  rebuilt every 8 steps: max drift {float(drift8):.6f} against the "
        f"budget {S.drift_budget(c64w, nsc):.6f} (not gated)")
    cad_ms = _cadenced_check("particle_life_large cap 64", st, c64w, dt,
                             STEPS, 4, 1e-5)

    drop32 = N_LARGE - int((S.build_layout(st.positions, u, v, cfg, nsc, 32)
                            .slot_particle >= 0).sum())
    log(f"  a cap-32 layout build drops {drop32} of {N_LARGE} rows")
    builds = []
    real_build = D.build_dense

    def counting_build(*a, **kw):
        builds.append(1)
        return real_build(*a, **kw)

    D.build_dense = counting_build
    try:
        app = SimulationApp(st, cfg, update_rate=1.0 / dt, device=DEVICE)
        start = app.state
        sync()
        reset_kernel_launches()
        ms_first = _timed_batch(app, 4)
        rung = app._cap_escalated
        launches = kernel_launches()["celllist_sweep"]
        log(f"  first batch (4 steps, cadenced): committed at capacity "
            f"{rung or cfg.cell_capacity}, K1 launches {launches} (4 a try), "
            f"{ms_first:.3f} ms incl. rewinds")
        tries = (rung // cfg.cell_capacity).bit_length() if rung else 1
        if (rung is None) != (drop32 == 0) or launches != 4 * tries:
            raise AssertionError(f"the first batch did not rewind and "
                                 f"escalate: rung {rung}, {launches} launches")
        if app.capacity_masked != 0 or app._dense is not None:
            raise AssertionError("first batch: masked, or not cadenced")
        ms_cad = _app_batch("cadenced batch, 4 steps", app, 4, 4, "cadenced")
        ms_c1 = _app_batch("carry batch, 1 step (builds the layout)", app, 1,
                           1, "carry", builds=1, counter=builds)
        ms_c2 = _app_batch("carry batch, 1 step (kept layout)", app, 1, 1,
                           "carry", builds=0, counter=builds)
    finally:
        D.build_dense = real_build

    log(f"  terminal fallback: {N_BLOB} particles in one cell, no sidecar, "
        f"max_cap 64")
    gen = torch.Generator().manual_seed(8)
    pos = st.positions.clone()
    w = float(cfg.world_size)
    cell = w / nsc
    centre = -w / 2 + (nsc // 2 + 0.5) * cell
    pos[:N_BLOB] = (centre + (torch.rand(N_BLOB, 3, generator=gen) - 0.5)
                    * 0.9 * cell).to(DEVICE)
    blob_cfg = cfg.replace(overflow_capacity=0)
    blob = SimulationApp(st.replace(positions=pos), blob_cfg,
                         update_rate=1.0 / dt, device=DEVICE)
    blob.max_cap = 64
    b0 = blob.state
    sync()
    reset_kernel_launches()
    ms_fb = _timed_batch(blob, 2)
    got = {k: c for k, c in kernel_launches().items() if c}
    log(f"  fallback batch (2 steps): launches {got}, {ms_fb:.3f} ms incl. "
        f"the rewound tries")
    if not blob._cell_fallback or got.get("allpairs_pairlist", 0) < 1:
        raise AssertionError("the app did not fall back to simulate_culled")
    _finite("fallback batch", blob.state)
    want, _ = simulate_culled(b0, blob_cfg, np.float32(1.0 / blob.update_rate),
                              2, window=2)
    _bit_identical("fallback batch against simulate_culled",
                   (blob.state.positions, blob.state.velocities),
                   (want.positions, want.velocities))
    del blob, b0, want

    splat_rec = _render_kernel_check(app)
    log(f"  render 640x480 at N={N_LARGE}")
    render_ms = {}
    host = to_device(app.state, "cpu")
    for method in ("dilate", "scatter"):
        img = app.render(640, 480, method=method)
        lit = float((img != img[0, 0]).any(-1).mean())
        ref = render_frame(host.positions, host.species, app.cfg, app.camera,
                           640, 480, method=method).numpy()
        same = float((img == ref).all(-1).mean())
        ms, _ = timed_ms(lambda: render_frame(
            app.state.positions, app.state.species, app.cfg, app.camera, 640,
            480, method=method), 10)
        log(f"  {method}: {img.shape} {img.dtype}, {lit:.4f} of pixels lit, "
            f"{same:.6f} equal to the CPU render, {ms:.3f} ms/frame (CUDA "
            f"events, mean of 10), app.render {app.frame_timer.last_s * 1e3:.3f}"
            f" ms incl. the copy to the host")
        if (img.shape != (480, 640, 3) or img.dtype != np.uint8 or lit <= 0.01
                or same < 0.999):
            raise AssertionError(f"render {method}: wrong frame")
        render_ms[method] = ms

    os.makedirs(os.path.dirname(APP_CK), exist_ok=True)
    app.save(APP_CK)
    other = SimulationApp.load(APP_CK, device=DEVICE)
    if other.step_index != app.step_index:
        raise AssertionError("checkpoint: step_index not restored")
    app.run_steps(4)
    other.run_steps(4)
    if app._dense is None and other._dense is None:
        _bit_identical("checkpoint: 4 cadenced steps, loaded app against the "
                       "uninterrupted one (both rebuild from the same state)",
                       (other.state.positions, other.state.velocities),
                       (app.state.positions, app.state.velocities))
    else:
        gap = _pos_gap(other.state, app.state, w)
        log(f"  checkpoint: 4 carry steps, kept layout against a fresh "
            f"build: max |dpos| / world {gap:.3e}")
        if not gap <= 1e-5:
            raise AssertionError("checkpoint: resumed app diverged")
    del other
    return {"cadenced_ms_per_step": cad_ms, "first_batch_ms": ms_first,
            "cadenced_batch_ms": ms_cad, "carry_batch_ms": (ms_c1, ms_c2),
            "render_ms": render_ms, "splat": splat_rec}, app


def _render_poses(app):
    """(label, camera, render_frame keywords) of the poses phase 18 holds
    the splat kernels to the plain version on."""
    from particle3d_tpu_torch.render.camera import rotate_camera

    cam = app.camera
    w = float(np.asarray(app.cfg.world_size))
    centre = cam.replace(position=np.float32([0.0, 0.0, 0.0]))
    inside = rotate_camera(cam.replace(
        position=np.float32([0.3 * w, -0.2 * w, 0.25 * w])), -25.0, 40.0)
    return [("the app's pose", cam, {}),
            ("the app's pose, no border", cam, {"draw_border": False}),
            ("inside the box at its centre", centre, {}),
            ("inside the box at its centre, footprint 5", centre,
             {"footprint": 5}),
            ("inside the box at its centre, footprint 3", centre,
             {"footprint": 3}),
            ("inside the box, turned: particles behind and off screen",
             inside, {})]


def _splat_radii(pos, cam, footprint=7):
    """(share of the particles ahead of the camera, share of those whose
    splat radius reaches footprint / 2) at a pose."""
    from particle3d_tpu_torch.render.camera import view_matrix
    from particle3d_tpu_torch.render.splat import _seed_params

    vm = torch.as_tensor(view_matrix(cam), device=pos.device)
    depth = -(pos @ vm[2, :3] + vm[2, 3])
    r_num = float(_seed_params(cam, 640, 480, footprint)[32])
    ahead = depth > 1e-6
    full = ahead & (r_num / depth.clamp(min=1e-6) >= footprint / 2.0)
    return float(ahead.float().mean()), float(full.sum() / ahead.sum())


def _render_kernel_check(app):
    """render_frame's splat kernels against its plain torch version, both
    on the card, at 640x480 on the app's state: every pixel equal at each
    of ``_render_poses``; launches and device ms of a frame of each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.render import splat
    from particle3d_tpu_torch.utils.profiling import recorded

    pos, spc, cfg = app.state.positions, app.state.species, app.cfg
    log(f"  the splat kernels against the plain version on the card, "
        f"640x480, N={pos.shape[0]}; the app's positions have row stride "
        f"{pos.stride(0)}")
    wide = torch.full((pos.shape[0], 9), float("nan"), device=pos.device)
    wide[:, 3:6] = pos  # the kernel reads rows of any stride, as views
    cases = [(label, cam, kw, pos) for label, cam, kw in _render_poses(app)]
    cases.append(("the app's pose, positions a view of 9-float rows",
                  app.camera, {}, wide[:, 3:6]))
    for label, cam, kw, p in cases:
        reset_kernel_launches()
        got = splat.render_frame(p, spc, cfg, cam, 640, 480, **kw)
        launches = _nonzero(kernel_launches())
        want = splat._render_plain(
            p, spc, cfg, cam, 640, 480, method="dilate",
            **{"footprint": 7, "draw_border": True, "border_samples": 128,
               **kw})
        sync()
        ahead, full = _splat_radii(p, cam, kw.get("footprint", 7))
        differ = int((got != want).any(-1).sum())
        lit = float((want != want[0, 0]).any(-1).float().mean())
        log(f"  {label}: {differ} of {640 * 480} pixels differ, {lit:.4f} "
            f"lit; {ahead:.4f} of the particles ahead, {full:.4f} of those "
            f"at the largest radius; launches {launches}")
        if differ or launches != {"splat_seed": 1, "splat_dilate": 1}:
            raise AssertionError(f"splat kernels at {label}: {differ} pixels "
                                 f"differ from the plain version, launches "
                                 f"{launches}")
        if label.startswith("inside the box at its centre") and full <= 0:
            raise AssertionError(f"{label}: no splat reaches its largest "
                                 f"radius; the dilate's offsets go untested")

    cam = app.camera

    def kernel():
        return splat.render_frame(pos, spc, cfg, cam, 640, 480)

    def plain():
        return splat._render_plain(pos, spc, cfg, cam, 640, 480, footprint=7,
                                   draw_border=True, border_samples=128,
                                   method="dilate")

    rec = {}
    for name, fn, reps in (("kernel", kernel, 50), ("plain", plain, 10)):
        ms, _ = timed_ms(fn, reps)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn().cpu()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        rec[name] = {"ms": ms, "host_ms_with_copy": host_ms,
                     "device_ops": len(ops)}
        log(f"  {name} path at the app's pose: {ms:.4f} ms a frame (CUDA "
            f"events, mean of {reps}), {host_ms:.4f} ms with the copy to "
            f"the host (host clock), {len(ops)} device operations a frame")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            kernel()
        sync()
    paths = [x.attrs.get("path") for x in recorded().spans
             if x.name == "render.frame"]
    log(f"  render.frame spans of 20 profiled frames: {paths.count('kernel')} "
        f"on the kernel path, {len(paths) - paths.count('kernel')} other")
    if paths != ["kernel"] * 20:
        raise AssertionError(f"render.frame spans: {paths}")
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    n, nb = pos.shape[0], 12 * 128
    nbytes = {"seed_kernel": n * (12 + spc.element_size()) + nb * 12
              + 640 * 480 * 4,
              "dilate_kernel": 640 * 480 * (4 + 3)}
    for name, times in sorted(per.items()):
        ms = sum(times) / len(times)
        kname = next((k for k in nbytes if k in name), None)
        text = ""
        if kname:
            b = bound(0, (0, 0), nbytes[kname])
            rec[kname] = {"ms": ms, "bound_ms": b[0], "bytes": nbytes[kname]}
            text = (f", bound {b[0]:.5f} ms ({nbytes[kname] / 1e6:.3f} MB), "
                    f"{100 * b[0] / ms:.2f}% of it")
        log(f"  {name[:70]}: {len(times)} launches, {ms:.5f} ms each{text}")
    return rec


def _request(url, data=None):
    """(body, content type, wall ms) of one request."""
    import urllib.request

    req = urllib.request.Request(url, data=data,
                                 method="POST" if data is not None else "GET")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body, ctype = r.read(), r.headers.get("Content-Type")
    return body, ctype, (time.perf_counter() - t0) * 1e3


def _png_pixels(body):
    """uint8 [H, W, 3] of a one-IDAT 8-bit RGB PNG with filter-0 rows."""
    import struct
    import zlib

    if body[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("/frame.png: no PNG signature")
    chunks, at = {}, 8
    while at < len(body):
        (length,) = struct.unpack(">I", body[at:at + 4])
        chunks[body[at + 4:at + 8]] = body[at + 8:at + 8 + length]
        at += 12 + length
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, colour) != (8, 2):
        raise AssertionError(f"/frame.png: depth {depth}, colour type {colour}")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError("/frame.png: a row is not filter 0")
    return rows[:, 1:].reshape(h, w, 3)


def phase_server(app):
    """The HTTP server on a thread, answering the phase 18 app's requests."""
    import threading

    from particle3d_tpu_torch.app import server

    n = app.state.n
    log(f"[19] the HTTP server on the card: N={n}")
    httpd = server.make_server(app, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    times = {}
    try:
        for page in ("/", "/gl"):
            body, ctype, times[page] = _request(url + page)
            if ctype != "text/html" or b"particle3d-tpu" not in body:
                raise AssertionError(f"{page}: not the app's page")
        body, _, times["/config"] = _request(url + "/config")
        cfg0 = json.loads(body)
        if cfg0["n"] != n:
            raise AssertionError(f"/config: n {cfg0['n']}")
        step0 = app.step_index
        app._accum = 5.0 / app.update_rate  # five steps are due: a real tick
        body, ctype, times["/positions.bin"] = _request(url + "/positions.bin")
        if ctype != "application/octet-stream" or len(body) != 8 + 13 * n:
            raise AssertionError(f"/positions.bin: {len(body)} bytes, want "
                                 f"{8 + 13 * n}")
        head_n = int(np.frombuffer(body[:4], np.int32)[0])
        pos = np.frombuffer(body[8:8 + 12 * n], np.float32).reshape(n, 3)
        spec = np.frombuffer(body[8 + 12 * n:], np.uint8)
        if (head_n != n or not np.array_equal(pos, app.state.positions.cpu().numpy())
                or not np.array_equal(spec, app.state.species.cpu().numpy())):
            raise AssertionError("/positions.bin does not decode to the app's "
                                 "state")
        body, ctype, times["/frame.png"] = _request(url + "/frame.png?w=320&h=240")
        img = _png_pixels(body)
        want = app.render(320, 240)  # no tick in between
        if ctype != "image/png" or img.shape != (240, 320, 3) or \
                not np.array_equal(img, want):
            raise AssertionError("/frame.png does not decode to app.render()")
        for name, args in (("set_drag", {"value": 0.5}),
                           ("keys", {"keys": ["w", "left"], "dt": 0.1})):
            body, _, times[f"POST {name}"] = _request(
                url + "/control", json.dumps({"name": name, "args": args}).encode())
            if json.loads(body) != {"ok": True}:
                raise AssertionError(f"/control {name}: {body!r}")
        cfg1 = json.loads(_request(url + "/config")[0])
        if cfg1["coefficient"] != 0.5:
            raise AssertionError(f"/config after set_drag: {cfg1['coefficient']}")
        body, _, times["/metrics"] = _request(url + "/metrics")
        m = json.loads(body)
        if not m["step_index"] > step0 or m["capacity_masked"] != 0:
            raise AssertionError(f"/metrics: step {m['step_index']} (was "
                                 f"{step0}), masked {m['capacity_masked']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    log(f"  six request kinds answered; step {step0} -> {m['step_index']}, "
        f"drag 0.5, positions and frame decode to the app's")
    for k, ms in times.items():
        log(f"  {k}: {ms:.3f} ms (wall, host clock)")
    return times

ADAPTIVE_STEPS = 32   # phase 20: two windows of 16 on slab_2m
ADAPTIVE_WINDOW = 16
MASK_STEP = 14        # the step of slab_2m's first masked row (seed 0)
# launches on phases 20-31's paths (K1, K1 halo, K2, K3, K4), each from 0
PATH_LAUNCHES = {"celllist_sweep": {}, "celllist_sweep_halo": {},
                 "allpairs_tri": {}, "allpairs_rect": {},
                 "allpairs_pairlist": {}}


def _zero_state(n):
    """A particle-order template for gathers of carries that place every
    row (its values are never read)."""
    from particle3d_tpu_torch.state import ParticleState

    z = torch.zeros((n, 3), device=DEVICE)
    return ParticleState(z, z, torch.zeros(n, dtype=torch.int64, device=DEVICE),
                         torch.ones(n, device=DEVICE), z)


def _masked_at(carry, cfg, dt, steps, mesh, kw, n):
    """Masked rows reported by a ``steps``-step window from ``carry``."""
    from particle3d_tpu_torch.parallel import sharded_dense_steps

    _, d = sharded_dense_steps(carry, cfg, dt, steps, mesh, n=n, **kw)
    return int(d[1])


def phase_slab_adaptive():
    """The adaptive slab driver on slab_2m (the `slab` command's seed-0
    scene): the first window masks at cap 64, rewinds, recaps to 128 and
    commits exact; held against sharded_dense_steps at cap 128."""
    from particle3d_tpu_torch.models.presets import slab_run
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.parallel import (
        gather_sharded_dense, init_sharded_dense, make_mesh,
        recap_sharded_dense, sharded_dense_adaptive, sharded_dense_steps)

    n, cfg, dt, kw = slab_run("slab_2m")
    nsc, cap0 = kw["nsc"], kw["cap"]
    log(f"[20] adaptive slab driver: slab_2m (N={n}, grid {nsc}, cap {cap0}, "
        f"ocap {kw['ocap']}, seed 0), {ADAPTIVE_STEPS} steps in windows of "
        f"{ADAPTIVE_WINDOW}, one rank")
    mesh = make_mesh(1, device=DEVICE)
    carry0 = init_sharded_dense(0, n, cfg, mesh, nsc=nsc, cap=cap0,
                                migcap=kw["migcap"])
    before, at = (_masked_at(carry0, cfg, dt, k, mesh, kw, n)
                  for k in (MASK_STEP - 1, MASK_STEP))
    log(f"  cap {cap0}: masked {before} after {MASK_STEP - 1} steps, {at} "
        f"after {MASK_STEP}")
    if before or not at:
        log(f"  the first masked row is not at step {MASK_STEP}, where "
            f"utils/slab_census.py found it: the scene has changed; the run "
            f"below reports where it rewinds")
    msgs = []

    def say(m):
        msgs.append(m)
        log(f"  {m}")

    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    (carry, cap, hist), syncs, where = count_syncs(
        lambda: sharded_dense_adaptive(
            carry0, cfg, dt, ADAPTIVE_STEPS, mesh, n=n, nsc=nsc, cap=cap0,
            mcap=kw["mcap"], migcap=kw["migcap"], ocap=kw["ocap"],
            window=ADAPTIVE_WINDOW, verbose=say))
    sync()
    wall = time.perf_counter() - t0
    halo = kernel_launches()["celllist_halo"]
    peak = torch.cuda.max_memory_allocated()
    PATH_LAUNCHES["celllist_sweep_halo"]["sharded_dense_adaptive slab_2m"] = halo
    rewinds = [m for m in msgs if "rewinding the window" in m]
    log(f"  history {hist}, final cap {cap}, {len(rewinds)} rewind(s); "
        f"{wall:.2f} s wall for {ADAPTIVE_STEPS} committed steps; K1 halo "
        f"launches {halo}; host syncs {syncs} {where}; peak device memory "
        f"{peak / 1e9:.3f} GB")
    ran = ADAPTIVE_STEPS + ADAPTIVE_WINDOW * len(rewinds)
    if (len(rewinds) != 1 or cap != 2 * cap0 or any(t for _, _, t in hist)
            or sum(k for k, _, _ in hist) != ADAPTIVE_STEPS or int(carry[4])):
        raise AssertionError(f"slab_2m adaptive: expected one rewind to cap "
                             f"{2 * cap0} and exact windows, got {hist}")
    if halo != ran:
        raise AssertionError(f"K1 halo launched {halo} times in {ran} steps")
    rc_ms, grown = timed_ms(lambda: recap_sharded_dense(
        carry0, cfg, mesh, nsc, cap0, cap), 3)
    log(f"  recap {cap0} -> {cap}: {rc_ms:.3f} ms (CUDA events, mean of 3)")
    ms = {}
    for c, start in ((cap0, carry0), (cap, grown)):
        ck = dict(kw, cap=c)
        sync()
        t0 = time.perf_counter()
        out, d = sharded_dense_steps(start, cfg.replace(cell_capacity=c), dt,
                                     ADAPTIVE_WINDOW, mesh, n=n, **ck)
        sync()
        ms[c] = (time.perf_counter() - t0) / ADAPTIVE_WINDOW * 1e3
        log(f"  cap {c}: {ms[c]:.3f} ms/step (first {ADAPTIVE_WINDOW} steps "
            f"from the start, host clock after a sync), masked {int(d[1])}")
    ref, d = sharded_dense_steps(grown, cfg.replace(cell_capacity=cap), dt,
                                 ADAPTIVE_STEPS, mesh, n=n, **dict(kw, cap=cap))
    if int(d[1]) or int(d[2]) or int(d[3]):
        raise AssertionError(f"reference at cap {cap} not exact: {d}")
    base = _zero_state(n)
    got = gather_sharded_dense(carry, base, mesh)
    want = gather_sharded_dense(ref, base, mesh)
    gap = _pos_gap(got, want, float(cfg.world_size))
    same = torch.equal(got.positions, want.positions)
    log(f"  committed carry against sharded_dense_steps at cap {cap} from "
        f"the same start: max |dpos| / world {gap:.3e}, "
        f"{'bit-identical' if same else 'not bit-identical'}")
    if not gap <= 1e-5:
        raise AssertionError("adaptive slab_2m off the cap-128 reference")
    del carry0, carry, grown, ref, got, want
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "recap_ms": rc_ms, "peak": peak}


def phase_slab_terminal():
    """The adaptive slab driver's exact terminal rung on phase 11's blob:
    K3 through the masked ring, never the plain sweep."""
    from particle3d_tpu_torch.engine.step import simulate_dense_adaptive
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.parallel import (
        build_sharded_dense, gather_sharded_dense, make_mesh,
        sharded_dense_adaptive, sharded_dense_steps, sharded_exact_steps)
    from particle3d_tpu_torch.parallel import ring as R

    st, cfg, dt = _blob_scene()
    log(f"[20b] exact terminal rung: sharded_dense_adaptive N={N_LARGE}, "
        f"{N_BLOB} particles in one cell, one rank, max_cap 64, ocap 0, "
        f"{STEPS} steps in windows of 8")
    mesh = make_mesh(1, device=DEVICE)
    carry0 = build_sharded_dense(st, cfg, mesh)
    plain = R.allpairs_forces

    def no_plain_on_card(positions, *a, **k):
        if positions.is_cuda:
            raise AssertionError("the exact rung ran the plain sweep")
        return plain(positions, *a, **k)

    R.allpairs_forces = no_plain_on_card
    try:
        sync()
        reset_kernel_launches()
        t0 = time.perf_counter()
        carry, cap, hist = sharded_dense_adaptive(
            carry0, cfg, dt, STEPS, mesh, n=N_LARGE, window=8, max_cap=64,
            ocap=0, verbose=lambda m: log(f"  {m}"))
        sync()
        wall = time.perf_counter() - t0
    finally:
        R.allpairs_forces = plain
    got_l = {k: c for k, c in kernel_launches().items() if c}
    exact_steps = sum(k for k, c, _ in hist if c == "exact")
    PATH_LAUNCHES["allpairs_rect"]["exact rung, 262k blob"] = \
        got_l.get("allpairs_rect", 0)
    log(f"  history {hist}, cap {cap}, launches {got_l}, {wall:.2f} s wall")
    if (not exact_steps or any(t for _, _, t in hist)
            or sum(k for k, _, _ in hist) != STEPS):
        raise AssertionError(f"terminal rung not taken or not exact: {hist}")
    if got_l.get("allpairs_rect", 0) != exact_steps:
        raise AssertionError(f"K3 launched {got_l.get('allpairs_rect', 0)} "
                             f"times in {exact_steps} exact steps (one rank)")
    out = gather_sharded_dense(carry, st, mesh)
    ref, rcap, rhist = simulate_dense_adaptive(st, cfg, dt, STEPS, chunk=8,
                                               max_cap=64, ocap=0)
    w = float(cfg.world_size)

    def held(got):
        """(max |dpos|, within rtol 1e-4 / atol 1e-5 of ref)."""
        diff = F.min_image(got.positions - ref.positions, w).abs()
        return (diff.max().item(),
                bool((diff <= 1e-5 + 1e-4 * ref.positions.abs()).all()))

    gap, ok = held(out)
    log(f"  against simulate_dense_adaptive (history {rhist}): max |dpos| "
        f"{gap:.3e}, rtol 1e-4 / atol 1e-5 {'held' if ok else 'missed'}")
    if not ok:
        raise AssertionError("terminal rung off simulate_dense_adaptive")
    sync()
    reset_kernel_launches()
    rcarry, _, rep_hist = sharded_dense_adaptive(
        carry0, cfg, dt, STEPS, mesh, n=N_LARGE, window=8, max_cap=64, ocap=0,
        on_ladder_end="exact_replicated", state=st)
    sync()
    k4 = kernel_launches()["allpairs_pairlist"]
    PATH_LAUNCHES["allpairs_pairlist"]["exact_replicated rung, 262k blob"] = k4
    rout = gather_sharded_dense(rcarry, st, mesh)
    rgap, rok = held(rout)
    rep_steps = sum(k for k, c, _ in rep_hist if c == "exact")
    log(f"  \"exact_replicated\" rung: history {rep_hist}, K4 launches {k4}; "
        f"against simulate_dense_adaptive max |dpos| {rgap:.3e}"
        + (" (bit-identical)" if torch.equal(rout.positions, ref.positions)
           else ""))
    if (not rep_steps or k4 != rep_steps or any(t for _, _, t in rep_hist)
            or not rok):
        raise AssertionError(f"replicated rung: {rep_hist}, K4 {k4}")
    del rcarry, rout
    ms, _ = timed_ms(lambda: sharded_exact_steps(carry0, cfg, dt, 4, mesh,
                                                 rcap=N_LARGE), 1)
    log(f"  the rung: {ms / 4:.3f} ms/step (sharded_exact_steps, rcap "
        f"{N_LARGE}, 4 steps, CUDA events)")
    rec = {"rung_ms_per_step": ms / 4}
    if hist[-1][1] != "exact":
        c = hist[-1][1]
        ms2, _ = timed_ms(lambda: sharded_dense_steps(
            carry, cfg.replace(cell_capacity=c), dt, 4, mesh, n=N_LARGE,
            cap=c, ocap=0)[0], 1)
        log(f"  re-entered the slab path at cap {c}: {ms2 / 4:.3f} ms/step "
            f"(4 steps from the final carry, CUDA events)")
        rec["reentry_ms_per_step"] = ms2 / 4
    else:
        log(f"  no re-entry within {STEPS} steps (the blob still overfills "
            f"its cell at cap {cap})")
    u, v = F.pair_features(out, cfg)
    ops = A.rect_operands(out.positions, u, out.positions, v, cfg)
    k_ms, got = timed_ms(lambda: A.rect_sweep(*ops), 3)
    b = bound(N_LARGE * N_LARGE, ops_one_sided(u.shape[1], True),
              nbytes(*ops[:5], got))
    log(f"  K3 at {N_LARGE} x {N_LARGE}: {k_ms:.3f} ms per launch (CUDA "
        f"events, mean of 3), {bound_text(b)}")
    rec["k3_ms"] = k_ms
    # held against its plain version at this shape on N_SAMPLE receivers,
    # the blob's and a sample of the rest, against all 262,144 sources:
    # unmasked, and on the masked ring block's operands with a quarter of
    # the sources at r2 = -1
    idx = torch.cat([torch.arange(N_BLOB, device=DEVICE),
                     N_BLOB + _sample(N_LARGE - N_BLOB, N_SAMPLE - N_BLOB, 21)])
    compare(f"K3 {N_LARGE} x {N_LARGE}, {N_SAMPLE} receivers", got[idx],
            A.rect_sweep_ref(ops[0][idx], ops[1][idx], *ops[2:]))
    gen = torch.Generator().manual_seed(22)
    src_ok = (torch.rand(N_LARGE, generator=gen) >= 0.25).to(DEVICE)
    mops = R.masked_rect_operands(out.positions, u, out.positions, v, src_ok,
                                  cfg)
    got = A.rect_sweep(*mops)
    compare(f"K3 masked ({int((~src_ok).sum())} of {N_LARGE} sources at "
            f"r2 = -1), {N_SAMPLE} receivers", got[idx],
            A.rect_sweep_ref(mops[0][idx], mops[1][idx], *mops[2:]))
    del carry0, carry, out, ref, ops, mops, got
    torch.cuda.empty_cache()
    return rec


def phase_column_slab():
    """parallel/domain.py's column-slab cell path at full width on one
    rank: one K1 halo launch a step, held to simulate_cadenced."""
    from particle3d_tpu_torch.engine.step import simulate_cadenced
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.ops.celllist_sweep import drift_budget
    from particle3d_tpu_torch.parallel import make_mesh, sharded_cell_simulate

    st, cfg, dt = make_scene("particle_life_large", seed=0, device=DEVICE)
    cfg = cfg.replace(cell_capacity=64)
    every = 4
    log(f"[21] column-slab cell path: sharded_cell_simulate on "
        f"particle_life_large (N={N_LARGE}, grid {cfg.cell_grid}, cap 64), "
        f"{STEPS} steps rebuilt every {every}, one rank")
    mesh = make_mesh(1, device=DEVICE)
    sync()
    reset_kernel_launches()
    out, drift = sharded_cell_simulate(st, cfg, dt, STEPS, mesh,
                                       rebuild_every=every)
    sync()
    counts = kernel_launches()
    _expect("sharded_cell_simulate", counts, {"celllist_halo": STEPS})
    PATH_LAUNCHES["celllist_sweep_halo"]["sharded_cell_simulate 262k"] = \
        counts["celllist_halo"]
    budget = drift_budget(cfg, cfg.cell_grid)
    if not float(drift) < budget:
        raise AssertionError(f"drift {float(drift)} past the budget {budget}")
    _finite("sharded_cell_simulate", out)
    ref, rdrift, dropped = simulate_cadenced(st, cfg, dt, STEPS,
                                             rebuild_every=every)
    gap = _pos_gap(out, ref, float(cfg.world_size))
    same = (torch.equal(out.positions, ref.positions)
            and torch.equal(out.velocities, ref.velocities))
    log(f"  against simulate_cadenced: max |dpos| / world {gap:.3e}, "
        f"{'bit-identical' if same else 'not bit-identical'}; drift "
        f"{float(drift):.6f} (budget {budget:.6f}), dropped {int(dropped)}")
    if int(dropped) or not gap <= 1e-5:
        raise AssertionError("column-slab path off simulate_cadenced")
    ms, _ = timed_ms(lambda: sharded_cell_simulate(
        st, cfg, dt, STEPS, mesh, rebuild_every=every)[0], 1)
    cms, _ = timed_ms(lambda: simulate_cadenced(
        st, cfg, dt, STEPS, rebuild_every=every)[0], 1)
    log(f"  {ms / STEPS:.3f} ms/step against simulate_cadenced's "
        f"{cms / STEPS:.3f} in this run (CUDA events, {STEPS} steps each)")
    return {"ms_per_step": ms / STEPS, "cadenced_ms_per_step": cms / STEPS}


def phase_two_level():
    """The 2-level ring on a 1 x 1 mesh: K3, held to simulate."""
    from particle3d_tpu_torch.engine.step import simulate
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.parallel import (make_mesh_2d,
                                               shard_state_2level,
                                               sharded_simulate_2level)

    log(f"[22] 2-level ring: sharded_simulate_2level on a 1 x 1 mesh, the "
        f"flagship scene (reference, N={N_FLAGSHIP}) on allpairs_pallas, "
        f"2 steps")
    st, cfg, dt = make_scene("reference", seed=0, n=N_FLAGSHIP, device=DEVICE)
    cfg = cfg.replace(neighbor="allpairs_pallas")
    mesh = make_mesh_2d(1, 1, device=DEVICE)
    ref = simulate(st, cfg, dt, 2)
    sync()
    reset_kernel_launches()
    out = sharded_simulate_2level(shard_state_2level(st, mesh), cfg, dt, 2,
                                  mesh)
    sync()
    counts = kernel_launches()
    _expect("sharded_simulate_2level", counts, {"allpairs_rect": 2})
    PATH_LAUNCHES["allpairs_rect"]["sharded_simulate_2level 4k"] = \
        counts["allpairs_rect"]
    rel = _rel_pos(out, ref)
    log(f"  against simulate (K2): max |dpos| / scale {rel:.3e}")
    if not rel < 5e-5:
        raise AssertionError("2-level ring off simulate")


def _run_bounded(cmd, timeout_s):
    """Run ``cmd`` in a session of its own; on timeout kill the whole
    session (a launcher and its workers). Returns (rc, stdout, stderr)."""
    import os
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return 124, out, err
    return proc.returncode, out, err


def phase_multicard():
    """D >= 2 on NCCL, one card a rank: the dry run, and slab_2m gathered
    at D ranks against one rank (torchrun)."""
    from particle3d_tpu_torch.parallel.dryrun import dryrun_multichip

    count = torch.cuda.device_count()
    if count < 2:
        log(f"[22b] multi-card check not run: {count} card(s) (dryrun_multichip, "
            f"the D >= 2 slab_2m comparison and the scale-out launcher's "
            f"ring2m, ring2level and slab16m need two or more)")
        return None
    log(f"[22b] {count} cards: dryrun_multichip on NCCL, slab_2m gathered "
        f"at D ranks against one (torchrun), and the scale-out launcher")
    rec = {}
    for d in (2, 4):
        if d > count:
            continue
        t0 = time.perf_counter()
        for line in dryrun_multichip(d):
            log(f"  {line}")
        log(f"  dryrun_multichip({d}): ok in {time.perf_counter() - t0:.1f} s")
        rc, res, _, err = _torchrun(d, [
            "particle3d_tpu_torch.parallel.dryrun", "--slab-parity",
            "slab_2m", "--steps", "8", "--device", DEVICE])
        log(f"  torchrun D={d} slab_2m against D=1: rc {rc}, {res}")
        if rc != 0 or res is None or not res["ok"]:
            raise AssertionError(f"slab_2m at D={d} off D=1 (rc {rc}):\n"
                                 f"{err[-3000:]}")
        rec[d] = res
    rec["scaleout"] = _multicard_scaleout(count)
    return rec


def _torchrun(d, module_args, timeout_s=600):
    """``module_args`` under torchrun on ``d`` ranks: (rc, the last JSON
    line of rank 0's output or None, stdout, stderr)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={d}", "-m", *module_args]
    rc, out, err = _run_bounded(cmd, timeout_s)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1]) if lines else None, out, err


def _multicard_scaleout(count):
    """The scale-out launcher on several cards: ring2m at D = 2 and 4 and
    ring2level on a 2 x 2 mesh against ring2m on one card from one scene
    (full N); slab16m at D = 4 through its checkpoint (a fresh run saved,
    then resumed and saved again), and the same step re-saved at D = 2
    into that directory and restored at D = 2."""
    from particle3d_tpu_torch.examples import scaleout as SO
    from particle3d_tpu_torch.parallel.dryrun import carry_resume, spawn_ranks

    n = SO.ring_n(1, full=True)
    rec = {}
    for mode, d in (("ring2m", 2), ("ring2m", 4), ("ring2level", 4)):
        if d > count:
            continue
        rc, res, _, err = _torchrun(d, [
            "particle3d_tpu_torch.parallel.dryrun", "--ring-parity", mode,
            "--particles", str(n), "--steps", str(MULTI_RING_STEPS), "--device",
            DEVICE])
        log(f"  torchrun D={d} {mode} N={n} against ring2m on one card: rc "
            f"{rc}, ms/step {res['record']['ms_per_step']:.3f} (one card "
            f"{res['record_one_rank']['ms_per_step']:.3f}), max |dpos| / "
            f"world {res['max_dpos_over_world']:.3e}, max |dvel| / max |vel| "
            f"{res['max_dvel_over_max_vel']:.3e}" if res else
            f"  torchrun D={d} {mode}: rc {rc}, no record")
        if rc != 0 or res is None or not res["ok"]:
            raise AssertionError(f"{mode} at D={d} off one card (rc {rc}):\n"
                                 f"{err[-3000:]}")
        rec[f"{mode}_{d}"] = res
    if count < 4:
        log("  slab16m at D = 4 needs four cards: not run")
        return rec
    ck_dir = os.path.abspath(f"{SLAB16_CK}_multi")
    shutil.rmtree(ck_dir, ignore_errors=True)
    nsc, n16, cap = SO.slab_geometry(4, full=True)
    args = ["particle3d_tpu_torch.examples.scaleout", "slab16m",
            *MULTI_SLAB_SIZE, "--steps", str(MULTI_SLAB_STEPS), "--checkpoint",
            ck_dir, "--device", DEVICE]
    for run in ("fresh", "resumed"):
        rc, res, out, err = _torchrun(4, args)
        log(f"  torchrun D=4 slab16m --full --checkpoint ({run}): rc {rc}, "
            f"{res}")
        resumed = "resumed sharded carry at step" in out
        if (rc != 0 or res is None or resumed != (run == "resumed")
                or res["masked"] or res["limbo"] or res["lost"]):
            raise AssertionError(f"slab16m at D=4 ({run}), rc {rc}:\n"
                                 f"{err[-3000:]}")
        rec[f"slab16m_4_{run}"] = res
    step = 2 * MULTI_SLAB_STEPS
    state_dir = os.path.join(ck_dir, f"{step:010d}", "state")
    before = sorted(os.listdir(state_dir))
    # the same step saved again by two ranks into the same directory
    # (carry_resume: init, `step` steps, save_carry, restore_carry, resume)
    rs = spawn_ranks(carry_resume, 2, n16, SO.slab_config(nsc, cap),
                     SO.SLAB_DT, {"nsc": nsc, "cap": cap, "migcap": None},
                     step, ck_dir, 0, False, device=DEVICE)
    after = sorted(os.listdir(state_dir))
    log(f"  step {step} re-saved at D = 2 over the D = 4 carry: files "
        f"{before} -> {after}; restored at D = 2: "
        f"{[(r['identical_to_continuation'], r['identical_to_uninterrupted']) for r in rs]}")
    if (after != ["rank_00000.pt", "rank_00001.pt"]
            or not all(r["identical_to_continuation"]
                       and r["identical_to_uninterrupted"] for r in rs)):
        raise AssertionError("slab16m re-saved at D=2 not restored")
    rec["slab16m_resave_2"] = rs
    shutil.rmtree(ck_dir, ignore_errors=True)
    return rec


TUNE_STEPS = 8  # phase 23: the `tune` command's default window
TUNE_REPS = 3   # utils.tune's timed windows a candidate
CK_DIR = "build/chip_smoke/checkpoints"


def phase_tune():
    """The geometry tuner on particle_life_large: the 8 default candidates
    and the preset's hand-tuned (24, 32), twice; K1's launches; every
    geometry's step-0 forces against all-pairs."""
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.utils.tune import candidate_geometries, tune

    st, cfg, dt = make_scene("particle_life_large", seed=0, device=DEVICE)
    hand = (cfg.cell_grid, cfg.cell_capacity)
    cands = candidate_geometries(cfg, st.n) + [hand]
    want = len(cands) * (1 + TUNE_REPS) * TUNE_STEPS
    log(f"[23] tune on particle_life_large (N={st.n}, world "
        f"{float(cfg.world_size):g}): "
        f"{len(cands)} candidates {cands}, {TUNE_STEPS}-step windows, "
        f"1 warm + {TUNE_REPS} timed each, run twice")
    runs = []
    for run in (1, 2):
        sync()
        reset_kernel_launches()
        res = tune(st, cfg, dt, steps=TUNE_STEPS, candidates=cands,
                   reps=TUNE_REPS, verbose=None)
        sync()
        _expect(f"tune run {run}", kernel_launches(), {"celllist_sweep": want})
        if run == 1:
            PATH_LAUNCHES["celllist_sweep"]["tune particle_life_large"] = want
        log(f"  run {run}, ranked (grid, cap, ms/step, masked):")
        for r in res:
            log(f"    {r.nsc:3d} {r.cap:3d} {r.ms_per_step:8.3f} "
                f"{r.capacity_masked:6d}"
                + ("   <- hand-tuned" if (r.nsc, r.cap) == hand else ""))
        runs.append(res)
    for run, res in enumerate(runs, 1):
        h = next(r for r in res if (r.nsc, r.cap) == hand)
        best = res[0]
        log(f"  run {run}: best ({best.nsc}, {best.cap}) "
            f"{best.ms_per_step:.3f} ms/step, masked {best.capacity_masked}; "
            f"hand-tuned {hand} {h.ms_per_step:.3f} ms/step, rank "
            f"{res.index(h) + 1} of {len(res)}; the tuner "
            f"{'beat' if best is not h else 'kept'} it")
    tops = [(r[0].nsc, r[0].cap) for r in runs]
    log(f"  top candidate {'repeats' if tops[0] == tops[1] else 'moves'} "
        f"between the runs: {tops[0]} then {tops[1]}")
    for nsc, cap in cands:
        _step0_forces_check(st, cfg.replace(cell_grid=nsc, cell_capacity=cap),
                            label=f"grid {nsc} cap {cap}: ")
    return runs


def phase_autograd():
    """Gradients through the step on the card: the matrix gradient against
    the CPU's, examples/learn_matrix at its defaults, and the kernel
    backends refusing to record a graph."""
    from particle3d_tpu_torch.config import reference_config
    from particle3d_tpu_torch.engine.step import step
    from particle3d_tpu_torch.examples import learn_matrix as LM
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.state import init_scene

    log("[24] autograd: the matrix gradient at tests/test_learn_matrix.py's "
        "size (N=96, 2 scenes, 2 species, 2 snapshots of 3 steps) on the "
        "card against the CPU")
    cfg0 = LM.scene_config(2, 8.0)
    batch = LM.init_batch(1, 2, 96, cfg0, "cpu")
    hidden = torch.tensor([[0.7, -0.6], [0.4, 0.5]])

    def grad_on(device):
        b = tuple(t.to(device) for t in batch)
        with torch.no_grad():
            target = LM.snapshots(hidden.to(device), b, cfg0, 1 / 30, 6, 3)
        m = torch.zeros(2, 2, device=device, requires_grad=True)
        LM.snapshot_loss(LM.snapshots(m, b, cfg0, 1 / 30, 6, 3),
                         target).backward()
        return m.grad.double().cpu()

    g_card, g_cpu = grad_on(DEVICE), grad_on("cpu")
    rel = float(torch.linalg.vector_norm(g_card - g_cpu)
                / torch.linalg.vector_norm(g_cpu))
    log(f"  d loss / d matrix: rel L2 card vs CPU {rel:.3e} (limit 1e-4), "
        f"|g| {float(torch.linalg.vector_norm(g_cpu)):.3e}")
    if not rel <= 1e-4:
        raise AssertionError("the card's matrix gradient is off the CPU's")

    log("  python -m particle3d_tpu_torch.examples.learn_matrix (defaults: "
        "N=256, 4 scenes, 12 steps, a snapshot every 3, 300 iterations)")
    sync()
    t0 = time.perf_counter()
    mat, losses = LM.main([])
    sync()
    wall = time.perf_counter() - t0
    err = float(torch.max(torch.abs(mat.cpu() - torch.tensor(LM.HIDDEN))))
    log(f"  loss {losses[0]:.3e} -> {losses[-1]:.3e} "
        f"({losses[-1] / losses[0]:.4f} of the first; limit 0.05), max "
        f"|matrix error| {err:.4f}, {wall:.1f} s ({wall / len(losses) * 1e3:.1f}"
        f" ms an iteration, host clock)")
    if not losses[-1] < 0.05 * losses[0]:
        raise AssertionError("learn_matrix did not recover the matrix")

    cases = {"allpairs_pallas": {}, "allpairs_culled": {},
             "allpairs_mxu": {},
             "celllist_pallas": dict(cell_grid=4, cell_capacity=32)}
    for backend, kw in cases.items():
        cfg = reference_config(world_size=8.0).replace(neighbor=backend, **kw)
        st = init_scene(torch.Generator().manual_seed(3), 300, cfg, DEVICE)
        m = torch.tensor(cfg.attraction_matrix, device=DEVICE,
                         requires_grad=True)
        reset_kernel_launches()
        try:
            step(st, cfg.replace(attraction_matrix=m), 1 / 60)
        except RuntimeError as e:
            if "no backward pass" not in str(e):
                raise
        else:
            raise AssertionError(f"{backend} stepped under grad")
        launched = {k: c for k, c in kernel_launches().items() if c}
        if launched:
            raise AssertionError(f"{backend}: launched {launched} under grad")
        with torch.no_grad():
            out = step(st, cfg.replace(attraction_matrix=m), 1 / 60)
        _finite(f"{backend} under no_grad", out)
        log(f"  {backend}: raises under grad before any launch; under "
            f"no_grad it steps ({_nonzero(kernel_launches())})")
    return {"grad_rel_l2": rel, "loss0": losses[0], "loss": losses[-1],
            "max_err": err, "wall_s": wall}


def phase_checkpoints():
    """utils.orbax_ckpt on the card: a 262k state snapshot, sync and async,
    and a slab_2m carry at one rank (and at two ranks with two cards),
    each restored bit-identically."""
    from particle3d_tpu_torch.engine.step import simulate_dense
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.models.presets import slab_run
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.parallel import make_mesh
    from particle3d_tpu_torch.parallel.dryrun import carry_resume, spawn_ranks
    from particle3d_tpu_torch.utils.orbax_ckpt import OrbaxCheckpointer

    shutil.rmtree(CK_DIR, ignore_errors=True)
    st, cfg, dt = make_scene("particle_life_large", seed=0, device=DEVICE)
    mid, _ = simulate_dense(st, cfg, dt, 4)
    fields = ("positions", "velocities", "species", "masses", "accel")
    size = nbytes(*(getattr(mid, f) for f in fields))
    log(f"[25] checkpoints: particle_life_large after 4 steps ({size / 1e6:.1f}"
        f" MB), saved and restored, then 4 more steps")
    rec = {}
    for mode in ("sync", "async"):
        ck = OrbaxCheckpointer(f"{CK_DIR}/{mode}", async_save=mode == "async")
        sync()
        t0 = time.perf_counter()
        ck.save(4, mid, cfg)
        t1 = time.perf_counter()
        ck.wait()
        t2 = time.perf_counter()
        got, cfg2, step = ck.restore(device=DEVICE)
        sync()
        t3 = time.perf_counter()
        ck.close()
        if step != 4 or not all(torch.equal(getattr(got, f), getattr(mid, f))
                                for f in fields):
            raise AssertionError(f"{mode} snapshot not restored bit-identically")
        reset_kernel_launches()
        a, _ = simulate_dense(got, cfg2, dt, 4)
        b, _ = simulate_dense(mid, cfg, dt, 4)
        sync()
        _expect(f"{mode}: 4 steps from the restored and the kept state",
                kernel_launches(), {"celllist_sweep": 8})
        if not torch.equal(a.positions, b.positions):
            raise AssertionError(f"{mode}: resumed run not bit-identical")
        rec[mode] = {"save_MBps": size / 1e6 / (t2 - t0),
                     "returned_ms": (t1 - t0) * 1e3,
                     "restore_MBps": size / 1e6 / (t3 - t2)}
        log(f"  {mode}: bit-identical restore and resume; save "
            f"{rec[mode]['save_MBps']:.1f} MB/s (returned after "
            f"{rec[mode]['returned_ms']:.1f} ms), restore "
            f"{rec[mode]['restore_MBps']:.1f} MB/s (host clock)")
    PATH_LAUNCHES["celllist_sweep"]["checkpoint resume 262k"] = 8

    n, cfg, dt, kw = slab_run("slab_2m")
    log(f"  slab_2m carry (N={n}, grid {kw['nsc']}, cap {kw['cap']}), one "
        f"rank: 4 steps, save_carry, restore_carry, 4 steps, against 8")
    sync()
    reset_kernel_launches()
    r = carry_resume(make_mesh(1, device=DEVICE), n, cfg, dt, kw, 4,
                     f"{CK_DIR}/slab_1", seed=0)
    sync()
    _expect("carry resume", kernel_launches(), {"celllist_halo": 20})
    PATH_LAUNCHES["celllist_sweep_halo"]["carry resume slab_2m"] = 20
    if not (r["identical_to_continuation"] and r["identical_to_uninterrupted"]):
        raise AssertionError(f"slab_2m carry resume not bit-identical: {r}")
    rec["slab_1"] = {"MB": r["bytes"] / 1e6,
                     "save_MBps": r["bytes"] / 1e6 / r["save_s"],
                     "restore_MBps": r["bytes"] / 1e6 / r["restore_s"]}
    log(f"  bit-identical to the run continued in memory and to 8 "
        f"uninterrupted steps; carry {rec['slab_1']['MB']:.1f} MB, save "
        f"{rec['slab_1']['save_MBps']:.1f} MB/s, restore "
        f"{rec['slab_1']['restore_MBps']:.1f} MB/s (host clock)")
    if torch.cuda.device_count() >= 2:
        rs = spawn_ranks(carry_resume, 2, n, cfg, dt, kw, 4,
                         os.path.abspath(f"{CK_DIR}/slab_2"), 0, True,
                         device="cuda")
        ok = all(x["identical_to_continuation"]
                 and x["identical_to_uninterrupted"] for x in rs)
        log(f"  two cards (NCCL, async saves): {rs}")
        if not ok:
            raise AssertionError("slab_2m carry resume at D=2 not bit-identical")
        rec["slab_2"] = rs
    else:
        log("  the D = 2 carry resume needs two cards: not run")
    shutil.rmtree(CK_DIR, ignore_errors=True)
    return rec


def phase_helpers(cap, ladder_ms):
    """utils.profiling's benchmark_steps and trace, and utils.metrics'
    kinetic_energy and total_momentum, on the card."""
    import glob

    from particle3d_tpu_torch.engine.step import simulate_dense
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.utils import (benchmark_steps, kinetic_energy,
                                            total_momentum, trace)

    st, cfg, dt = make_scene("particle_life_large", seed=0, device=DEVICE)
    cfg = cfg.replace(cell_capacity=cap)
    log(f"[26] helpers: benchmark_steps on a {STEPS}-step simulate_dense "
        f"window at N={N_LARGE}, cap {cap} (phase 5's window)")
    sec, (out, (mov, mis)) = benchmark_steps(simulate_dense, st, cfg, dt,
                                             STEPS, warmup=1, iters=5)
    if int(mis):
        raise AssertionError("benchmark window masked rows")
    log(f"  {sec / STEPS * 1e3:.3f} ms/step (host clock, 5 windows) beside "
        f"phase 5's {ladder_ms:.3f} (CUDA events, 1 window)")
    tdir = "build/chip_smoke/trace"
    shutil.rmtree(tdir, ignore_errors=True)
    reset_kernel_launches()
    with trace(tdir) as prof:
        simulate_dense(st, cfg, dt, STEPS)
        sync()
    files = glob.glob(f"{tdir}/*.pt.trace.json")
    text = open(files[0]).read() if len(files) == 1 else ""
    k1_events = sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "column_sweep_kernel" in e.key)
    log(f"  trace: {files} ({len(text) / 1e6:.1f} MB), K1 launches "
        f"{kernel_launches()['celllist_sweep']}, K1 kernel events "
        f"{k1_events}")
    if "column_sweep_kernel" not in text or k1_events != STEPS:
        raise AssertionError("the trace does not hold K1's kernel")
    shutil.rmtree(tdir, ignore_errors=True)
    ke, mom = kinetic_energy(out), total_momentum(out)
    v = out.velocities.double().cpu()
    m = out.masses.double().cpu()
    ke64 = 0.5 * float(torch.sum(m * torch.sum(v * v, dim=-1)))
    mom64 = torch.sum(m[:, None] * v, dim=0)
    rel_ke = abs(float(ke) - ke64) / ke64
    gap_mom = float((mom.double().cpu() - mom64).abs().max())
    scale = float(torch.sum(m[:, None] * v.abs(), dim=0).max())
    log(f"  kinetic_energy {float(ke):.6e} vs float64 {ke64:.6e} (rel "
        f"{rel_ke:.2e}, limit 1e-5); total_momentum max |gap| {gap_mom:.2e} "
        f"of sum m|v| {scale:.3e} (limit 1e-5 of it)")
    if not (rel_ke <= 1e-5 and gap_mom <= 1e-5 * scale):
        raise AssertionError("metrics off their float64 sums")
    return {"ms_per_step": sec / STEPS * 1e3, "ladder_ms_per_step": ladder_ms}


def phase_native():
    """bench.py's native-parity gate: the reference scene at N=1,000, 120
    steps, simulate on the card on allpairs (plain) and allpairs_pallas
    (K3), each against the C++ reference engine."""
    from particle3d_tpu_torch import native
    from particle3d_tpu_torch.config import reference_config
    from particle3d_tpu_torch.engine.step import simulate
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.state import from_numpy

    n, steps = 1000, 120
    log(f"[27] native parity: reference scene, N={n}, {steps} steps, on the "
        f"card against native/oracle.cpp (L2 limit 5e-3)")
    cfg = reference_config()
    rng = np.random.default_rng(3)
    pos = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    species = rng.integers(0, 5, n).astype(np.int32)
    t0 = time.perf_counter()
    want, _ = native.native_simulate(pos, vel, species, cfg, 1 / 60, steps)
    log(f"  native engine: {time.perf_counter() - t0:.2f} s")
    rec = {}
    for backend, launches in (("allpairs", {}),
                              ("allpairs_pallas", {"allpairs_rect": steps})):
        st = from_numpy(pos, vel, species, device=DEVICE)
        sync()
        reset_kernel_launches()
        out = simulate(st, cfg.replace(neighbor=backend), 1 / 60, steps)
        sync()
        _expect(f"simulate on {backend}", kernel_launches(), launches)
        l2 = float(np.sqrt(np.mean((out.positions.cpu().numpy() - want) ** 2)))
        log(f"  {backend}: L2 {l2:.3e}")
        if not l2 < 5e-3:
            raise AssertionError(f"{backend} trajectory off the native engine")
        rec[backend] = l2
    PATH_LAUNCHES["allpairs_rect"][f"native parity N={n}, {steps} steps"] = steps
    return rec


RING_SAMPLE = 2048   # phase 28: receivers held against all 2M sources
RING_TIMED = 2       # phase 28: timed ring2m steps at full N, after one
RING_CHECK_N = 262_144
SLAB16_TIMED = 4     # phase 29: timed slab16m steps, after one
SLAB16_CK = "build/chip_smoke/slab16m"
DEMO_GIF = "build/chip_smoke/demo_262k.gif"
DEMO_FRAMES = 8      # phase 30: frames of 4 steps after DEMO_WARM steps
DEMO_WARM = 16
MULTI_RING_STEPS = 1  # phase 22b: timed steps of the ring parity at full N
MULTI_SLAB_STEPS = 2  # phase 22b: timed steps of each slab16m launch
MULTI_SLAB_SIZE = ["--full"]  # phase 22b: slab16m's size (N=16,777,216)


def _quiet(_msg):
    pass


def phase_ring2m():
    """BASELINE config 4 on one card: K3 at 2,097,152^2 under gravity
    against its plain version and a float64 sum, the launcher's ring2m at
    full N, and the D = 1 ring at 262k against the K2 path."""
    from particle3d_tpu_torch.engine.step import simulate
    from particle3d_tpu_torch.examples import scaleout as SO
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.parallel import make_mesh
    from particle3d_tpu_torch.state import init_scene

    cfg = SO.ring_config()
    n = SO.ring_n(1, full=True)
    log(f"[28] ring2m (BASELINE config 4) on one card: gravity, N={n}, world "
        f"{float(cfg.world_size):g}, radius {float(cfg.particle_effect_radius):g}"
        f", softening {float(cfg.gravity_softening):g}, leapfrog, dt "
        f"{SO.RING_DT:g}")
    st = init_scene(torch.Generator().manual_seed(0), n, cfg, DEVICE)
    u, v = F.pair_features(st, cfg)
    ops = A.rect_operands(st.positions, u, st.positions, v, cfg)
    k_ms, got = timed_ms(lambda: A.rect_sweep(*ops), 1, warm=False)
    b = bound(float(n) * n, ops_one_sided(u.shape[1], True, "gravity"),
              nbytes(*ops[:5], got))
    log(f"  K3 at {n} x {n}: {k_ms:.3f} ms (CUDA events, one launch), "
        f"{bound_text(b)}")
    idx = _sample(n, RING_SAMPLE, 28)
    sub = (ops[0][idx], ops[1][idx], *ops[2:])
    plain_ms, want = timed_ms(lambda: A.rect_sweep_ref(*sub), 1, warm=False)
    err = compare(f"K3 against its plain version, {RING_SAMPLE} receivers x "
                  f"{n} sources", got[idx], want)
    want64 = A.rect_sweep_ref(*(t.double() for t in sub[:5]), *sub[5:])

    def off64(f):
        f = f.double()
        return ((torch.linalg.vector_norm(f - want64)
                 / torch.linalg.vector_norm(want64)).item(),
                (f - want64).abs().max().item())

    (k_rel, k_abs), (p_rel, p_abs) = off64(got[idx]), off64(want)
    log(f"  against a float64 sum on the same receivers: K3 rel L2 "
        f"{k_rel:.3e}, max abs {k_abs:.3e}; plain float32 rel L2 {p_rel:.3e},"
        f" max abs {p_abs:.3e} (max|F| {want64.abs().max().item():.3e}); "
        f"limit 2x the plain version's rel L2")
    if not k_rel <= 2 * p_rel:
        raise AssertionError("K3 at 2M gravity further from float64 than "
                             "twice the plain version")
    log(f"  plain version: {plain_ms:.3f} ms on {RING_SAMPLE} receivers "
        f"(CUDA events, one call)")
    del ops, got, sub, want, want64
    torch.cuda.empty_cache()

    mesh = make_mesh(1, device=DEVICE)
    sync()
    reset_kernel_launches()
    rec, out = SO.run_ring("ring2m", st, mesh, RING_TIMED,
                           say=lambda m: log(f"  {m}"))
    sync()
    counts = kernel_launches()
    _expect("ring2m, 1 untimed + 2 timed steps", counts,
            {"allpairs_rect": RING_TIMED + 1})
    if rec["kernel_launches_by_kernel"]["allpairs_rect"] != RING_TIMED:
        raise AssertionError(f"ring2m: {rec['kernel_launches_by_kernel']} in "
                             f"{RING_TIMED} timed steps")
    PATH_LAUNCHES["allpairs_rect"][f"ring2m N={n}, 1 + {RING_TIMED} steps"] = \
        counts["allpairs_rect"]
    _finite("ring2m", out)
    log(f"  ring2m: {rec['ms_per_step']:.3f} ms/step, "
        f"{rec['pair_interactions_per_s']:.4e} pair interactions/s (host "
        f"clock after a sync, {RING_TIMED} steps)")
    del st, out
    torch.cuda.empty_cache()

    st = init_scene(torch.Generator().manual_seed(1), RING_CHECK_N, cfg,
                    DEVICE)
    _, ring = SO.run_ring("ring2m", st, mesh, 2, say=_quiet)
    reset_kernel_launches()
    ref = simulate(st, cfg, SO.RING_DT, 2)
    sync()
    _expect(f"simulate on allpairs_pallas at N={RING_CHECK_N}, 2 steps",
            kernel_launches(),
            {"allpairs_tri": 2})
    rel = _rel_pos(ring, ref)
    dvel = ((ring.velocities - ref.velocities).abs().max()
            / ref.velocities.abs().max()).item()
    log(f"  D = 1 ring (K3) against simulate (K2) at N={RING_CHECK_N}, 2 "
        f"steps: max |dpos| / scale {rel:.3e} (limit 5e-5), max |dvel| / "
        f"max |vel| {dvel:.3e} (limit 1e-4; from rest the leapfrog's first "
        f"step moves nothing, the velocities carry the forces)")
    compare("cached acceleration, ring against simulate", ring.accel,
            ref.accel, gate=False)
    if not (rel < 5e-5 and dvel <= 1e-4):
        raise AssertionError("ring2m at 262k off the K2 path")
    return {"k3_ms": k_ms, "plain_ms": plain_ms, "bound": b,
            "max_abs_err": err, "k3_rel64": k_rel, "plain_rel64": p_rel,
            "ms_per_step": rec["ms_per_step"],
            "pairs_per_s": rec["pair_interactions_per_s"]}


def phase_slab16m():
    """slab16m (BASELINE config 5 direction) on one card at full N: the
    launcher's run, K1 halo against its plain version on three of its
    receiver planes, and the launcher's carry restored and continued."""
    from particle3d_tpu_torch.examples import scaleout as SO
    from particle3d_tpu_torch.ops import celllist_sweep as S
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from particle3d_tpu_torch.ops.params import pack_params
    from particle3d_tpu_torch.parallel import make_mesh, sharded_dense_steps
    from particle3d_tpu_torch.parallel import domain_sharded as DS
    from particle3d_tpu_torch.utils.orbax_ckpt import OrbaxCheckpointer

    nsc, n, cap = SO.slab_geometry(1, full=True)
    log(f"[29] slab16m on one card: N={n}, grid {nsc}, cap {cap} "
        f"({nsc ** 3 * cap} slots), 1 untimed + {SLAB16_TIMED} timed steps, "
        f"--checkpoint {SLAB16_CK}")
    shutil.rmtree(SLAB16_CK, ignore_errors=True)
    mesh = make_mesh(1, device=DEVICE)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    rec, carry = SO.run_slab(mesh, n, nsc, cap, SLAB16_TIMED,
                             checkpoint=SLAB16_CK, say=lambda m: log(f"  {m}"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    halo = kernel_launches()["celllist_halo"]
    PATH_LAUNCHES["celllist_sweep_halo"][
        f"slab16m N={n}, 1 + {SLAB16_TIMED} steps"] = halo
    carry_bytes = nbytes(*carry[:4])
    disk = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(SLAB16_CK) for f in fs)
    log(f"  {rec['ms_per_step']:.3f} ms/step; movers {rec['movers']}, masked "
        f"{rec['masked']}, limbo {rec['limbo']}, lost {rec['lost']} (carry "
        f"{int(carry[4])}); K1 halo launches {halo}; peak device memory "
        f"{peak / 1e9:.3f} GB; carry {carry_bytes / 1e9:.3f} GB, "
        f"{disk / 1e9:.3f} GB on disk, saved in {rec['save_s']:.2f} s "
        f"({carry_bytes / 1e6 / rec['save_s']:.1f} MB/s, host copy and "
        f"writes); {wall:.1f} s in all (init included)")
    if rec["masked"] or rec["limbo"] or rec["lost"] or int(carry[4]):
        raise AssertionError(f"slab16m not exact: {rec}")
    if halo != SLAB16_TIMED + 1 or \
            rec["kernel_launches_by_kernel"]["celllist_halo"] != SLAB16_TIMED:
        raise AssertionError(f"slab16m: K1 halo launched {halo} times")
    occ = carry[1] >= 0
    if not bool(torch.isfinite(carry[0][occ][:, :6]).all()):
        raise AssertionError("slab16m: non-finite rows")

    cfg = SO.slab_config(nsc, cap)
    ops, r2c, pack, pos_d, u_d, g = _slab_operands(carry, cfg)
    args = (pack_params(cfg), cfg.force_law, True, nsc, cap)
    k_ms, got = timed_ms(lambda: S.column_sweep_forces(*ops, *args, halo=True),
                         3)
    b = bound(k1_pairs(r2c.reshape(-1), nsc, cap),
              ops_one_sided(int(cfg.id_count), False), nbytes(*ops, got))
    log(f"  K1 halo at {ops[0].shape[0]} receiver columns: {k_ms:.3f} ms per "
        f"launch (CUDA events, mean of 3), {bound_text(b)}")
    fl, fr = DS.fix_halos(pack[-nsc:], pack[:nsc], cfg, g.d, 0)
    ext = torch.cat([fl, pack, fr])
    del ops
    plain_ms = 0.0
    for p in (0, nsc // 2, nsc - 1):  # both seams and the middle
        cols = slice(p * nsc, (p + 1) * nsc)
        pops = DS.halo_call_operands(pos_d[cols], u_d[cols],
                                     ext[p * nsc:(p + 3) * nsc], cfg, cap)
        ms, want = timed_ms(
            lambda: S.column_sweep_forces_ref(*pops, *args, halo=True), 1,
            warm=False)
        plain_ms += ms
        live = r2c[cols] > 0
        pick = lambda f: f.permute(0, 2, 1)[live]  # noqa: E731
        compare(f"K1 halo, receiver plane {p} ({nsc} columns)",
                pick(got[cols]), pick(want))
        _dead_rows_zero(f"K1 halo, plane {p}", got[cols], live)
    log(f"  plain version: {plain_ms:.3f} ms on 3 planes of {nsc} "
        f"(CUDA events)")
    del got, pack, pos_d, u_d, ext, want
    torch.cuda.empty_cache()

    ck = OrbaxCheckpointer(SLAB16_CK)
    sync()
    t0 = time.perf_counter()
    got, cfg2, slab, step = ck.restore_carry(mesh)
    sync()
    restore_s = time.perf_counter() - t0
    ck.close()
    if step != SLAB16_TIMED or slab != {"nsc": nsc, "cap": cap, "n": n}:
        raise AssertionError(f"restored step {step}, slab {slab}")
    _bit_identical("slab16m carry restored from its file", got, carry)
    kw = dict(nsc=nsc, cap=cap, n=n)
    resumed, _ = sharded_dense_steps(got, cfg2, SO.SLAB_DT, 2, mesh, **kw)
    del got
    kept, _ = sharded_dense_steps(carry, cfg, SO.SLAB_DT, 2, mesh, **kw)
    _bit_identical("2 steps from the restored carry against 2 continued in "
                   "memory", resumed, kept)
    log(f"  restore {restore_s:.2f} s ({carry_bytes / 1e6 / restore_s:.1f} "
        f"MB/s, read and copy to the card, host clock)")
    shutil.rmtree(SLAB16_CK, ignore_errors=True)
    del carry, resumed, kept
    torch.cuda.empty_cache()
    return {"ms_per_step": rec["ms_per_step"], "peak": peak,
            "k1h_ms": k_ms, "bound": b,
            "save_MBps": carry_bytes / 1e6 / rec["save_s"],
            "restore_MBps": carry_bytes / 1e6 / restore_s}


def phase_render_demo():
    """examples/render_demo on particle_life_large: a short warm-up and
    DEMO_FRAMES frames at 480 x 360 into a GIF, one K1 launch a step and
    one launch of each splat kernel a frame."""
    from PIL import Image

    from particle3d_tpu_torch.examples import render_demo as RD
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches

    log(f"[30] render_demo on particle_life_large: {DEMO_WARM} warm steps, "
        f"{DEMO_FRAMES} frames of 4 steps at 480x360 -> {DEMO_GIF}")
    sync()
    reset_kernel_launches()
    rec = RD.render_demo("particle_life_large", DEMO_GIF, frames=DEMO_FRAMES,
                         steps_per_frame=4, warm_steps=DEMO_WARM, width=480,
                         height=360, device=DEVICE,
                         say=lambda m: log(f"  {m}"))
    _expect("render_demo", kernel_launches(),
            {"celllist_sweep": rec["steps"], "splat_seed": DEMO_FRAMES,
             "splat_dilate": DEMO_FRAMES})
    PATH_LAUNCHES["celllist_sweep"][
        f"render_demo 262k, {DEMO_WARM} + {DEMO_FRAMES} x 4 steps"] = \
        rec["steps"]
    with Image.open(DEMO_GIF) as im:
        frames, size = im.n_frames, im.size
    log(f"  {rec['ms_per_frame']:.3f} ms a frame (4 steps and a render, host "
        f"clock); masked at most {rec['max_masked']} a window (frozen rows, "
        f"as the JAX script's demo allows); GIF {frames} frames {size}")
    if frames != DEMO_FRAMES or size != (480, 360):
        raise AssertionError(f"render_demo GIF: {frames} frames {size}")
    return rec


BENCH_KERNELS = {"celllist_sweep": "celllist_sweep",
                 "celllist_halo": "celllist_sweep_halo",
                 "allpairs_tri": "allpairs_tri", "allpairs_rect": "allpairs_rect",
                 "allpairs_pairlist": "allpairs_pairlist"}
N_1M = 1_048_576


def phase_bench():
    """The bench command's function in process: its JSON line against the
    JAX harness's keys and gates, its launches; then K4 at 1M."""
    import contextlib
    import io

    from particle3d_tpu_torch import bench
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches

    log(f"[31] the bench command: particle3d_tpu_torch.bench.main(['--device', "
        f"'{DEVICE}']), in process")
    with open("BENCH_r05.json") as f:
        want = set(json.load(f)["parsed"])
    sync()
    torch.cuda.empty_cache()
    reset_kernel_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rec = bench.main(["--device", DEVICE])
    secs = time.perf_counter() - t0
    launches = kernel_launches()
    lines = out.getvalue().strip().splitlines()
    log(f"  bench line: {lines[-1] if lines else '(none)'}")
    if len(lines) != 1 or json.loads(lines[0]) != rec:
        raise AssertionError(f"bench printed {len(lines)} lines, not its one "
                             f"JSON record")
    if set(rec) != want:
        raise AssertionError(f"bench keys: missing {sorted(want - set(rec))}, "
                             f"extra {sorted(set(rec) - want)}")
    for key, value in rec.items():
        if key in ("metric", "unit"):
            continue
        if not math.isfinite(value):
            raise AssertionError(f"bench {key} = {value}")
        if key.endswith("_rel_err") and not value < bench.GATE:
            raise AssertionError(f"bench gate {key} = {value:.3e}")
        if ("_trouble_" in key or "_lost_" in key
                or key.endswith("_committed_inexact")) and value != 0:
            raise AssertionError(f"bench {key} = {value}")
    if rec["reprobe_culled_then_cell_onchip"] != 1:
        raise AssertionError("bench: the re-probe gate did not hold")
    log(f"  launches: {_nonzero(launches)}")
    for counter, kname in BENCH_KERNELS.items():
        if not launches[counter]:
            raise AssertionError(f"bench: {kname} never launched")
        PATH_LAUNCHES[kname]["bench"] = launches[counter]
    if launches["allpairs_mxu"]:
        raise AssertionError("bench: K5 launched (bench.py never runs it)")
    log(f"  34 keys, 7 gates < {bench.GATE:g}, trouble/lost/inexact 0, "
        f"re-probe 1; {secs:.1f} s (the phase's bench, kernels already "
        f"built)")
    torch.cuda.empty_cache()

    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import allpairs_sweep as A
    from particle3d_tpu_torch.ops import forces as F

    st, cfg, _ = make_scene("particle_life_1m", seed=0, n=N_1M,
                            device=DEVICE)
    st = _morton_sorted(st, cfg)
    args, count = _worklist_operands(st, cfg)
    wj = args[6]
    ms, (oa, ob) = timed_ms(lambda: A.pairlist_sweep(*args), 3)
    got = A.pairlist_forces(oa, ob, wj)
    t = A.KERNEL_TILE
    nt = N_1M // t
    pairs = (count - nt) * t * t + nt * t * (t - 1) / 2
    u, _ = F.pair_features(st, cfg)
    b = bound(pairs, ops_two_sided(u.shape[1], True),
              nbytes(*args[:7], oa, ob))
    del oa, ob
    plain_ms, (pa, pb) = timed_ms(lambda: A.pairlist_sweep_ref(*args), 1,
                                  warm=False)
    log(f"  K4 at N={N_1M}: {ms:.3f} ms over {count} tile pairs (of "
        f"{nt * (nt + 1) // 2}), plain {plain_ms:.3f} ms, {bound_text(b)}")
    err = compare(f"K4 N={N_1M} vs its plain version", got,
                  A.pairlist_forces(pa, pb, wj))
    del got, pa, pb, args, st
    torch.cuda.empty_cache()
    return {"record": rec, "seconds": secs, "k4_1m_ms": ms,
            "k4_1m_count": count, "k4_1m_bound": b, "k4_1m_err": err}


def phase_host_syncs():
    """Every host synchronisation on the benchmark's paths falls inside a
    sync span of the recorder, and every sync span holds one. Runs last:
    torch's GPU trace, once on, stays on for the process."""
    import collections

    from torch.cuda import _gpu_trace
    from torch.profiler import ProfilerActivity, profile

    import particle3d_tpu_torch
    from particle3d_tpu_torch.app.driver import SimulationApp
    from particle3d_tpu_torch.engine.step import simulate_dense_adaptive
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.utils import profiling as prof

    log(f"[32] host synchronisations against the recorder's sync spans: "
        f"particle_life_large, N={N_LARGE}")
    pkg = os.path.dirname(particle3d_tpu_torch.__file__) + os.sep
    skip = os.path.abspath(prof.__file__)
    seen = []      # (sync span or None, the port's line that synchronised)
    armed = [False]

    def port_line():
        f = sys._getframe(1)
        while f is not None:
            fn = os.path.abspath(f.f_code.co_filename)
            if fn.startswith(pkg) and fn != skip:
                return f"{fn[len(pkg):]}:{f.f_lineno}"
            f = f.f_back
        return None

    def hit(*_):
        if not armed[0]:
            return
        where = port_line()
        if where is None:
            return
        top = prof.recorded().innermost()
        inside = top is not None and top.name.startswith("sync.")
        seen.append((top if inside else None, where))

    torch._C._activate_gpu_trace()
    for register in (_gpu_trace.register_callback_for_stream_synchronization,
                     _gpu_trace.register_callback_for_device_synchronization,
                     _gpu_trace.register_callback_for_event_synchronization):
        register(hit)

    st, cfg, dt = make_scene("particle_life_large", seed=0, n=N_LARGE,
                             device=DEVICE)
    c16 = cfg.replace(cell_capacity=16)

    def app_frames(app, frames):
        for _ in range(frames):
            app.run_steps(2)
            app.render(640, 480)

    def work(k):
        simulate_dense_adaptive(st, cfg, dt, 4 * k, chunk=k)
        simulate_dense_adaptive(st, c16, dt, 9 * k // 4, chunk=k // 4,
                                max_cap=16)
        app = SimulationApp(state=st, cfg=cfg, device=DEVICE)
        app_frames(app, k // 8)                 # cadenced
        app._per_step_rebuild = True
        app_frames(app, k // 16)                # carry
        app._per_step_rebuild = False
        app._cell_fallback = True
        app_frames(app, k // 16)                # culled
        app._recheck = True
        app_frames(app, 1)                      # back to the base capacity

    work(16)   # loads the kernels, outside the count
    sync()
    armed[0] = True
    with profile(activities=[ProfilerActivity.CUDA]):
        work(64)
        sync()
    armed[0] = False
    rec = prof.recorded()
    spans = [x for x in rec.spans if x.name.startswith("sync.")]
    if rec.counters.get("host_syncs") != len(spans):
        raise AssertionError(f"host_syncs {rec.counters.get('host_syncs')} "
                             f"against {len(spans)} sync spans")
    outside = collections.Counter(w for top, w in seen if top is None)
    per_span = collections.Counter(id(top) for top, _ in seen
                                   if top is not None)
    sites = collections.Counter((top.name, w) for top, w in seen
                                if top is not None)
    for (name, where), n in sorted(sites.items()):
        log(f"  {name} at {where}: {n} synchronisations")
    by_name = collections.defaultdict(list)
    for x in spans:
        by_name[x.name].append(per_span.get(id(x), 0))
    for name, hits in sorted(by_name.items()):
        log(f"  {name}: {len(hits)} spans, synchronisations a span "
            f"{min(hits)}-{max(hits)}")
    empty = sorted({n for n, hits in by_name.items() if min(hits) == 0})
    if outside or empty:
        raise AssertionError(f"synchronisations outside any sync span: "
                             f"{dict(outside)}; sync spans with none: {empty}")
    log(f"  {len(seen)} synchronisations, all inside the {len(spans)} sync "
        f"spans; counters {rec.counters}")

    def per_call_us(fn, calls=200_000):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls * 1e6

    def one_span():
        with prof.span("x"):
            pass

    def one_sync():
        with prof.host_sync("sync.x"):
            pass

    off = (per_call_us(one_span), per_call_us(one_sync))
    with profile(activities=[ProfilerActivity.CUDA]):
        on = (per_call_us(one_span), per_call_us(one_sync))
    log(f"  recorder a call on this host: span {off[0]:.3f} us off, "
        f"{on[0]:.3f} us on; host_sync {off[1]:.3f} us off, "
        f"{on[1]:.3f} us on")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_device()
    phase_build()
    max_abs, ms, plain_ms, b = phase_sweeps()
    k1 = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound": b,
          "shape": f"N={N_LARGE}, grid 24, cap 32"}
    k1["launches"], _ = phase_main_path()
    ladder_cap, ladder_ms = phase_ladder()
    phase_1m()
    k3 = phase_rect()
    k2 = phase_tri()
    k4 = phase_pairlist()
    launches = phase_allpairs_paths()
    phase_terminal_rung()
    phase_halo()
    phase_slab_gates()
    k1h = phase_slab_full()
    k5 = phase_mxu()
    k5["launches"], _ = phase_mxu_path()
    phase_lj_gas()
    _, app = phase_app()
    phase_server(app)
    del app
    phase_slab_adaptive()
    phase_slab_terminal()
    phase_column_slab()
    phase_two_level()
    phase_multicard()
    phase_tune()
    phase_autograd()
    phase_checkpoints()
    phase_helpers(ladder_cap, ladder_ms)
    phase_native()
    phase_ring2m()
    phase_slab16m()
    phase_render_demo()
    phase_bench()
    phase_host_syncs()
    log(smi)  # the card and its power limit, beside the numbers below
    src = "particle3d_tpu_torch/csrc/allpairs_sweep.cu"
    table = [("celllist_sweep", "particle3d_tpu_torch/csrc/celllist_sweep.cu",
              "particle3d_tpu/ops/pallas_celllist.py:50", k1),
             ("celllist_sweep_halo",
              "particle3d_tpu_torch/csrc/celllist_sweep.cu",
              "particle3d_tpu/ops/pallas_celllist.py:50 (_call halo=True, :303)",
              k1h),
             ("allpairs_tri", src, "particle3d_tpu/ops/pallas_allpairs.py:369",
              {**k2, "launches": launches["allpairs_tri"]}),
             ("allpairs_rect", src, "particle3d_tpu/ops/pallas_allpairs.py:117",
              {**k3, "launches": launches["allpairs_rect"]}),
             ("allpairs_pairlist", src,
              "particle3d_tpu/ops/pallas_allpairs.py:754",
              {**k4, "launches": launches["allpairs_pairlist"]}),
             ("allpairs_mxu", "particle3d_tpu_torch/csrc/allpairs_mxu.cu",
              "particle3d_tpu/ops/pallas_allpairs_mxu.py:69", k5)]
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda", "source": source, "replaces": repl,
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1], "library_ms": None, "shape": r["shape"],
        **({"launches_by_path": PATH_LAUNCHES[kname]}
           if PATH_LAUNCHES.get(kname) else {})}
        for kname, source, repl, r in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
