#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (particle3d_tpu_torch) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and builds the port's kernels from their
sources: the column sweep K1 (particle3d_tpu_torch/csrc/celllist_sweep.cu),
the all-pairs kernels K2, K3 and K4 (csrc/allpairs_sweep.cu) and the
ghost-image sweep K5 (csrc/allpairs_mxu.cu). Phases, in order; any failure
exits non-zero:

  1. device: name, and power limit as nvidia-smi reports it;
  2. build the three libraries with nvcc, in parallel (seconds, registers
     and spills of every kernel);
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
  9. K4 against its plain version at N=32,768 and N=12,345, and at
     N=262,144 against dense K2 on the Morton-sorted particle_life_large
     scene, and on phase 8's padded-row scene with the lower-triangular
     worklist (the padded tile as a receiver);
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
     sweep.

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
timed window), error against the plain version, its time and the plain
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
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
    from particle3d_tpu_torch.ops import (allpairs_mxu_sweep, allpairs_sweep,
                                          celllist_sweep)

    t0 = time.perf_counter()
    libs = {"K1": celllist_sweep, "K2-K4": allpairs_sweep,
            "K5": allpairs_mxu_sweep}
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        logs = dict(zip(libs, pool.map(lambda m: m.build_kernel(),
                                       libs.values())))
    log(f"[2] K1, K2-K4 and K5 built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, build_log in logs.items():
        for line in _ptxas_summary(build_log):
            log(f"  {name}: {line}")


_LAWS = ("particle_life", "lennard_jones", "gravity", "spring")


def _ptxas_summary(build_log):
    """One line per compiled kernel (family, law, wrap, feature width):
    registers, spill bytes and shared memory, from nvcc's -Xptxas -v."""
    out, entry, spills = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"(column_sweep|rect|tri|pairlist|mxu)_kernelI"
                      r"((?:L[ib]\d+E)+)", line)
        if m:
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


def _step0_forces_check(state, cfg, n_sample=4096):
    """Dense-path step-0 pair forces against a plain all-pairs sweep."""
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
    gen = torch.Generator().manual_seed(2)
    idx = torch.randperm(state.n, generator=gen)[:n_sample].to(DEVICE)
    u, v = F.pair_features(state, cfg)
    want = allpairs_forces(state.positions[idx], u[idx], v, cfg, block_i=128,
                           src_positions=state.positions, src_v=v)
    compare(f"step-0 forces of {n_sample} particles vs all-pairs", f[idx], want)


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
    _window_ms_per_step("particle_life_large", rec["history"][-1][1])
    return rec


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
    for n in (N_SMALL, N_RAGGED):
        _, s, c = _law_scenes(n, gen)[0]
        args, count = _worklist_operands(_morton_sorted(s, c), c)
        wj = args[6]
        compare(f"K4 particle_life (N={n}, {count} tile pairs)",
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
    log(f"  K4 {ms:.3f} ms over {count} tile pairs (of "
        f"{(N_LARGE // t) * (N_LARGE // t + 1) // 2}), plain {plain_ms:.3f} "
        f"ms, {bound_text(b)}")
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


def _expect(label, launches, want):
    """Fail unless the path launched exactly the kernels in ``want``."""
    got = {k: c for k, c in launches.items() if c}
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


def phase_terminal_rung():
    from particle3d_tpu_torch.engine.step import simulate_dense_adaptive
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches

    log(f"[11] terminal rung: simulate_dense_adaptive N={N_LARGE}, "
        f"{N_BLOB} particles in one cell, ocap 0, max_cap 64")
    st, cfg, dt = make_scene("particle_life_large", seed=0, device=DEVICE)
    gen = torch.Generator().manual_seed(8)
    pos = st.positions.clone()
    w = float(cfg.world_size)
    cell = w / cfg.cell_grid
    centre = -w / 2 + (cfg.cell_grid // 2 + 0.5) * cell
    pos[:N_BLOB] = (centre + (torch.rand(N_BLOB, 3, generator=gen) - 0.5)
                    * 0.9 * cell).to(DEVICE)
    st = st.replace(positions=pos)
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
        fl, fr = DS.fix_halos(pack[-nsc:], pack[:nsc], cfg, g, 0)
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
    from particle3d_tpu_torch.engine.step import pair_accel
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
    st, cfg, _ = make_scene("lj_gas", seed=0, device=DEVICE)
    _sweep_case("K1 on the lj_gas layout (Lennard-Jones, cap 16)", st, cfg,
                reps=5)

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
    phase_ladder()
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
        "bound_by": r["bound"][1], "library_ms": None, "shape": r["shape"]}
        for kname, source, repl, r in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
