#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (particle3d_tpu_torch) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and builds the column-sweep kernel (K1,
particle3d_tpu_torch/csrc/celllist_sweep.cu) from its sources. Phases, in
order; any failure exits non-zero:

  1. device: name, and power limit as nvidia-smi reports it;
  2. build K1 with nvcc (seconds, registers and spills);
  3. K1 against its plain torch version on the same operands: the
     particle_life_large layout at N=262,144 (grid 24), periodic and
     walled at cap 32 and periodic at cap 64, then Lennard-Jones, gravity
     and spring at N=32,768, and particle life at cap 512 (the capacity
     ladder's top rung);
  4. main path: a 16-step simulate_dense window at N=262,144 (no masked
     rows, one K1 launch per step, finite state), its step-0 forces on
     4,096 particles against a plain all-pairs sweep over all sources, a
     bit-identical rerun, and ms/step;
  5. the `run` command (capacity ladder) for 48 steps at N=262,144, then
     the ms/step of a 16-step window at the capacity it ended on;
  6. a 16-step simulate_dense window at N=1,048,576.

Tolerance for every force comparison: relative L2 error <= 1e-5 and max
abs error <= 1e-4 * max|F|. Only the order of the sum over at most 864
sources differs between K1 and its plain version. A comparison also fails
if max|F| exceeds 1e6: such a scene is dominated by one near-singular
pair, and the bounds would then pass a wrong kernel.

The second-to-last line is a JSON record of each kernel (launches on the
main path, error against the plain version, times); the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
TOL_REL_L2 = 1e-5
TOL_MAX_ABS = 1e-4  # times max|F|
# A scene whose largest force exceeds this is degenerate (near-coincident
# pairs under a singular law): one pair would dominate both error bounds
MAX_PLAUSIBLE_F = 1e6
N_LARGE = 262_144
N_SMALL = 32_768
N_DENSE = 20_000  # ~312 occupants per cell of a 4^3 grid
STEPS = 16


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def timed_ms(fn, reps):
    """Mean ms per call of ``fn`` on the card (CUDA events), after one
    warm-up call with the same arguments."""
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


def compare(name, got, want):
    """Fail unless ``got`` matches ``want`` within the stated tolerance."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    scale = want.abs().max().item()
    rel_l2 = (torch.linalg.vector_norm(got - want)
              / torch.linalg.vector_norm(want)).item()
    max_abs = err.max().item()
    ok = (bool(torch.isfinite(got).all()) and rel_l2 <= TOL_REL_L2
          and max_abs <= TOL_MAX_ABS * scale and 0 < scale <= MAX_PLAUSIBLE_F)
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
    return name


def phase_build():
    from particle3d_tpu_torch.ops.celllist_sweep import build_kernel

    t0 = time.perf_counter()
    build_log = build_kernel()
    log(f"[2] K1 built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("["):
            log(f"  {line.strip()}")


def _sweep_case(label, state, cfg, reps):
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
    log(f"  {label}: {int(live.sum())} receivers, K1 {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return compare(label, pick(got), pick(want)), ms, plain_ms


def phase_sweeps():
    from particle3d_tpu_torch.config import reference_config
    from particle3d_tpu_torch.models import make_scene
    from particle3d_tpu_torch.state import init_scene

    log(f"[3] K1 against its plain version (N={N_LARGE}, grid 24, cap 32)")
    st, cfg, _ = make_scene("particle_life_large", seed=0, n=N_LARGE,
                            device=DEVICE)
    main = _sweep_case("particle_life wrap", st, cfg, reps=20)
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
    # the capacity ladder's top rung: at cap 512 each block serves its
    # receivers in two passes of 256 threads, and cells hold > 256 occupants
    dense = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=4, cell_capacity=512)
    _sweep_case(f"particle_life wrap (N={N_DENSE}, grid 4, cap 512)",
                init_scene(gen, N_DENSE, dense, DEVICE), dense, reps=5)
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

    log(f"[4] main path: simulate_dense, {STEPS} steps, N={N_LARGE}")
    st, cfg, dt = make_scene("particle_life_large", seed=0, n=N_LARGE,
                             device=DEVICE)
    sync()
    S.KERNEL_LAUNCHES = 0
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    max_abs, ms, plain_ms = phase_sweeps()
    launches, _ = phase_main_path()
    phase_ladder()
    phase_1m()
    print(json.dumps({"kernels": [{
        "name": "celllist_sweep", "route": "cuda",
        "source": "particle3d_tpu_torch/csrc/celllist_sweep.cu",
        "replaces": "particle3d_tpu/ops/pallas_celllist.py:50",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
