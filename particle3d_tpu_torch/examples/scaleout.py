"""Scale-out launchers for BASELINE configs 4 and 5 (port of the JAX
package's ``examples/scaleout.py``).

  ring2m      BASELINE config 4: gravitational N-body, N=2,097,152 under
              --full, on the particle-sharded ring all-pairs
              (``parallel.sharded_simulate``; K3 sweeps each ring hop).
  ring2level  the same on the 2-level (hosts x devices) ring
              (``parallel.auto_mesh_2d``, ``sharded_simulate_2level``).
  slab16m     BASELINE config 5 direction: particle life at N=16,777,216
              under --full on the stay-sharded slab cell list
              (``init_sharded_dense``, ``sharded_dense_steps``; K1's halo
              mode), O(N/D) state a rank, with a sharded carry checkpoint
              and resume (``--checkpoint DIR``).

Both ring modes run ``neighbor="allpairs_pallas"`` on every device. The
JAX script drops to its XLA ``allpairs`` backend off the TPU; here K3's
wrapper itself routes CPU tensors to its plain version, so one setting
serves the card and the CPU.

One rank, on the card::

    python -m particle3d_tpu_torch.examples.scaleout ring2m --full
    python -m particle3d_tpu_torch.examples.scaleout slab16m --full \\
        --checkpoint build/slab16m_ck

D ranks, one card each (NCCL), or on the CPU with ``--device cpu`` (gloo)::

    torchrun --nproc_per_node=D -m particle3d_tpu_torch.examples.scaleout \\
        ring2level --full
    torchrun --nproc_per_node=D -m -- particle3d_tpu_torch.examples.scaleout \\
        ring2m --n 65536

(``--`` before the module keeps torchrun from reading ``--n`` as an
ambiguous abbreviation of its own options, which some Python versions do.)

Each mode first runs one step that it throws away (the step functions
never write their inputs): it builds and loads the kernels before the
clock starts. Rank 0 prints the JAX script's lines, then one JSON record
(``run_ring``, ``run_slab``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import SimConfig
from ..state import init_scene, resolve_device

RING_FULL_N = 2_097_152
SLAB_FULL_N = 16_777_216
RING_DT = 1e-3
SLAB_DT = 1.0 / 60.0


def ring_config() -> SimConfig:
    """BASELINE config 4: gravity in a periodic box of 40, radius 20,
    softening 0.05, leapfrog."""
    return SimConfig(force_law="gravity", particle_effect_radius=20.0,
                     world_size=40.0, gravity_softening=0.05,
                     integrator="leapfrog",
                     neighbor="allpairs_pallas").validate()


def ring_n(ranks: int, n: int | None = None, full: bool = False) -> int:
    """N of a ring run: ``n``, else 2,097,152 under ``full``, else 128 a
    rank; cut to a multiple of the rank count."""
    n = n or (RING_FULL_N if full else 128 * ranks)
    return n - n % ranks


def slab_geometry(ranks: int, n: int | None = None,
                  full: bool = False) -> tuple[int, int, int]:
    """(grid, N, cap) of a slab run: grid 64 under ``full`` or past 1e6
    particles, else 8, rounded up to a multiple of the rank count; N
    16,777,216 under ``full``, else 4,096, cut to a multiple of the rank
    count; cap 2.5 times the mean occupancy, plus one."""
    nsc = 64 if (full or (n or 0) > 1_000_000) else 8
    nsc = -(-nsc // ranks) * ranks
    n = n or (SLAB_FULL_N if full else 4096)
    n -= n % ranks
    return nsc, n, max(4, int(2.5 * n / nsc ** 3) + 1)


def slab_config(nsc: int, cap: int) -> SimConfig:
    """Particle life in a box of ``nsc`` (cell width 1, the cutoff) on the
    column-sweep cell list."""
    return SimConfig(world_size=float(nsc), neighbor="celllist_pallas",
                     cell_grid=nsc, cell_capacity=cap).validate()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches_since(before: dict) -> dict:
    from ..ops import kernel_launches

    return {k: c - before[k] for k, c in kernel_launches().items()}


def run_ring(mode: str, state, mesh, steps: int, say=print):
    """``steps`` timed steps of the full ``state`` (every rank passes the
    same one) on the ring of ``mesh``: ``ring2m`` shards it over a 1-D
    mesh (``parallel.make_mesh``), ``ring2level`` over a 2-level one
    (``parallel.make_mesh_2d``). Returns ``(record, this rank's shard)``;
    the record holds mode, n, ranks, steps, ms_per_step,
    pair_interactions_per_s and the kernel launches of the timed steps."""
    from ..ops import kernel_launches
    from ..parallel import (shard_state, shard_state_2level,
                            sharded_simulate, sharded_simulate_2level)

    cfg = ring_config()
    if mode == "ring2m":
        shard = shard_state(state, mesh)

        def run(s, k):
            return sharded_simulate(s, cfg, RING_DT, k, mesh)
    elif mode == "ring2level":
        shard = shard_state_2level(state, mesh)

        def run(s, k):
            return sharded_simulate_2level(s, cfg, RING_DT, k, mesh)
    else:
        raise ValueError(f"unknown ring mode {mode!r}")
    n = state.n
    run(shard, 1)  # thrown away: builds and loads K3 before the clock
    _sync(mesh.device)
    before = kernel_launches()
    t0 = time.perf_counter()
    out = run(shard, steps)
    _sync(mesh.device)
    sec = time.perf_counter() - t0
    say(f"{mode}: N={n} {steps} steps in {sec:.2f}s = {steps / sec:.2f} "
        f"steps/s ({float(n) * n * steps / sec:.3e} pair-interactions/s)")
    rec = {"mode": mode, "n": n, "ranks": mesh.size, "steps": steps,
           "ms_per_step": sec / steps * 1e3,
           "pair_interactions_per_s": float(n) * n * steps / sec,
           "kernel_launches_by_kernel": _launches_since(before)}
    return rec, out


def run_slab(mesh, n: int, nsc: int, cap: int, steps: int, seed: int = 0,
             checkpoint: str | None = None, say=print):
    """``steps`` timed steps of the stay-sharded slab on ``mesh``, from
    ``init_sharded_dense(seed)``, or, when ``checkpoint`` names a
    directory holding a slab carry, from its latest one (whose geometry
    then replaces ``n``, ``nsc`` and ``cap``); with ``checkpoint`` the
    carry is saved there after the run, each rank writing its own rows.
    Returns ``(record, this rank's carry)``; the record holds mode, n,
    ranks, steps, ms_per_step, the geometry, the step index reached,
    movers, masked, limbo, lost and shipped of the timed window, the
    kernel launches of the timed steps and, with ``checkpoint``, the
    seconds of the restore and the save."""
    from ..ops import kernel_launches
    from ..parallel import init_sharded_dense, sharded_dense_steps
    from ..utils.orbax_ckpt import OrbaxCheckpointer

    cfg = slab_config(nsc, cap)
    step0, ck, rec = 0, None, {}
    if checkpoint:
        ck = OrbaxCheckpointer(checkpoint)
        if ck.steps():
            t0 = time.perf_counter()
            carry, cfg, slab, step0 = ck.restore_carry(mesh)
            _sync(mesh.device)
            rec["restore_s"] = time.perf_counter() - t0
            nsc, cap, n = slab["nsc"], slab["cap"], slab["n"]
            say(f"resumed sharded carry at step {step0} "
                f"(nsc={nsc} cap={cap} N={n})")
    if step0 == 0:
        carry = init_sharded_dense(seed, n, cfg, mesh, nsc=nsc, cap=cap)
    kw = dict(nsc=nsc, cap=cap, n=n)
    sharded_dense_steps(carry, cfg, SLAB_DT, 1, mesh, **kw)  # thrown away
    _sync(mesh.device)
    before = kernel_launches()
    t0 = time.perf_counter()
    carry, diag = sharded_dense_steps(carry, cfg, SLAB_DT, steps, mesh, **kw)
    _sync(mesh.device)
    sec = time.perf_counter() - t0
    mov, mask, limbo, lost, shipped = (int(x) for x in diag)
    say(f"slab (stay-sharded): N={n} nsc={nsc} cap={cap} {steps} steps in "
        f"{sec:.2f}s = {steps / sec:.2f} steps/s; shipped={shipped} "
        f"masked={mask} lost={lost}")
    rec = {"mode": "slab16m", "n": n, "ranks": mesh.size, "steps": steps,
           "ms_per_step": sec / steps * 1e3, "nsc": nsc, "cap": cap,
           "step": step0 + steps, "movers": mov, "masked": mask,
           "limbo": limbo, "lost": lost, "shipped": shipped,
           "kernel_launches_by_kernel": _launches_since(before), **rec}
    if ck is not None:
        t0 = time.perf_counter()
        ck.save_carry(step0 + steps, carry, cfg, nsc=nsc, cap=cap, n=n,
                      mesh=mesh)
        ck.close()
        rec["save_s"] = time.perf_counter() - t0
        say(f"saved sharded carry at step {step0 + steps} -> {checkpoint}")
    return rec, carry


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["ring2m", "ring2level", "slab16m"])
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--full", action="store_true",
                   help="use the full BASELINE N (2M / 16M)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="slab mode: save the stay-sharded carry to DIR "
                        "after the run (each rank writes only its slab "
                        "rows) and, if DIR already holds one, RESUME from "
                        "it instead of init")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)

    from ..parallel import (auto_mesh_2d, initialize_distributed, make_mesh)

    device = resolve_device(a.device)
    multi = initialize_distributed(
        backend="nccl" if device.type == "cuda" else "gloo")
    mesh = (auto_mesh_2d(device=a.device) if a.mode == "ring2level"
            else make_mesh(device=a.device))
    d = mesh.size

    def say(msg):
        if mesh.rank == 0:
            print(msg, flush=True)

    say(f"devices={d} processes={d} multi_host={multi}")
    try:
        if a.mode == "slab16m":
            nsc, n, cap = slab_geometry(d, a.n, a.full)
            rec, _ = run_slab(mesh, n, nsc, cap, a.steps, a.seed,
                              a.checkpoint, say)
        else:
            state = init_scene(torch.Generator().manual_seed(a.seed),
                               ring_n(d, a.n, a.full), ring_config(),
                               mesh.device)
            rec, _ = run_ring(a.mode, state, mesh, a.steps, say)
        say(json.dumps(rec))
    finally:
        if multi:
            torch.distributed.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
