"""Multi-rank dry run of the scale-out paths (counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``), and a check of the slab
path on several cards against one.

``dryrun_multichip(n_ranks, device)`` spawns ``n_ranks`` processes, one a
rank, that join a process group on localhost (gloo on the CPU, NCCL on
cards, one card a rank) and run the JAX dry run's sequence on tiny shapes:
the ring, the 2-level ring on a 2 x D/2 mesh, the column-slab cell path, the state-sharded slab (periodic and
walled), the stay-sharded carry, the slab overflow sidecar on a blob, and
the adaptive driver's exact terminal rung. Each step is held against its
one-rank counterpart. Any rank's exception fails the call with its
traceback; ranks still alive at the deadline are killed::

    python -m particle3d_tpu_torch.parallel.dryrun --ranks 4 --device cpu

``slab_parity`` runs a ``models.presets.SLAB_RUNS`` configuration on every
rank of a launch and on one rank, from the same replicated scene, and
compares the gathered states; ``ring_parity`` does the same for the
scale-out launcher's ring modes (``examples.scaleout.run_ring``: ring2m on
the launch's ranks, ring2level on a 2 x D/2 mesh of them, against ring2m
on one rank). ``carry_resume`` saves a stay-sharded carry
mid-run with ``utils.orbax_ckpt``, restores it rank by rank and holds the
resumed run to the uninterrupted one, bit for bit. On D cards::

    torchrun --nproc_per_node=D -m particle3d_tpu_torch.parallel.dryrun \\
        --slab-parity slab_2m --steps 8
    torchrun --nproc_per_node=D -m particle3d_tpu_torch.parallel.dryrun \\
        --ring-parity ring2m --particles 2097152 --steps 1
"""

from __future__ import annotations

import argparse
import datetime
import json
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch

from ..state import resolve_device

RANK_TIMEOUT_S = 300.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, d, port, device, timeout_s, fn, args, out):
    import torch.distributed as dist

    from .mesh import make_mesh

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "gloo" if device == "cpu" else "nccl",
            init_method=f"tcp://127.0.0.1:{port}", world_size=d, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=None if device == "cpu" else torch.device("cuda", rank))
        res = fn(make_mesh(d, device=device), *args)
        out.put((rank, True, res))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - report every failure to the parent
        out.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, n_ranks: int, *args, device: str = "cuda",
                timeout_s: float = RANK_TIMEOUT_S):
    """``fn(mesh, *args)`` on ``n_ranks`` spawned processes, one a rank, in
    one process group on localhost: gloo on the CPU (one thread a rank),
    NCCL on cards (rank r on ``cuda:r``). Returns the results in rank order.
    ``fn`` must be importable by name and its results picklable. A rank
    that raises fails the call with its traceback; ranks alive at the
    deadline are killed and the call fails."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, n_ranks, port, device, timeout_s, fn, args,
                               out))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if errors or all(not p.is_alive() for p in procs):
                    break
                continue
            (results.__setitem__(rank, res) if ok
             else errors.append(f"rank {rank}:\n{res}"))
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    if errors:
        raise AssertionError("a rank failed:\n" + "\n".join(errors))
    if len(results) < n_ranks:
        raise AssertionError(f"ranks {sorted(set(range(n_ranks)) - set(results))}"
                             f" did not finish within {timeout_s:.0f} s")
    return [results[r] for r in range(n_ranks)]


def _max_gap(got, want, world) -> float:
    """Largest |dpos| between two states' positions, minimum image."""
    from ..ops.forces import min_image

    return float(min_image(got.positions - want.positions, world).abs().max())


def _dryrun_body(mesh) -> list[str]:
    """The dry run on this rank (module docstring); returns its log."""
    from ..config import reference_config
    from ..engine.step import simulate, simulate_cadenced, simulate_dense
    from ..state import from_numpy, init_scene
    from .domain import sharded_cell_simulate
    from .domain_sharded import (build_sharded_dense, gather_sharded_dense,
                                 init_sharded_dense, sharded_dense_adaptive,
                                 sharded_dense_simulate, sharded_dense_steps)
    from .launch import shard_state_2level, sharded_simulate_2level
    from .mesh import make_mesh, make_mesh_2d
    from .ring import shard_state, sharded_simulate

    d, dev = mesh.size, mesh.device
    one = make_mesh(1, device=dev)
    log = []
    dt = 1.0 / 60.0

    def check(what, ok, detail=""):
        if not ok:
            raise AssertionError(f"[dryrun] {what} failed {detail}")
        log.append(f"[dryrun] {what}: ok {detail}".rstrip())

    # the ring: every rank's shard against the one-rank trajectory
    cfg = reference_config()
    n = 16 * max(d, 2)
    st = init_scene(torch.Generator().manual_seed(0), n, cfg, dev)
    out = sharded_simulate(shard_state(st, mesh), cfg, dt, 2, mesh)
    out = out.replace(positions=mesh.all_gather(out.positions))
    gap = _max_gap(out, simulate(st, cfg, dt, 2), cfg.world_size)
    check(f"ring path, {d} ranks, N={n}",
          out.positions.shape == (n, 3) and gap < 1e-5,
          f"(max |dpos| {gap:.2e})")

    # the 2-level ring on a 2 x d/2 mesh (1 x d at odd d), K3 on its
    # blocks: the ring's point-to-point on subgroups, to global peers
    dcn = 2 if d % 2 == 0 else 1
    mesh2 = make_mesh_2d(dcn, d // dcn, device=dev)
    cfg1 = cfg.replace(neighbor="allpairs_pallas")
    out = sharded_simulate_2level(shard_state_2level(st, mesh2), cfg1, dt, 2,
                                  mesh2)
    out = out.replace(positions=mesh.all_gather(out.positions))
    gap = _max_gap(out, simulate(st, cfg1, dt, 2), cfg.world_size)
    check(f"2-level ring, {dcn} x {d // dcn} mesh, N={n}",
          out.positions.shape == (n, 3) and gap < 1e-5,
          f"(max |dpos| {gap:.2e})")

    # the column-slab cell path against the cadenced path
    nsc = 8 if 8 % d == 0 else d
    cfg2 = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=nsc, cell_capacity=8)
    st2 = init_scene(torch.Generator().manual_seed(1), n, cfg2, dev)
    out2, _ = sharded_cell_simulate(st2, cfg2, dt, 2, mesh, rebuild_every=2,
                                    nsc=nsc, cap=8)
    ref2, _, _ = simulate_cadenced(st2, cfg2, dt, 2, rebuild_every=2)
    gap = _max_gap(out2, ref2, cfg2.world_size)
    check(f"column-slab cell path, nsc={nsc}", gap < 1e-5,
          f"(max |dpos| {gap:.2e})")

    # the state-sharded slab, periodic and walled, against one rank
    for label, c in (("state-sharded slab path", cfg2),
                     ("walled slab path", cfg2.replace(boundary="clamp",
                                                       wrap_forces=False))):
        out3, diag = sharded_dense_simulate(st2, c, dt, 2, mesh, nsc=nsc,
                                            cap=8)
        ref3, _ = sharded_dense_simulate(st2, c, dt, 2, one, nsc=nsc, cap=8)
        gap = _max_gap(out3, ref3, c.world_size)
        check(label, int(diag[3]) == 0 and gap < 1e-5,
              f"(shipped {int(diag[4])}, lost {int(diag[3])}, max |dpos| "
              f"{gap:.2e})")

    # the stay-sharded carry: born sharded, stepped, gathered
    carry = init_sharded_dense(2, n, cfg2, mesh, nsc=nsc, cap=8)
    carry, diag = sharded_dense_steps(carry, cfg2, dt, 2, mesh, nsc=nsc,
                                      cap=8, n=n)
    base = st2.replace(positions=torch.zeros_like(st2.positions))
    st3 = gather_sharded_dense(carry, base, mesh)
    check("stay-sharded carry: init -> steps -> gather",
          st3.positions.shape == (n, 3) and int(diag[3]) == 0
          and bool(torch.isfinite(st3.positions).all()))

    # the overflow sidecar serves a blob over the capacity exactly
    cfg4 = cfg2.replace(cell_capacity=4)
    pos4 = init_scene(torch.Generator().manual_seed(3), n, cfg4,
                      "cpu").positions.numpy().copy()
    pos4[:24] = np.float32([1.0, 1.0, 1.0])  # 24 particles in one cell
    pos4[:24] += np.linspace(0, 0.04, 24, dtype=np.float32)[:, None]
    sp4 = (np.arange(n) % cfg4.id_count).astype(np.int32)
    st4 = from_numpy(pos4, np.zeros_like(pos4), sp4, device=dev)
    out5, (_, mask5, limbo5, lost5, _) = sharded_dense_simulate(
        st4, cfg4, dt, 2, mesh, nsc=nsc, cap=4)
    ref5, (_, ms5) = simulate_dense(st4, cfg4, dt, 2, nsc=nsc, cap=4)
    gap = _max_gap(out5, ref5, cfg4.world_size)
    check("slab overflow sidecar: blob over cap=4 served exactly",
          int(mask5) == int(limbo5) == int(lost5) == int(ms5) == 0
          and gap < 1e-5, f"(max |dpos| against one device {gap:.2e})")

    # the adaptive driver's exact terminal rung: the ladder ends at cap 8,
    # every committed window is exact
    carry4 = build_sharded_dense(st4, cfg4, mesh, nsc=nsc, cap=4)
    carry4, _, hist = sharded_dense_adaptive(
        carry4, cfg4, dt, 4, mesh, n=n, nsc=nsc, cap=4, window=2, max_cap=8,
        ocap=0)
    out6 = gather_sharded_dense(carry4, st4, mesh)
    gap = _max_gap(out6, simulate(st4, cfg4.replace(neighbor="allpairs"), dt,
                                  4), cfg4.world_size)
    check("adaptive slab exact terminal rung",
          all(t == 0 for _, _, t in hist)
          and any(c == "exact" for _, c, _ in hist) and gap < 1e-4,
          f"(history {hist}, max |dpos| against all-pairs {gap:.2e})")
    return log


def dryrun_multichip(n_ranks: int, device="cuda") -> list[str]:
    """The dry run (module docstring) on ``n_ranks`` spawned ranks: gloo
    on the CPU when ``device`` is "cpu", else NCCL with one card a rank
    (raises when fewer cards exist). Writes rank 0's log to stderr and
    returns it; raises on any rank's failure."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_ranks:
        raise ValueError(f"dryrun_multichip: {n_ranks} ranks need {n_ranks} "
                         f"cards, {torch.cuda.device_count()} present")
    log = spawn_ranks(_dryrun_body, n_ranks, device=dev.type)[0]
    sys.stderr.write("\n".join(log) + "\n")
    return log


def slab_parity(mesh, n: int, cfg, dt, kw: dict, steps: int):
    """``steps`` slab steps of one replicated scene (``init_scene`` from a
    CPU generator seeded 0, the ``slab`` command's scene) on every rank of ``mesh`` and, on rank
    0, on one rank of its own; ``kw`` holds the geometry and capacities of
    a ``SLAB_RUNS`` entry. Returns, on rank 0, a dict with both runs'
    diagnostics and the largest |dpos| / world between the gathered
    states; None on the other ranks."""
    from ..state import init_scene
    from .domain_sharded import (build_sharded_dense, gather_sharded_dense,
                                 sharded_dense_steps)
    from .mesh import make_mesh

    st = init_scene(torch.Generator().manual_seed(0), n, cfg, mesh.device)

    def run(m):
        carry = build_sharded_dense(st, cfg, m, nsc=kw["nsc"], cap=kw["cap"],
                                    migcap=kw["migcap"])
        carry, diag = sharded_dense_steps(carry, cfg, dt, steps, m, n=n, **kw)
        return (gather_sharded_dense(carry, st, m),
                [int(x) for x in torch.stack(diag).tolist()])

    got, diag = run(mesh)
    if mesh.rank:
        return None
    want, diag1 = run(make_mesh(1, device=mesh.device))
    return {"ranks": mesh.size, "n": n, "steps": steps, "diag": diag,
            "diag_one_rank": diag1,
            "max_dpos_over_world": _max_gap(got, want, cfg.world_size)
            / float(cfg.world_size)}


def ring_parity(mesh, mode: str, n: int, steps: int, seed: int = 0):
    """``run_ring(mode)`` of the scale-out launcher for ``steps`` steps from
    one ``init_scene`` draw (a CPU generator seeded ``seed``, the
    launcher's scene) on every rank of ``mesh`` (a ``Mesh``, or a
    ``Mesh2D`` for ring2level) and, on rank 0, ring2m on one rank of its
    own. Returns, on rank 0, both records, the largest |dpos| / world
    between the gathered state and the one-rank state, and the largest
    |dvel| over the largest |vel|; None on the other ranks. The command
    line passes when both are at most 1e-5."""
    from ..examples.scaleout import ring_config, run_ring
    from ..state import init_scene
    from .mesh import Mesh2D, make_mesh

    cfg = ring_config()
    st = init_scene(torch.Generator().manual_seed(seed), n, cfg, mesh.device)
    rec, shard = run_ring(mode, st, mesh, steps, say=lambda m: None)

    def gather(x):
        if isinstance(mesh, Mesh2D):  # rows of one host, then the hosts
            return mesh.dcn.all_gather(mesh.ici.all_gather(x))
        return mesh.all_gather(x)

    pos, vel = gather(shard.positions), gather(shard.velocities)
    if mesh.rank:
        return None
    rec1, one = run_ring("ring2m", st, make_mesh(1, device=mesh.device),
                         steps, say=lambda m: None)
    w = float(cfg.world_size)
    return {"mode": mode, "ranks": mesh.size, "n": n, "steps": steps,
            "record": rec, "record_one_rank": rec1,
            "max_dpos_over_world": _max_gap(one.replace(positions=pos), one,
                                            w) / w,
            # the leapfrog's first step moves no particle from rest; the
            # velocities carry the forces
            "max_dvel_over_max_vel": float((vel - one.velocities).abs().max()
                                           / one.velocities.abs().max())}


def carry_resume(mesh, n: int, cfg, dt, kw: dict, steps: int, directory: str,
                 seed: int = 0, async_save: bool = False):
    """Checkpoint a stay-sharded carry in the middle of a run and resume it
    on ``mesh``: ``steps`` slab steps from ``init_sharded_dense(seed)``,
    ``OrbaxCheckpointer.save_carry`` under ``directory`` (every rank
    writes its own rows), ``restore_carry`` (each rank reads its own file),
    ``steps`` more. Returns this rank's record: whether the resumed carry
    equals, bit for bit on every rank, the carry continued in memory and
    the carry of 2 * ``steps`` uninterrupted steps, the carry's bytes on
    this rank, and the seconds of the save (host copy and file writes) and
    of the restore (read and copy to the device)."""
    from ..utils.orbax_ckpt import OrbaxCheckpointer
    from .domain_sharded import init_sharded_dense, sharded_dense_steps

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    def advance(c, k, config=cfg):
        return sharded_dense_steps(c, config, dt, k, mesh, n=n, **kw)[0]

    def same_everywhere(a, b):
        diff = torch.tensor([0 if all(torch.equal(x, y) for x, y in zip(a, b))
                             else 1], device=mesh.device)
        return int(mesh.pmax(diff)) == 0

    carry = init_sharded_dense(seed, n, cfg, mesh, nsc=kw["nsc"],
                               cap=kw["cap"], migcap=kw["migcap"])
    mid = advance(carry, steps)
    ck = OrbaxCheckpointer(directory, async_save=async_save)
    sync()
    t0 = time.perf_counter()
    ck.save_carry(steps, mid, cfg, nsc=kw["nsc"], cap=kw["cap"], n=n,
                  mesh=mesh)
    ck.wait()
    t1 = time.perf_counter()
    got, cfg2, slab, step = ck.restore_carry(mesh)
    sync()
    t2 = time.perf_counter()
    ck.close()
    if step != steps or slab != {"nsc": kw["nsc"], "cap": kw["cap"], "n": n}:
        raise AssertionError(f"restored step {step}, slab {slab}")
    resumed = advance(got, steps, cfg2)
    return {"rank": mesh.rank, "ranks": mesh.size, "steps": 2 * steps,
            "identical_to_continuation": same_everywhere(
                resumed, advance(mid, steps)),
            "identical_to_uninterrupted": same_everywhere(
                resumed, advance(carry, 2 * steps)),
            "bytes": sum(t.numel() * t.element_size() for t in mid[:4]),
            "save_s": t1 - t0, "restore_s": t2 - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=None,
                   help="spawn this many ranks and run the dry run")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--slab-parity", default=None, metavar="CONFIG",
                   help="under torchrun: a SLAB_RUNS configuration on every "
                        "rank against one rank")
    p.add_argument("--ring-parity", default=None,
                   choices=("ring2m", "ring2level"),
                   help="under torchrun: the scale-out launcher's ring mode "
                        "on every rank against ring2m on one rank")
    # not --n: torchrun reads that as an ambiguous abbreviation of its
    # own options (--nnodes, --node-rank, ...) on some Python versions
    p.add_argument("--particles", type=int, default=2_097_152,
                   help="--ring-parity: particles")
    p.add_argument("--steps", type=int, default=8)
    a = p.parse_args(argv)
    if a.slab_parity is None and a.ring_parity is None:
        dryrun_multichip(a.ranks or 2, device=a.device)
        return 0
    from ..models.presets import slab_run
    from .launch import initialize_distributed
    from .mesh import make_mesh, make_mesh_2d

    initialize_distributed(backend="nccl" if a.device == "cuda" else "gloo")
    mesh = make_mesh(device=a.device)
    ok = True
    if a.ring_parity is not None:
        if a.ring_parity == "ring2level":
            dcn = 2 if mesh.size % 2 == 0 else 1
            mesh = make_mesh_2d(dcn, mesh.size // dcn, device=a.device)
        rec = ring_parity(mesh, a.ring_parity, a.particles, a.steps)
        if rec is not None:
            ok = (rec["max_dpos_over_world"] <= 1e-5
                  and rec["max_dvel_over_max_vel"] <= 1e-5)
            print(json.dumps({**rec, "ok": ok}), flush=True)
    else:
        n, cfg, dt, kw = slab_run(a.slab_parity)
        rec = slab_parity(mesh, n, cfg, dt, kw, a.steps)
        if rec is not None:
            ok = (rec["diag"][1:4] == rec["diag_one_rank"][1:4] == [0, 0, 0]
                  and rec["max_dpos_over_world"] <= 1e-5)
            print(json.dumps({"config": a.slab_parity, **rec, "ok": ok}),
                  flush=True)
    if mesh.size > 1:
        torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
