"""Run a function on D gloo ranks, one spawned process each, with a hard
time limit: the helper of the port's multi-rank tests.

``run_ranks(fn, d, *args)`` starts D processes that join one gloo group
on localhost (``init_process_group`` with a finite timeout), calls
``fn(mesh, *args)`` in each and returns the list of per-rank results, in
rank order. A rank that raises fails the call with its traceback; ranks
still alive at the deadline (an unmatched send, say) are killed and the
call fails, so a fault never hangs the suite. ``fn`` must be importable by
name (a module-level function of a module the children can import) and
its results picklable.
"""

from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch.multiprocessing as mp

from _cuda_emulated import start_torch_threads

RANK_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, d, port, fn, args, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=d,
            rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        from particle3d_tpu_torch.parallel import make_mesh

        res = fn(make_mesh(d, device="cpu"), *args)
        out.put((rank, True, res))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - report every failure to the parent
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, d: int, *args, timeout_s: float = RANK_TIMEOUT_S):
    # torch's thread pool must exist before the spawn: see _cuda_emulated
    start_torch_threads()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(r, d, port, fn, args, out),
                         daemon=True) for r in range(d)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < d:
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
    if len(results) < d:
        raise AssertionError(f"ranks {sorted(set(range(d)) - set(results))} "
                             f"did not finish within {timeout_s:.0f} s")
    return [results[r] for r in range(d)]
