"""Run a function on D gloo ranks, one spawned process each, with a hard
time limit: the helper of the port's multi-rank tests.

``run_ranks(fn, d, *args)`` is the port's ``parallel.dryrun.spawn_ranks``
on the CPU: D processes join one gloo group on localhost (a finite
``init_process_group`` timeout), each calls ``fn(mesh, *args)``, and the
per-rank results come back in rank order. A rank that raises fails the
call with its traceback; ranks still alive at the deadline (an unmatched
send, say) are killed and the call fails, so a fault never hangs the
suite. ``fn`` must be importable by name (a module-level function of a
module the children can import) and its results picklable.
"""

from __future__ import annotations

from _cuda_emulated import start_torch_threads
from particle3d_tpu_torch.parallel.dryrun import spawn_ranks

RANK_TIMEOUT_S = 120.0


def run_ranks(fn, d: int, *args, timeout_s: float = RANK_TIMEOUT_S):
    # torch's thread pool must exist before the spawn: see _cuda_emulated
    start_torch_threads()
    return spawn_ranks(fn, d, *args, device="cpu", timeout_s=timeout_s)
