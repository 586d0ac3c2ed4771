"""Process-group start-up for the multi-rank paths (port of the runtime
half of ``particle3d_tpu.parallel.launch``).

One process per rank, started by ``torchrun --nproc_per_node=D`` (or any
launcher that sets the same variables): ``initialize_distributed()`` reads
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, picks NCCL for CUDA and gloo for the CPU, always with a
finite timeout, and is a no-op for a plain single-process run or a second
call. Typical use, the same program on every rank::

    from particle3d_tpu_torch.parallel import (
        initialize_distributed, make_mesh, init_sharded_dense,
        sharded_dense_steps)

    initialize_distributed()
    mesh = make_mesh()                  # every rank of the group
    carry = init_sharded_dense(0, n, cfg, mesh)
    carry, diag = sharded_dense_steps(carry, cfg, dt, 10, mesh, n=n)

The JAX module's 2-level (hosts x chips) mesh functions are not ported yet
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# torchrun's variables: their presence marks a multi-process launch
_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
DEFAULT_TIMEOUT_S = 300.0


def cluster_env_configured(environ=None) -> bool:
    """True when the environment describes a launch of more than one rank
    (``WORLD_SIZE`` > 1 with ``RANK`` and ``MASTER_ADDR`` set)."""
    environ = os.environ if environ is None else environ
    if not all(environ.get(k) for k in _CLUSTER_ENV):
        return False
    try:
        return int(environ["WORLD_SIZE"]) > 1
    except ValueError:
        return False


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S,
                           environ=None) -> bool:
    """Initialise the default process group when appropriate.

    * explicit ``init_method``/``world_size``/``rank`` -> that group;
    * none, but torchrun's environment -> ``env://`` from it;
    * a plain single-process run -> no-op.

    ``backend`` defaults to NCCL when CUDA is available, else gloo; with
    NCCL each rank takes ``cuda:<LOCAL_RANK>`` as its current device. The
    timeout is always finite, so a rank that never arrives fails the others
    instead of hanging them. Idempotent. Returns True iff the group spans
    more than one process afterwards."""
    environ = os.environ if environ is None else environ
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = init_method is not None or world_size is not None
    if not explicit and not cluster_env_configured(environ):
        return False
    if explicit:
        if init_method is None or world_size is None or rank is None:
            raise ValueError("pass init_method, world_size and rank together")
    else:
        init_method = "env://"
        world_size = int(environ["WORLD_SIZE"])
        rank = int(environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1
