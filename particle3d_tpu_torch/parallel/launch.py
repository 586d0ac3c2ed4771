"""Process-group start-up and the 2-level (hosts x devices) mesh (port
of ``particle3d_tpu.parallel.launch``).

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

Across hosts, ``auto_mesh_2d()`` makes the (hosts x devices) mesh from
torchrun's ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE`` (one host a row), and
``sharded_simulate_2level`` steps a shard on the 2-level ring
(``ring.ring_forces_2level``), whose block crosses hosts once a revolution
of the in-host ring::

    initialize_distributed()
    mesh = auto_mesh_2d()               # (hosts, devices per host)
    shard = shard_state_2level(state, mesh)
    shard = sharded_simulate_2level(shard, cfg, dt, num_steps, mesh)
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..config import SimConfig
from ..engine.step import step as _step
from ..ops import forces as F
from ..state import ParticleState
from .mesh import Mesh2D, make_mesh_2d
from .ring import ring_forces_2level

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


def mesh_shape_2level(n_devices: int, n_processes: int) -> tuple[int, int]:
    """(dcn, ici) mesh shape: one row of the mesh per process (a host, in
    the JAX package's terms), its devices along the row. Pure logic."""
    if n_processes < 1 or n_devices < 1:
        raise ValueError(f"bad topology: {n_devices} devices / "
                         f"{n_processes} processes")
    if n_devices % n_processes:
        raise ValueError(f"{n_devices} devices do not split evenly over "
                         f"{n_processes} processes")
    return n_processes, n_devices // n_processes


def auto_mesh_2d(dcn: int | None = None, ici: int | None = None,
                 device="cuda", environ=None) -> Mesh2D:
    """The (hosts x devices) mesh of this launch. With neither size given,
    one row per host: ``ici`` = ``LOCAL_WORLD_SIZE`` (the ranks on this
    host) and ``dcn`` = ``WORLD_SIZE`` / ``ici``; one given size fixes the
    other. ``WORLD_SIZE`` defaults to the process group's size (1 without
    one), ``LOCAL_WORLD_SIZE`` to ``WORLD_SIZE``."""
    environ = os.environ if environ is None else environ
    initialised = dist.is_available() and dist.is_initialized()
    world = int(environ.get("WORLD_SIZE",
                            dist.get_world_size() if initialised else 1))
    if dcn is None and ici is None:
        local = int(environ.get("LOCAL_WORLD_SIZE", world))
        if local < 1 or world % local:
            raise ValueError(f"WORLD_SIZE={world} is not a whole number of "
                             f"hosts of LOCAL_WORLD_SIZE={local}")
        dcn, ici = mesh_shape_2level(world, world // local)
    elif dcn is None:
        dcn = world // ici
    elif ici is None:
        ici = world // dcn
    return make_mesh_2d(dcn, ici, device=device)


def shard_state_2level(state: ParticleState, mesh: Mesh2D) -> ParticleState:
    """This rank's block of a full state over both mesh axes: rows
    ``[r * n / D, (r + 1) * n / D)`` for global rank r (dcn-major, as the
    JAX package's ``P(("dcn", "shard"))``). N must divide by the mesh
    size."""
    n, total = state.n, mesh.size
    if n % total:
        raise ValueError(f"N={n} must divide by mesh size {total}")
    lo = mesh.rank * (n // total)
    return ParticleState(*(getattr(state, f)[lo:lo + n // total]
                           for f in ParticleState.__dataclass_fields__))


def sharded_simulate_2level(state: ParticleState, cfg: SimConfig, dt,
                            num_steps: int, mesh: Mesh2D) -> ParticleState:
    """``num_steps`` steps of this rank's block (``shard_state_2level``)
    with the 2-level ring's forces: d_ici * d_dcn blocks a force
    evaluation, d_dcn - 1 of the hops across hosts. Every rank must hold
    a block of one size (one collective checks it)."""
    sizes = torch.tensor([state.n], device=state.positions.device)
    sizes = mesh.dcn.all_gather(mesh.ici.all_gather(sizes))
    if int(sizes.min()) != int(sizes.max()):
        raise ValueError(f"N={int(sizes.sum())} must divide by mesh size "
                         f"{mesh.size} (blocks of {sizes.tolist()} rows)")
    u, v = F.pair_features(state, cfg)
    kick = float(F.kick_scale(cfg))

    def accel_fn(positions, st, c):
        return ring_forces_2level(positions, u, v, c, mesh) * kick

    for _ in range(num_steps):
        state = _step(state, cfg, dt, accel_fn=accel_fn)
    return state
