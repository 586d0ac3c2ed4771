"""Step-indexed checkpoint directory with async saves and slab carries
written rank by rank (counterpart of ``particle3d_tpu.utils.orbax_ckpt``,
written on ``torch.save``; Orbax is not used).

Layout, as the JAX module's: ``<dir>/<step:010d>/meta.json`` (the config,
the step index and, for a slab carry, its geometry and global shapes, with
the JAX module's keys, plus ``ranks``, the number of writing ranks) and
``<dir>/<step:010d>/state/``, which holds one file per writing rank,
``rank_<r:05d>.pt``. A state snapshot is written by one process. A
stay-sharded slab carry (``parallel.domain_sharded``) is written by every
rank of the mesh, each only its own rows, and restored the same way: each
rank reads only its own file, with no replicated stage. A save over a step
that more ranks wrote before replaces it, as the JAX module's
``force=True`` does: rank 0 removes the files of the ranks beyond this
save's count before it writes ``meta.json``.
The files are not Orbax's, and this module reads no Orbax files.

With ``async_save=True`` a save copies the tensors to the host before it
returns and writes the files on a background thread; the next save, or
``wait()``, joins it. Files are written under a temporary name and renamed,
and rank 0 writes ``meta.json`` after its own file, so ``steps()`` never
lists a checkpoint whose rank-0 file is still being written;
``restore_carry`` synchronises the ranks before it reads.

>>> ck = OrbaxCheckpointer(dir, async_save=True)
>>> ck.save(step, state, cfg)        # returns once the host copy is taken
>>> state, cfg, step = ck.restore()  # latest state snapshot, on the card
"""

from __future__ import annotations

import json
import os
import re
import threading

import torch

from ..config import SimConfig
from ..state import ParticleState, resolve_device
from .checkpoint import _config_from_jsonable, _config_to_jsonable

_FORMAT_VERSION = 1
_STATE_FIELDS = ("positions", "velocities", "species", "masses", "accel")
_CARRY_FIELDS = ("data", "pid", "limbo_data", "limbo_pid")


def _rank_file(step_dir: str, rank: int) -> str:
    return os.path.join(step_dir, "state", f"rank_{rank:05d}.pt")


def _drop_stale_ranks(step_dir: str, size: int) -> None:
    """Remove the files of ranks >= ``size`` that an earlier save of this
    step by more ranks left."""
    state = os.path.join(step_dir, "state")
    for name in os.listdir(state):
        m = re.fullmatch(r"rank_(\d+)\.pt", name)
        if m and int(m.group(1)) >= size:
            os.remove(os.path.join(state, name))


def _write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _write_tensors(path: str, tensors: dict) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tensors, tmp)
    os.replace(tmp, path)


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of the dtype ("float32"), as the JAX module writes it."""
    return str(t.dtype).removeprefix("torch.")


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later writes to ``t`` cannot reach."""
    return t.detach().to("cpu", copy=True)


class OrbaxCheckpointer:
    """Step-indexed checkpoint directory with optional async saves."""

    def __init__(self, directory: str, *, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- write ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step):010d}")

    def _submit(self, writes) -> None:
        """Run the file writes ``writes()`` now, or on a background thread
        once the previous one has finished."""
        self.wait()
        if not self.async_save:
            writes()
            return

        def run():
            try:
                writes()
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def save(self, step: int, state: ParticleState, cfg: SimConfig,
             extra: dict | None = None) -> str:
        """Save a state snapshot (one writer)."""
        step_dir = self._step_dir(step)
        os.makedirs(os.path.join(step_dir, "state"), exist_ok=True)
        meta = {"format_version": _FORMAT_VERSION, "step_index": int(step),
                "config": _config_to_jsonable(cfg), "extra": extra or {},
                "ranks": 1}
        host = {k: _host_copy(getattr(state, k)) for k in _STATE_FIELDS}

        def writes():
            _write_tensors(_rank_file(step_dir, 0), host)
            _drop_stale_ranks(step_dir, 1)
            _write_json(os.path.join(step_dir, "meta.json"), meta)

        self._submit(writes)
        return step_dir

    def save_carry(self, step: int, carry, cfg: SimConfig, *, nsc: int,
                   cap: int, n: int, mesh=None, extra: dict | None = None) -> str:
        """Save this rank's stay-sharded slab carry ``(data, pid,
        limbo_data, limbo_pid, lost)`` plus the slab geometry needed to
        resume (``sharded_dense_steps`` takes nsc/cap/n). Every rank of
        ``mesh`` (None: one rank) calls it; each writes only its own rows,
        and rank 0 also writes ``lost`` (replicated), removes the files an
        earlier save of this step by more ranks left, and writes
        ``meta.json`` with the rank count.
        ``shapes`` in the meta holds the global shapes (rows summed over
        the ranks), as the JAX module's does."""
        size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
        step_dir = self._step_dir(step)
        os.makedirs(os.path.join(step_dir, "state"), exist_ok=True)
        own = dict(zip(_CARRY_FIELDS, carry[:4]))
        lost = carry[4]
        rows = torch.tensor([t.shape[0] for t in own.values()],
                            device=own["pid"].device)
        if size > 1:  # the global row counts
            rows = mesh.psum(rows)
        shapes = {k: [[int(r)] + list(t.shape[1:]), _dtype_name(t)]
                  for (k, t), r in zip(own.items(), rows.tolist())}
        shapes["lost"] = [list(lost.shape), _dtype_name(lost)]
        meta = {"format_version": _FORMAT_VERSION, "kind": "slab_carry",
                "step_index": int(step), "config": _config_to_jsonable(cfg),
                "slab": {"nsc": int(nsc), "cap": int(cap), "n": int(n)},
                "shapes": shapes, "extra": extra or {}, "ranks": size}
        host = {k: _host_copy(t) for k, t in own.items()}
        if rank == 0:
            host["lost"] = _host_copy(lost)

        def writes():
            _write_tensors(_rank_file(step_dir, rank), host)
            if rank == 0:
                _drop_stale_ranks(step_dir, size)
                _write_json(os.path.join(step_dir, "meta.json"), meta)

        self._submit(writes)
        return step_dir

    def wait(self) -> None:
        """Block until the save in flight (if any) has written its files;
        re-raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- read ----------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            p = os.path.join(self.directory, name, "meta.json")
            if name.isdigit() and os.path.exists(p):
                out.append(int(name))
        return sorted(out)

    def _latest_step(self, carry: bool) -> int:
        """Latest step of the requested kind: a directory may hold both
        state snapshots and slab carries, and the newest of the other kind
        must not shadow the one asked for."""
        all_steps = self.steps()
        for step in reversed(all_steps):
            with open(os.path.join(self._step_dir(step), "meta.json")) as f:
                kind = json.load(f).get("kind")
            if (kind == "slab_carry") == carry:
                return step
        what = "slab carries" if carry else "state snapshots"
        raise FileNotFoundError(
            f"no {what} under {self.directory}"
            + (f" ({len(all_steps)} checkpoints of the other kind)"
               if all_steps else ""))

    def _meta(self, step: int, carry: bool):
        step_dir = self._step_dir(step)
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported orbax checkpoint version in {step_dir}")
        if carry and meta.get("kind") != "slab_carry":
            raise ValueError(f"checkpoint at step {step} is a state "
                             f"snapshot, not a slab carry — use restore()")
        if not carry and meta.get("kind") == "slab_carry":
            raise ValueError(f"checkpoint at step {step} is a stay-sharded "
                             f"slab carry — use restore_carry(mesh)")
        return step_dir, meta

    def restore(self, step: int | None = None, device="cuda"):
        """-> (state on ``device``, config, step_index)."""
        self.wait()
        if step is None:
            step = self._latest_step(carry=False)
        step_dir, meta = self._meta(step, carry=False)
        device = resolve_device(device)
        tree = torch.load(_rank_file(step_dir, 0), map_location="cpu",
                          weights_only=True)
        state = ParticleState(*(tree[k].to(device) for k in _STATE_FIELDS))
        return state, _config_from_jsonable(meta["config"]), meta["step_index"]

    def restore_carry(self, mesh=None, step: int | None = None):
        """-> (carry, config, slab geometry, step_index) of this rank of
        ``mesh`` (None: a one-rank mesh on the card), read from this
        rank's file alone, on the mesh's device. The mesh must have as many
        ranks as wrote the carry (``meta.json``'s ``ranks``; a carry whose
        meta lacks it is refused). ``lost`` is read by rank 0 and summed
        over the mesh, so every rank holds it."""
        from ..parallel.mesh import make_mesh

        self.wait()
        if mesh is None:
            mesh = make_mesh(1)
        if mesh.size > 1:  # every rank's save has finished before any reads
            mesh.psum(torch.zeros(1, device=mesh.device))
        if step is None:
            step = self._latest_step(carry=True)
        step_dir, meta = self._meta(step, carry=True)
        written = meta.get("ranks")
        if written is None:
            raise ValueError(
                f"slab carry at step {step} has no rank count in its "
                f"meta.json (an older checkpoint format); save it again")
        if written != mesh.size:
            raise ValueError(
                f"slab carry at step {step} was written by {written} "
                f"rank(s); it restores only onto a mesh of that size, not "
                f"{mesh.size} (each rank reads only its own rows)")
        tree = torch.load(_rank_file(step_dir, mesh.rank), map_location="cpu",
                          weights_only=True)
        own = [tree[k].to(mesh.device) for k in _CARRY_FIELDS]
        lost_shape, lost_dtype = meta["shapes"]["lost"]
        lost = (tree["lost"].to(mesh.device) if mesh.rank == 0 else
                torch.zeros(lost_shape, dtype=getattr(torch, lost_dtype),
                            device=mesh.device))
        carry = (*own, mesh.psum(lost))
        return (carry, _config_from_jsonable(meta["config"]), meta["slab"],
                meta["step_index"])

    def close(self) -> None:
        self.wait()
