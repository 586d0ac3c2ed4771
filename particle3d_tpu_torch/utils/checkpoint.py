"""Checkpoint and resume (port of ``particle3d_tpu.utils.checkpoint``).

One compressed npz file holds the full state and the config: the JAX
package's layout and ``format_version``, so each package reads the
other's files (species are written as int32, as there).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..config import SimConfig
from ..state import ParticleState, from_numpy

_FORMAT_VERSION = 1


def _config_to_jsonable(cfg: SimConfig) -> dict:
    """The config as JSON values; a tensor field (an attraction matrix
    being learned) is detached and copied to the host first."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, (str, bool, int)):
            out[f.name] = v
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy().tolist()
        else:
            out[f.name] = np.asarray(v).tolist()
    return out


def _config_from_jsonable(d: dict) -> SimConfig:
    kw = dict(d)
    for name in ("attraction_matrix", "colors", "acceleration"):
        if kw.get(name) is not None:
            kw[name] = np.asarray(kw[name], np.float32)
    return SimConfig(**kw)


def save_checkpoint(path: str, state: ParticleState, cfg: SimConfig,
                    step_index: int = 0, extra: dict | None = None) -> None:
    """Write the state (read back from its device) and config to ``path``."""
    def host(t, dtype):
        return t.detach().cpu().numpy().astype(dtype)

    meta = {"format_version": _FORMAT_VERSION, "step_index": int(step_index),
            "config": _config_to_jsonable(cfg), "extra": extra or {}}
    np.savez_compressed(
        path,
        positions=host(state.positions, np.float32),
        velocities=host(state.velocities, np.float32),
        species=host(state.species, np.int32),
        masses=host(state.masses, np.float32),
        accel=host(state.accel, np.float32),
        meta=json.dumps(meta))


def load_checkpoint(path: str, device="cuda"):
    """-> (state on ``device``, config, step_index, extra)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version in {path}")
        state = from_numpy(z["positions"], z["velocities"], z["species"],
                           masses=z["masses"], accel=z["accel"], device=device)
    return (state, _config_from_jsonable(meta["config"]), meta["step_index"],
            meta["extra"])
