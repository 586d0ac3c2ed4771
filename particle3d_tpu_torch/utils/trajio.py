"""Streaming trajectory record and replay (port of
``particle3d_tpu.utils.trajio``, the same ``P3TRAJ01`` format, so either
package reads the other's files).

A JSON header, the per-particle constants once (species), then raw float32
position frames appended one after another (12 N bytes a frame), read back
without a copy through ``numpy.memmap``:

    P3TRAJ01 | u32 header_len | header JSON | species i32[N] | frames f32[N,3]...

CLI: ``python -m particle3d_tpu_torch run --record traj.p3t
--snapshot-every 4`` then ``python -m particle3d_tpu_torch replay --traj
traj.p3t --gif out.gif``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_MAGIC = b"P3TRAJ01"


def _host(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype)


class TrajectoryWriter:
    """Appends position frames (tensors on any device, or arrays); ``meta``
    should carry the config (``checkpoint._config_to_jsonable``) so that a
    replay describes itself."""

    def __init__(self, path: str, n: int, species, meta: dict | None = None):
        self.path = path
        self.n = int(n)
        self.frames = 0
        sp = _host(species, np.int32)
        if sp.shape != (self.n,):
            raise ValueError(f"species must be [{self.n}], got {sp.shape}")
        header = json.dumps({"n": self.n, "meta": meta or {}}).encode()
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<I", len(header)))
        self._f.write(header)
        self._f.write(sp.tobytes())

    def append(self, positions) -> None:
        pos = _host(positions, np.float32)
        if pos.shape != (self.n, 3):
            raise ValueError(f"frame must be [{self.n}, 3], got {pos.shape}")
        self._f.write(pos.tobytes())
        self.frames += 1

    def append_batch(self, frames) -> None:
        """frames f32[K, N, 3]: one write for a whole snapshot batch."""
        arr = _host(frames, np.float32)
        if arr.ndim != 3 or arr.shape[1:] != (self.n, 3):
            raise ValueError(f"batch must be [K, {self.n}, 3], got {arr.shape}")
        self._f.write(arr.tobytes())
        self.frames += arr.shape[0]

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrajectoryReader:
    """Random access to recorded frames (numpy memmap, no copy)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise ValueError(f"{path} is not a p3t trajectory")
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen))
        self.n = int(header["n"])
        self.meta = header.get("meta", {})
        species_off = 12 + hlen
        data_off = species_off + 4 * self.n
        self.frames = (os.path.getsize(path) - data_off) // (12 * self.n)
        self.species = np.memmap(path, np.int32, "r", species_off, (self.n,))
        self._pos = np.memmap(path, np.float32, "r", data_off,
                              (self.frames, self.n, 3))

    def __len__(self) -> int:
        return self.frames

    def __getitem__(self, i):
        return self._pos[i]

    def positions(self):
        """All frames as one memmapped array f32[frames, N, 3]."""
        return self._pos
