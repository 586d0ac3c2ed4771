"""ctypes binding of the framework-free C++ reference engine
``native/oracle.cpp`` (the port's own counterpart of
``particle3d_tpu.native``): ``native_step`` and ``native_simulate`` on host
arrays, taking the port's ``SimConfig``.

The library is built with ``g++`` (``$CXX`` when set) from the
repository's source into ``build/native/`` (listed in ``.gitignore``),
keyed on a hash of the compiler, flags and source, the first time it is
loaded; a failed build raises. It is built without OpenMP, whose runtime
not every toolchain ships: the engine's parallel loop computes one
independent force sum a particle, so one thread gives the same arrays as
the JAX package's OpenMP build. It is the reference-exact trajectory the
card's trajectories are held against (``chip_smoke.py`` phase 27,
``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .config import SimConfig

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "native" / "oracle.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]
ABI_VERSION = 1


class NativeUnavailable(RuntimeError):
    pass


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join([_compiler(), *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liboracle-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise NativeUnavailable(f"native build failed: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeUnavailable(f"native build failed: {' '.join(cmd)}\n"
                                f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file


@functools.lru_cache(maxsize=None)
def load():
    """Load (building it first if needed) the native library; raises
    NativeUnavailable when it cannot be built or its ABI differs."""
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    common = [
        f32p, f32p, u32p, ctypes.c_int64,  # pos, vel, species, n
        ctypes.c_float, ctypes.c_int32, f32p,  # world, id_count, attraction
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, f32p, ctypes.c_float, ctypes.c_int32,
    ]
    lib.p3d_step.argtypes = common
    lib.p3d_step.restype = None
    lib.p3d_simulate.argtypes = common + [ctypes.c_int64]
    lib.p3d_simulate.restype = None
    lib.p3d_abi_version.restype = ctypes.c_int32
    if lib.p3d_abi_version() != ABI_VERSION:
        raise NativeUnavailable(f"native ABI version mismatch in {out}")
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def native_simulate(positions, velocities, species, cfg: SimConfig, dt: float,
                    steps: int, use_hash: bool = True):
    """Run reference-exact steps in native code on host arrays; returns
    (pos, vel) copies."""
    if cfg.force_law != "particle_life":
        raise ValueError("native engine implements the particle_life law only")
    lib = load()
    pos = np.array(positions, np.float32, order="C")
    vel = np.array(velocities, np.float32, order="C")
    spec = np.ascontiguousarray(species, np.uint32)
    attr = np.ascontiguousarray(cfg.attraction_matrix, np.float32)
    accel = np.ascontiguousarray(cfg.acceleration, np.float32)
    n = pos.shape[0]
    if (pos.shape != (n, 3) or vel.shape != (n, 3) or spec.shape != (n,)
            or attr.shape != (cfg.id_count, cfg.id_count)
            or accel.shape != (3,)):
        raise ValueError(f"native_simulate: positions {pos.shape}, "
                         f"velocities {vel.shape}, species {spec.shape}, "
                         f"attraction {attr.shape}: want [N, 3], [N, 3], [N], "
                         f"[K, K]")
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.p3d_simulate(
        pos.ctypes.data_as(f32p), vel.ctypes.data_as(f32p),
        spec.ctypes.data_as(u32p), n,
        float(np.asarray(cfg.world_size)), cfg.id_count,
        attr.ctypes.data_as(f32p),
        float(np.asarray(cfg.coefficient)),
        float(np.asarray(cfg.interaction_force)),
        float(np.asarray(cfg.min_pull_ratio)),
        float(np.asarray(cfg.particle_effect_radius)),
        1 if cfg.boundary == "clamp" else 0,
        accel.ctypes.data_as(f32p), float(dt), 1 if use_hash else 0,
        int(steps),
    )
    return pos, vel


def native_step(positions, velocities, species, cfg: SimConfig, dt: float,
                use_hash: bool = True):
    return native_simulate(positions, velocities, species, cfg, dt, 1, use_hash)
