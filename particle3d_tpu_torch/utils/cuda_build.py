"""Build-at-first-use loader for the port's CUDA C++ kernels.

Each kernel library is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The library
is keyed on a hash of its sources and flags, lives in ``build/kernels/``
at the repository root (listed in ``.gitignore``), and is built the first
time a kernel is launched, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile (once per source hash) and load ``lib<name>``. ``sources``
    name files under ``csrc/``; the first is the translation unit, the
    rest are headers it includes."""
    out = library_path(name, sources)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / sources[0])]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
               f"[{time.perf_counter() - t0:.2f} s, exit {proc.returncode}]\n")
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {name}:\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return ctypes.CDLL(str(out))


def build_log(name: str, sources: tuple[str, ...]) -> str:
    """nvcc's output (registers, shared memory, spills) for the current
    build of ``lib<name>``, or '' when it was built elsewhere."""
    log = library_path(name, sources).with_suffix(".log")
    return log.read_text() if log.exists() else ""
