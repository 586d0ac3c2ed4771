"""The port's CUDA sources built for the CPU and called in a child process:
the helper of the emulated-kernel tests.

``build(tmp, sources)`` compiles each ``csrc`` translation unit with g++
against ``_cuda_emulation/cuda_runtime.h`` (each ``<<<grid, block, 0,
stream>>>`` launch rewritten into a call of its ``emu_launch``), all at
once; it returns None when no g++ with C++20's ``<barrier>`` is
installed. ``Emulated`` loads the libraries in one spawned child and calls
their C entry points there on numpy arrays.

Why a child: the emulation runs every block's threads as std::threads,
and the caller's process, where the plain versions run, should hold no
state from them. The child imports numpy and ctypes only. Before it is
spawned, the caller runs one parallel torch op (``start_torch_threads``):
a process's first parallel torch op after it had spawned a child (or run
the emulation's threads) before torch's thread pool existed has been seen
to return wrong ``torch.sqrt`` values on one worker thread's share of the
elements (sqrt(1) = 1 - 2^-12, in 2 of 8 runs on an AVX-512 CPU) — the
plain versions' occasional non-reproducibility in the test suite.
"""

from __future__ import annotations

import ctypes
import multiprocessing
import re
import shutil
import subprocess
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

EMULATION = Path(__file__).parent / "_cuda_emulation"
CSRC = Path(__file__).parents[1] / "particle3d_tpu_torch" / "csrc"
CALL_TIMEOUT_S = 300.0

_LAUNCH = re.compile(r"(\w+_kernel<[^>]*>)<<<(\w+), (\w+), 0, stream>>>\(")


def build(tmp: Path, sources: dict[str, int]):
    """{name: path of lib<name>.so} for each ``csrc/<name>.cu`` (with its
    expected number of kernel launches), or None without a C++20 g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    (tmp / "probe.cpp").write_text("#include <barrier>\nint main() { "
                                   "std::barrier<> b(1); b.arrive_and_wait(); }\n")
    probe = subprocess.run([gxx, "-std=c++20", "-pthread", "-o",
                            str(tmp / "probe"), str(tmp / "probe.cpp")],
                           capture_output=True, text=True)
    if probe.returncode != 0:
        return None
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, tmp)
    procs = {}
    for name, launches in sources.items():
        src, n = _LAUNCH.subn(r"emu_launch(\2, \3, \1, ",
                              (CSRC / f"{name}.cu").read_text())
        assert n == launches, f"{name}: {n} kernel launches rewritten"
        (tmp / f"{name}.cpp").write_text(src)
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
             "-ffp-contract=off", f"-I{EMULATION}", "-o", str(tmp / f"{name}.so"),
             str(tmp / f"{name}.cpp")], stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, f"{name} failed to build:\n{err[-3000:]}"
    return {name: tmp / f"{name}.so" for name in sources}


_LIBS: dict[str, ctypes.CDLL] = {}


def _call(lib: str, fn: str, sig: str, restype: str | None, args, outs):
    """In the child: ``fn`` of ``lib`` on ``args`` (numpy arrays and None
    pass as pointers, ints as ints; ``sig`` one letter each, "p" or "i");
    returns its result and the arrays at positions ``outs``."""
    if lib not in _LIBS:
        _LIBS[lib] = ctypes.CDLL(lib)
    f = getattr(_LIBS[lib], fn)
    f.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int for c in sig]
    f.restype = None if restype is None else ctypes.c_int
    args = [np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a
            for a in args]
    rc = f(*(a.ctypes.data if isinstance(a, np.ndarray) else a for a in args))
    return rc, [args[i] for i in outs]


def start_torch_threads():
    """One parallel torch op, so that torch's thread pool exists before the
    caller spawns a process (see the module docstring); its result is
    discarded."""
    import torch

    torch.sqrt(torch.ones(1 << 22))


class Emulated:
    """One spawned child that holds the emulated libraries."""

    def __init__(self):
        start_torch_threads()
        self._pool = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))

    def call(self, lib, fn: str, sig: str, args, outs=(), restype="i"):
        return self._pool.submit(_call, str(lib), fn, sig, restype, list(args),
                                 tuple(outs)).result(timeout=CALL_TIMEOUT_S)

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
