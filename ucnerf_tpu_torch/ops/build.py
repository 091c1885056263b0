"""Build and load the port's native libraries (``ucnerf_tpu_torch/csrc/``).

Two routes, each a shared library with a plain C interface bound with
ctypes:
- the CUDA kernels (``*.cu``, ``SOURCES``) compile with ``nvcc`` for
  ``sm_90a``;
- the host C++ sources (``*.cc``, ``HOST_SOURCES``: the rig bundle adjuster
  of ``pose/rigba``) compile with ``g++`` and need no CUDA toolkit.
Libraries go into ``ucnerf_tpu_torch/_build/`` (git-ignored) at first use and
are rebuilt when their source, or a header it includes (``HEADERS``), is
newer.  Nothing here runs at import time: the CPU tests import every module
on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("gather", "scatter", "scatter_chunked")
# The headers of csrc/ that each source includes.
HEADERS = {"scatter": ("scatter_common.cuh",),
           "scatter_chunked": ("scatter_common.cuh",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_SOURCES = ("rigba",)
# The JAX package's flags for the same source (ucnerf_tpu/pose/rigba).
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _source(name: str) -> str:
    return f"{name}.cc" if name in HOST_SOURCES else f"{name}.cu"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(built < (CSRC / src).stat().st_mtime
               for src in (_source(name), *HEADERS.get(name, ())))


def _command(name: str, out: Path, verbose: bool):
    src = str(CSRC / _source(name))
    if name in HOST_SOURCES:
        return ["g++", *GXX_FLAGS, src, "-o", str(out)]
    return [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
            "-o", str(out), src]


def build(names=SOURCES, verbose: bool = False) -> float:
    """Compile every stale source, one compiler process each, all in
    parallel.

    Returns the wall seconds spent.  With verbose, ptxas reports registers
    and spills for each kernel and the compiler's output is printed.
    Raises RuntimeError with the compiler's output if a build fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        procs.append((name, tmp, subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"building {_source(name)} failed "
                          f"({proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"[build {_source(name)}]\n{log.rstrip()}")
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library `name` (a CUDA kernel library or a host
    C++ one), built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
