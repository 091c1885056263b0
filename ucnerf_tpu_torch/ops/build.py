"""Build and load the port's CUDA kernels (``ucnerf_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, bound with ctypes.  Libraries go into ``ucnerf_tpu_torch/_build/``
(git-ignored) at first use and are rebuilt when their source, or a header it
includes (``HEADERS``), is newer.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
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


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(built < (CSRC / src).stat().st_mtime
               for src in (f"{name}.cu", *HEADERS.get(name, ())))


def build(names=SOURCES, verbose: bool = False) -> float:
    """Compile every stale source, one nvcc process each, all in parallel.

    Returns the wall seconds spent.  With verbose, ptxas reports registers
    and spills for each kernel and the compiler's output is printed.
    Raises RuntimeError with the compiler's output if a build fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}.cu]\n{log.rstrip()}")
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
