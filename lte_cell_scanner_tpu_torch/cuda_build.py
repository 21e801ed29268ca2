"""Build and load the port's CUDA kernels.

Each ``.cu`` source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) in ``build/`` beside this file, at first use, and loaded
with ctypes.  Both sources include ``csrc/hankel_mma.cuh``, the
tensor-core correlation they share.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Tuple

_PKG = pathlib.Path(__file__).resolve().parent
SOURCES = {"pss_corr": _PKG / "csrc" / "pss_corr.cu",
           "pss_corr_fold": _PKG / "csrc" / "pss_corr_fold.cu"}
BUILD_DIR = _PKG / "build"

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(pathlib.Path(home) / "bin" / "nvcc")


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    header beside it (csrc/*.cuh)."""
    lib = library_path(name)
    inputs = [SOURCES[name], *SOURCES[name].parent.glob("*.cuh")]
    return (not lib.exists()
            or lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs))


def build(name: str) -> Tuple[float, str]:
    """Compile the named source; returns (seconds, nvcc's output, which
    includes ptxas' register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCES[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name].name}:\n{proc.stdout}")
    os.replace(tmp, library_path(name))
    return time.perf_counter() - t0, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if missing or stale."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
