"""ctypes binding of the repository's C++ runtime (``native/*.cpp``) and
of the port's own additions to it (``csrc/cell_rows_tick.cpp``,
``csrc/stage_tick.cpp``).

The runtime covers the reference's native sample path and the tracker's
per-cell math: LUT-based 8-bit IQ conversion, a lock-free SPSC byte ring
for the radio->host boundary (``SampleRing``, filled by the live
dongle source's reader thread, ``io/rtlsdr.py``), the producer's per-cell symbol framing
(``ingest.cpp``), and the tracker's RS-window statistics, feedback
chain, CE interpolation, sync SNR, demod and tail-biting Viterbi
(``tracker_math.cpp``), and the device loop's cell tick over that
math (``cell_rows_tick.cpp``, which calls the runtime's ``port_tick``),
and the device loop's host staging of a tick (``stage_tick.cpp``).
The port binds only the entry points it calls.

The port builds its own copy: ``g++`` compiles the sources with the
flags of ``native/Makefile`` into ``build/libingest.so`` beside the
package (never into ``native/``), writing a temporary file and renaming
it into place so that concurrent builds never load a half-written
library.  ``-ffp-contract=off`` (no FMA contraction) keeps the native
numerics rounding exactly like the JAX package's numpy fallbacks, which
are the parity reference.

The port's tracker, its producer and the MIB re-decode's Viterbi
require the runtime (``load``, which raises without ``g++``); the io
layer's callers take ``get_lib`` and keep numpy paths for a library
that does not load.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys
import time
from typing import Optional, Tuple

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
_ROOT = _PKG.parent
SOURCES = (_ROOT / "native" / "ingest.cpp",
           _ROOT / "native" / "tracker_math.cpp",
           _PKG / "csrc" / "cell_rows_tick.cpp",
           _PKG / "csrc" / "stage_tick.cpp")
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libingest.so"
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared",
            "-Wall")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _stale() -> bool:
    return (not LIB_PATH.exists() or LIB_PATH.stat().st_mtime
            < max(p.stat().st_mtime for p in SOURCES))


def build() -> Tuple[float, str]:
    """Compile the runtime into ``LIB_PATH``; returns (seconds, the
    compiler's output).  Raises RuntimeError when the compiler fails or
    is missing."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed:\n{proc.stdout}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0, proc.stdout


def ensure_built(quiet: bool = True, force: bool = False) -> bool:
    """Build the runtime when it is missing or older than its sources
    (always with ``force``); returns whether a current library is there,
    False when the build fails.  The compiler's output goes to stderr
    unless ``quiet``."""
    if not force and not _stale():
        return True
    try:
        _seconds, out = build()
    except RuntimeError as e:
        if not quiet:
            print(e, file=sys.stderr)
        return False
    if not quiet and out:
        print(out, file=sys.stderr)
    return True


def _bind(lib: ctypes.CDLL) -> None:
    """Declare prototypes; raises AttributeError on a stale library."""
    lib.iq_u8_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_uint64]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("ring_size", "ring_free"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("ring_push", "ring_pop"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64]
    lib.ring_drop.restype = ctypes.c_uint64
    lib.ring_drop.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.viterbi_tailbite.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_void_p]
    lib.cell_tick.restype = ctypes.c_int64
    lib.cell_tick.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.cell_rows_tick.restype = ctypes.c_int64
    lib.cell_rows_tick.argtypes = (
        [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        + [ctypes.c_void_p] * 6
        + [ctypes.c_int64] * 3 + [ctypes.c_double] * 4 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 16 + [ctypes.c_int64] + [ctypes.c_void_p] * 4)
    lib.stage_tick_inputs.restype = ctypes.c_int64
    lib.stage_tick_inputs.argtypes = (
        [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
    lib.stage_tick_plan.restype = ctypes.c_int64
    lib.stage_tick_plan.argtypes = (
        [ctypes.c_int64] * 2 + [ctypes.c_void_p, ctypes.c_int64]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p])
    lib.get_fd_batch.restype = ctypes.c_double
    lib.get_fd_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    lib.sync_snr.argtypes = [ctypes.c_void_p] * 6
    # per-cell symbol framing with each symbol's start in the block
    lib.cell_frame_symbols2.restype = ctypes.c_int64
    lib.cell_frame_symbols2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _open() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(LIB_PATH))
    _bind(lib)
    return lib


def load() -> ctypes.CDLL:
    """The runtime, built first if missing or older than its sources;
    raises RuntimeError (compiler) or OSError/AttributeError (a library
    that does not load or bind even after a rebuild)."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    _tried = True
    if _stale():
        build()
    try:
        lib = _open()
    except (OSError, AttributeError):
        build()
        lib = _open()
    _lib = lib
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The runtime, or None when it cannot be built or loaded (the io
    layer's callers then take their numpy paths).  A failure is not
    retried within the process."""
    if _lib is not None or _tried:
        return _lib
    try:
        return load()
    except (RuntimeError, OSError, AttributeError):
        return None


class SampleRing:
    """SPSC byte ring over raw IQ (reference sampbuf_sync_t role): push
    returns the bytes accepted (a full ring drops the rest), pop up to
    ``n`` bytes."""

    def __init__(self, capacity_bytes: int = 1 << 24):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._h = self._lib.ring_create(capacity_bytes)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None

    def size(self) -> int:
        return self._lib.ring_size(self._h)

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        return self._lib.ring_push(self._h, data.ctypes.data, data.size)

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint8)
        got = self._lib.ring_pop(self._h, out.ctypes.data, n)
        return out[:got]

    def drop(self, n: int) -> int:
        return self._lib.ring_drop(self._h, n)


def iq_u8_to_c64(raw: np.ndarray) -> np.ndarray:
    """u8 interleaved IQ -> complex64 on the (x-127)/128 grid."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    lib = get_lib()
    if lib is None:
        f = (raw.astype(np.float32) - 127.0) / 128.0
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    out = np.empty(raw.size, dtype=np.float32)
    lib.iq_u8_to_f32(raw.ctypes.data, out.ctypes.data, raw.size)
    return out.view(np.complex64)[: raw.size // 2].copy()
