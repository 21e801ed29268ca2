"""Live RTL-SDR capture source: a ctypes librtlsdr binding.

Behavioral contract: the reference's USB configuration and capture flow
-- config_usb (reference src/CellSearch.cpp:344-433: device-index
selection, sample rate round(1920000*correction), fs_programmed read
back, AGC gain mode, buffer reset, ~1.5 s AGC-settle discard) and
capture_data's live path (reference src/capbuf.cpp:117-186:
set_center_freq(round(fc_requested*correction)) with up to 5 retries,
E4000 PLL model (+58 Hz fudge) for the true programmed frequency,
(x-127)/128 unit scaling of the 8-bit IQ stream).

The binding is dependency-injected: ``RtlSdrSource(lib=...)`` accepts
any object with the librtlsdr function surface, so tests drive the
retry/settle/correction semantics against a fake without hardware, and
environments without the shared library fail with a clear message at
construction time only.

Streaming ingestion is ASYNCHRONOUS like the reference's
rtlsdr_read_async callback thread (capbuf.cpp:41-71, the tracker's
pre-producer loop LTE-Tracker.cpp:743-763,870): ``stream()`` spawns a
reader thread that drains the dongle into the native lock-free SPSC
byte ring (native/ingest.cpp) continuously, so a slow tracker tick or a
GC pause never stalls the USB endpoint; ring overflow drops whole
blocks and COUNTS them (``dropped_bytes``/``dropped_seconds()``,
surfaced on the dashboard like the reference's dropped-seconds row,
display_thread.cpp:538-541).  ``capture()`` remains a one-shot
synchronous 80 ms read.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from ..constants import CAPLENGTH
from ..utils.rtl import iq_u8_to_complex
from .capture import CaptureSource
from .e4000 import fc_programmed_with_fudge

RTLSDR_TUNER_E4000 = 1  # enum rtlsdr_tuner (librtlsdr.h)

_AGC_SETTLE_BYTES = 2880000 * 2   # ~1.5 s at 1.92 Msps (CellSearch.cpp:431)
_SETTLE_BLOCK = 16 * 16384


def load_librtlsdr():
    """Load the librtlsdr shared library, or raise RuntimeError."""
    name = ctypes.util.find_library("rtlsdr")
    candidates = [name] if name else []
    candidates += ["librtlsdr.so.0", "librtlsdr.so", "librtlsdr.dylib"]
    for cand in candidates:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        _declare(lib)
        return lib
    raise RuntimeError(
        "librtlsdr not found -- live capture needs the rtl-sdr runtime "
        "(use --load/--sim for recorded/synthetic sources)")


def _declare(lib):
    """Declare the argument/return types actually used."""
    u32, i32, p = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
    lib.rtlsdr_get_device_count.restype = u32
    lib.rtlsdr_get_device_name.restype = ctypes.c_char_p
    lib.rtlsdr_get_device_name.argtypes = [u32]
    lib.rtlsdr_open.restype = i32
    lib.rtlsdr_open.argtypes = [ctypes.POINTER(p), u32]
    lib.rtlsdr_close.argtypes = [p]
    lib.rtlsdr_set_sample_rate.restype = i32
    lib.rtlsdr_set_sample_rate.argtypes = [p, u32]
    lib.rtlsdr_get_sample_rate.restype = u32
    lib.rtlsdr_get_sample_rate.argtypes = [p]
    lib.rtlsdr_set_center_freq.restype = i32
    lib.rtlsdr_set_center_freq.argtypes = [p, u32]
    lib.rtlsdr_get_tuner_type.restype = i32
    lib.rtlsdr_get_tuner_type.argtypes = [p]
    lib.rtlsdr_set_tuner_gain_mode.restype = i32
    lib.rtlsdr_set_tuner_gain_mode.argtypes = [p, i32]
    lib.rtlsdr_reset_buffer.restype = i32
    lib.rtlsdr_reset_buffer.argtypes = [p]
    lib.rtlsdr_read_sync.restype = i32
    lib.rtlsdr_read_sync.argtypes = [p, ctypes.c_char_p, i32,
                                     ctypes.POINTER(i32)]


class _PyRing:
    """Bounded locked byte ring -- fallback when the native SPSC ring
    (native/ingest.cpp) is unavailable.  Same drop-on-overflow contract:
    push returns the number of bytes accepted."""

    def __init__(self, capacity_bytes: int):
        self._buf = np.empty(capacity_bytes, dtype=np.uint8)
        self._cap = capacity_bytes
        self._lock = threading.Lock()
        self._head = 0      # write position (monotonic)
        self._tail = 0      # read position

    def size(self) -> int:
        with self._lock:
            return self._head - self._tail

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        with self._lock:
            space = self._cap - (self._head - self._tail)
            n = min(int(space), data.size)
            pos = self._head % self._cap
            first = min(n, self._cap - pos)
            self._buf[pos: pos + first] = data[:first]
            self._buf[: n - first] = data[first:n]
            self._head += n
            return n

    def pop(self, n: int) -> np.ndarray:
        with self._lock:
            avail = self._head - self._tail
            n = min(int(avail), n)
            pos = self._tail % self._cap
            first = min(n, self._cap - pos)
            out = np.empty(n, dtype=np.uint8)
            out[:first] = self._buf[pos: pos + first]
            out[first:] = self._buf[: n - first]
            self._tail += n
            return out


class _AsyncReader:
    """USB reader thread feeding the sample ring -- the reference's
    rtlsdr_read_async callback filling sampbuf_sync.fifo
    (capbuf.cpp:41-71; LTE-Tracker.cpp:743-763).  A full ring drops the
    whole incoming block (counted), never blocks the USB side."""

    def __init__(self, read_exact, ring, block_bytes: int = 16 * 16384):
        self._read = read_exact
        self.ring = ring
        self.block_bytes = block_bytes
        self.dropped_bytes = 0
        self.overruns = 0
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rtlsdr-reader")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                raw = self._read(self.block_bytes)
            except BaseException as e:  # device lost: surface to consumer
                self.error = e
                return
            arr = np.frombuffer(raw, dtype=np.uint8)
            pushed = self.ring.push(arr)
            if pushed < arr.size:
                self.dropped_bytes += arr.size - pushed
                self.overruns += 1

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class RtlSdrSource(CaptureSource):
    """80 ms captures / continuous blocks from a live RTL2832 dongle."""

    def __init__(self, device_index: int = 0, correction: float = 1.0,
                 sample_rate: float = 1920000.0, lib=None,
                 sleep=time.sleep, agc_settle: bool = True):
        self._lib = lib if lib is not None else load_librtlsdr()
        self._sleep = sleep
        self.correction = correction
        self.device_index = max(0, device_index)

        n = self._lib.rtlsdr_get_device_count()
        if n == 0:
            raise RuntimeError("no RTL-SDR devices found")
        if self.device_index >= n:
            raise RuntimeError(
                f"device index {self.device_index} out of range "
                f"({n} device(s) present)")
        self.device_name = self._name(self.device_index)

        dev = ctypes.c_void_p()
        if self._lib.rtlsdr_open(ctypes.byref(dev), self.device_index) < 0:
            raise RuntimeError("unable to open RTL-SDR device")
        self._dev = dev

        # sample rate carries the correction factor too
        # (CellSearch.cpp:380) and the actually-programmed rate is read
        # back as fs_programmed (:385)
        if self._lib.rtlsdr_set_sample_rate(
                self._dev, int(round(sample_rate * correction))) < 0:
            raise RuntimeError("unable to set sampling rate")
        self.fs_programmed = float(
            self._lib.rtlsdr_get_sample_rate(self._dev))

        if self._lib.rtlsdr_set_tuner_gain_mode(self._dev, 0) < 0:
            raise RuntimeError("unable to enter AGC mode")
        if self._lib.rtlsdr_reset_buffer(self._dev) < 0:
            raise RuntimeError("unable to reset RTLSDR buffer")
        if agc_settle:
            self._discard(_AGC_SETTLE_BYTES)

    def _name(self, idx: int) -> str:
        try:
            raw = self._lib.rtlsdr_get_device_name(idx)
            return raw.decode() if isinstance(raw, bytes) else str(raw)
        except Exception:
            return "unknown"

    # -- low-level helpers --------------------------------------------------

    def _read_exact(self, n_bytes: int) -> bytes:
        buf = ctypes.create_string_buffer(n_bytes)
        n_read = ctypes.c_int(0)
        got = 0
        while got < n_bytes:
            chunk = ctypes.cast(ctypes.addressof(buf) + got,
                                ctypes.c_char_p)
            if self._lib.rtlsdr_read_sync(self._dev, chunk, n_bytes - got,
                                          ctypes.byref(n_read)) < 0:
                raise RuntimeError("synchronous read failed")
            if n_read.value <= 0:
                raise RuntimeError("short read; samples lost")
            got += n_read.value
        return buf.raw

    def _discard(self, n_bytes: int) -> None:
        """AGC settle: read and drop ~1.5 s (CellSearch.cpp:414-432)."""
        done = 0
        while done < n_bytes:
            self._read_exact(_SETTLE_BLOCK)
            done += _SETTLE_BLOCK

    def tune(self, fc_requested: float) -> float:
        """set_center_freq(round(fc*correction)) with up to 5 attempts,
        1 s apart (capbuf.cpp:122-131); returns fc_programmed from the
        E4000 PLL model (+58 Hz) or fc_requested for other tuners
        (capbuf.cpp:134-149)."""
        target = int(round(fc_requested * self.correction))
        n_fail = 0
        while self._lib.rtlsdr_set_center_freq(self._dev, target) < 0:
            n_fail += 1
            if n_fail >= 5:
                raise RuntimeError("unable to set center frequency")
            self._sleep(1)
        if self._lib.rtlsdr_get_tuner_type(self._dev) == RTLSDR_TUNER_E4000:
            return fc_programmed_with_fudge(fc_requested)
        return float(fc_requested)

    # -- CaptureSource interface --------------------------------------------

    def capture(self, fc_requested: float) -> Tuple[np.ndarray, float]:
        fc_programmed = self.tune(fc_requested)
        if self._lib.rtlsdr_reset_buffer(self._dev) < 0:
            raise RuntimeError("unable to reset RTLSDR buffer")
        raw = self._read_exact(CAPLENGTH * 2)
        return iq_u8_to_complex(np.frombuffer(raw, dtype=np.uint8)), fc_programmed

    def _make_ring(self, capacity_bytes: int):
        """The native SPSC ring (native/ingest.cpp) when its runtime
        loads, else the locked Python ring.  A native runtime that loads
        but fails to make a ring is an error, not a fallback."""
        from . import native
        if native.get_lib() is None:
            return _PyRing(capacity_bytes)
        return native.SampleRing(capacity_bytes)

    def stream(self, block: int = 10000, use_async: bool = True,
               ring_seconds: float = 2.0,
               poll_sleep: float = 0.001) -> Iterator[np.ndarray]:
        """Continuous blocks of ``block`` complex samples.

        use_async=True (the reference's layout): a reader thread drains
        the dongle into the SPSC ring regardless of consumer pace;
        overruns drop whole USB blocks with counters (``dropped_bytes``,
        ``dropped_seconds()``).  use_async=False: the plain blocking
        read loop, one synchronous read per block."""
        if not use_async:
            while True:
                raw = self._read_exact(block * 2)
                yield iq_u8_to_complex(np.frombuffer(raw, dtype=np.uint8))
        cap_bytes = max(int(2 * self.fs_programmed * ring_seconds),
                        4 * block * 2)
        ring = self._make_ring(cap_bytes)
        reader = _AsyncReader(self._read_exact, ring)
        self._reader = reader
        try:
            pending = np.empty(0, dtype=np.uint8)
            while True:
                need = block * 2 - pending.size
                chunk = ring.pop(need)
                if chunk.size:
                    pending = np.concatenate([pending, chunk]) \
                        if pending.size else chunk
                if pending.size < block * 2:
                    if reader.error is not None:
                        raise RuntimeError(
                            f"USB reader thread died: {reader.error}")
                    self._sleep(poll_sleep)
                    continue
                yield iq_u8_to_complex(pending)
                pending = np.empty(0, dtype=np.uint8)
        finally:
            reader.stop()
            self._reader = None

    def dropped_seconds(self) -> float:
        """Seconds of raw stream dropped at the USB ring so far (the
        dashboard's usb-drops readout)."""
        reader = getattr(self, "_reader", None)
        if reader is None or self.fs_programmed <= 0:
            return 0.0
        return reader.dropped_bytes / (2.0 * self.fs_programmed)

    def close(self) -> None:
        reader = getattr(self, "_reader", None)
        if reader is not None:
            reader.stop()
            self._reader = None
        if getattr(self, "_dev", None) is not None:
            self._lib.rtlsdr_close(self._dev)
            self._dev = None
