"""Sample-stream demultiplexer (the reference producer thread, re-designed).

Behavioral contract: reference src/producer_thread.cpp:59-252:

- every sample gets an LTE-timescale timestamp advanced by
  (FS_LTE/16)/(fs_programmed*k_factor) and wrapped mod 19200 (one frame);
- when the searcher requests a capture, filling starts at the timestamp-0
  crossing (within 0.5 samples) and records the fractional lateness;
- per tracked cell, a 128-sample OFDM-symbol window starts when the
  timestamp crosses frame_timing + target_cap_start_time within 0.5
  samples (or up to 3 samples late), stamping the FO and frame timing in
  effect at capture start; after each window the target advances by the
  symbol stride (CP-dependent) mod 19200.

Re-design notes: the per-cell symbol framing runs in the native runtime
(native/ingest.cpp cell_frame_symbols, one C call per cell per block --
the reference's producer inner loop is C++ too), and the producer->tracker
FIFO carries struct-of-arrays PDU CHUNKS (data [n,128], late/fo/ft [n])
instead of per-symbol Python objects (reference td_fifo_pdu_t,
LTE-Tracker.h:9).  The runtime is required: the producer builds it with
g++ (io/native.py::load) and raises without it.  The parity reference
is the JAX package's Python framing loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from collections import deque

import numpy as np

from ..constants import FS_LTE
from .state import GlobalState, TrackedCell


@dataclass
class SymbolPdu:
    """Per-symbol view of a PDU (reference td_fifo_pdu_t, LTE-Tracker.h:9).

    The streaming path moves PduChunk arrays; this object remains as the
    unit of the per-symbol host parity paths and tests."""
    data: np.ndarray            # 128 complex samples
    slot_num: int
    sym_num: int
    late: float
    frequency_offset: float
    frame_timing: float


@dataclass
class PduChunk:
    """A run of consecutive symbol PDUs in struct-of-arrays form."""
    data: np.ndarray            # [n, 128] complex128
    late: np.ndarray            # [n] float64
    fo: np.ndarray              # [n] float64 (frequency_offset stamps)
    ft: np.ndarray              # [n] float64 (frame_timing stamps)
    sym0: int                   # slot_num*n_symb + sym_num of first symbol
    # device gather metadata (tracker/batched.py "block" path):
    # start[i] = index of symbol i's first sample within producer block
    # block_seq, or -1 for symbols assembled across block boundaries --
    # consumers holding that block can then upload it ONCE and gather
    # every cell's 128-sample windows on the device instead of shipping
    # per-cell window copies (~8x the bytes).  None on paths that never
    # feed a device (tests building chunks by hand).
    start: np.ndarray = None    # [n] int64 or None
    block_seq: int = -1

    def __len__(self) -> int:
        return len(self.late)


class CellFifo:
    """Producer -> tracker symbol FIFO stored as PduChunk runs.

    len() counts SYMBOLS (the reference fifo counted td_fifo_pdu_t
    entries).  Chunks stay consecutive: drops remove whole frames'
    worth of symbols from the front (reference tracker dump,
    tracker_thread.cpp:857-867)."""

    __slots__ = ("chunks", "n")

    def __init__(self):
        self.chunks: Deque[PduChunk] = deque()
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def append(self, chunk: PduChunk) -> None:
        self.chunks.append(chunk)
        self.n += len(chunk)

    def pop_upto(self, k: int) -> Optional[PduChunk]:
        """Pop the first min(k, n) symbols as ONE merged chunk."""
        k = min(k, self.n)
        if k <= 0:
            return None
        parts: List[PduChunk] = []
        need = k
        while need > 0:
            c = self.chunks[0]
            m = len(c)
            if m <= need:
                parts.append(self.chunks.popleft())
                need -= m
            else:
                parts.append(PduChunk(c.data[:need], c.late[:need],
                                      c.fo[:need], c.ft[:need], c.sym0,
                                      None if c.start is None
                                      else c.start[:need], c.block_seq))
                self.chunks[0] = PduChunk(
                    c.data[need:], c.late[need:], c.fo[need:], c.ft[need:],
                    c.sym0 + need,
                    None if c.start is None else c.start[need:],
                    c.block_seq)
                need = 0
        self.n -= k
        if len(parts) == 1:
            out = parts[0]
        else:
            # merged runs may span producer blocks: keep the LATEST
            # block's starts valid and mark the rest -1 (their data
            # rides in .data as always)
            seq = max(p.block_seq for p in parts)
            starts = []
            for p in parts:
                if p.start is None or p.block_seq != seq:
                    starts.append(np.full(len(p), -1, np.int64))
                else:
                    starts.append(p.start)
            out = PduChunk(
                np.concatenate([p.data for p in parts]),
                np.concatenate([p.late for p in parts]),
                np.concatenate([p.fo for p in parts]),
                np.concatenate([p.ft for p in parts]), parts[0].sym0,
                np.concatenate(starts), seq)
        return out

    def drop_front(self, k: int) -> None:
        """Drop the first k symbols (backpressure dump)."""
        self.pop_upto(k)


@dataclass
class _CellCapture:
    serial_num: int = 0
    # native framing state (ingest.cpp cell_frame_symbols):
    # [0]=target [1]=filling [2]=buffer_offset [3]=sym_num [4]=slot_num
    # [5]=pdu_late [6]=pdu_fo [7]=pdu_ft
    state: Optional[np.ndarray] = None
    partial: Optional[np.ndarray] = None    # in-progress symbol [128] c128


def _wrap_half_frame(x):
    return (np.asarray(x) + 9600.0) % 19200.0 - 9600.0


def _next_trigger(ts, t, target, step, lo=-0.5, hi=3.0):
    """First index >= t where wrap(ts - target) lands in (lo, hi).

    ts is a linear ramp with slope `step` (mod 19200), so the crossing
    index is arithmetic: jump to where the wrapped difference re-enters
    `lo`, then verify against float rounding with a tiny window scan.
    Returns None if no trigger occurs before the end of the block.
    (The native cell_frame_symbols implements the same locator in C;
    this Python version drives the searcher-capture trigger.)
    """
    n = len(ts)
    while t < n:
        d = float((ts[t] - target + 9600.0) % 19200.0 - 9600.0)
        if lo < d < hi:
            return t
        m = int(np.ceil(((lo - d) % 19200.0) / step))
        t2 = t + max(m, 1)
        # verify against float rounding with a tiny scalar scan around
        # the predicted crossing (same window the vectorized check
        # covered, but with no per-call array allocations -- this runs
        # once per OFDM symbol per cell on the streaming hot path)
        for c in range(max(t, t2 - 2), min(t2 + 6, n)):
            dc = (float(ts[c]) - target + 9600.0) % 19200.0 - 9600.0
            if lo < dc < hi:
                return c
        if t2 + 6 >= n:
            return None
        # the window was hopped over (step > interval width); try the
        # next frame's crossing
        t = t2 + 6
    return None


class Producer:
    """Demultiplexes the raw sample stream into per-cell symbol PDU chunks
    and searcher capture buffers."""

    def __init__(self, state: GlobalState, capbuf_len: int = 19200 * 8):
        self.state = state
        self.sample_time = -1.0
        # monotonically increasing per process() call; stamps every
        # chunk so tracker/batched.py can tell which symbols' windows
        # live in the CURRENT raw block (the device gather path)
        self.block_seq = 0
        # searcher capture handshake (reference capbuf_sync_t)
        self.capbuf_len = capbuf_len
        self.capture_requested = False
        self._filling = False
        self._cap_idx = 0
        self.capbuf = np.zeros(capbuf_len, dtype=np.complex128)
        self.capbuf_late = 0.0
        self.capbuf_ready = False
        # per-cell capture state + output fifos
        self._cell_state: Dict[int, _CellCapture] = {}
        self.fifos: Dict[int, CellFifo] = {}
        # the native runtime (io/native.py), built here if it is missing;
        # without a compiler this raises
        from ..io.native import load
        self._native = load()

    def request_capture(self) -> None:
        self.capture_requested = True
        self.capbuf_ready = False

    def capture_idle(self) -> bool:
        """True when no capture is pending, filling, or awaiting pickup."""
        return not (self.capture_requested or self._filling
                    or self.capbuf_ready)

    # ------------------------------------------------------------------
    def _frame_cell(self, samples, n, ts0, step, cell, cl, fifo) -> None:
        """One native call frames the block's symbols of one cell
        (ingest.cpp cell_frame_symbols2) into the cell's fifo."""
        n_symb = cell.n_symb_dl()
        max_out = n // 128 + 2
        out_data = np.empty((max_out, 128), np.complex128)
        out_late = np.empty(max_out)
        out_fo = np.empty(max_out)
        out_ft = np.empty(max_out)
        out_sym = np.empty(max_out, np.int64)
        out_start = np.empty(max_out, np.int64)
        n_out = self._native.cell_frame_symbols2(
            samples.ctypes.data, n, ts0, step, cell.frame_timing,
            self.state.frequency_offset, n_symb, cl.state.ctypes.data,
            cl.partial.ctypes.data, out_data.ctypes.data,
            out_late.ctypes.data, out_fo.ctypes.data, out_ft.ctypes.data,
            out_sym.ctypes.data, out_start.ctypes.data)
        if n_out:
            fifo.append(PduChunk(out_data[:n_out], out_late[:n_out],
                                 out_fo[:n_out], out_ft[:n_out],
                                 int(out_sym[0]), out_start[:n_out].copy(),
                                 self.block_seq))

    # ------------------------------------------------------------------
    def process(self, samples: np.ndarray, cells: List[TrackedCell]) -> None:
        """Process one block of complex samples."""
        n = len(samples)
        if n == 0:
            return
        self.block_seq += 1
        k_factor = self.state.k_factor()
        step = (FS_LTE / 16) / (self.state.fs_programmed * k_factor)
        ts0 = self.sample_time
        self.sample_time = float((self.sample_time + step * n) % 19200.0)

        # ---- searcher capture buffer ---------------------------------
        if self.capture_requested or self._filling:
            t = 0
            if self.capture_requested:
                # wrapped per-sample timestamps (the native framing
                # computes them on the fly)
                ts = (ts0 + step * np.arange(1, n + 1)) % 19200.0
                # the timestamps are a linear ramp (slope `step` mod
                # 19200), so the first |wrap(ts)| < 0.5 crossing is
                # computed analytically instead of scanned per sample;
                # step > 1 can occasionally hop over the 1-sample-wide
                # window, in which case the next frame's crossing is
                # tried (the scalar loop had the same miss semantics)
                t = _next_trigger(ts, 0, 0.0, step, lo=-0.5, hi=0.5)
                if t is None:
                    t = n
                else:
                    self.capture_requested = False
                    self._filling = True
                    self._cap_idx = 0
                    self.capbuf_late = float(_wrap_half_frame(ts[t]))
            if self._filling and t < n:
                take = min(self.capbuf_len - self._cap_idx, n - t)
                self.capbuf[self._cap_idx: self._cap_idx + take] = \
                    samples[t: t + take]
                self._cap_idx += take
                if self._cap_idx == self.capbuf_len:
                    self._filling = False
                    self.capbuf_ready = True

        # ---- per-cell symbol framing ---------------------------------
        if cells:
            samples = np.ascontiguousarray(samples, dtype=np.complex128)
        for cell in cells:
            cid = cell.n_id_cell
            cl = self._cell_state.get(cid)
            if cl is None or cell.serial_num != cl.serial_num:
                cl = _CellCapture(serial_num=cell.serial_num)
                cl.state = np.zeros(8, np.float64)
                cl.state[0] = 10.0 if cell.n_symb_dl() == 7 else 32.0
                cl.partial = np.zeros(128, dtype=np.complex128)
                self._cell_state[cid] = cl
                self.fifos.setdefault(cid, CellFifo())
            fifo = self.fifos[cid]
            self._frame_cell(samples, n, ts0, step, cell, cl, fifo)
            cell.fifo_peak_size = max(cell.fifo_peak_size, len(fifo))
            # backpressure: if the consumer is >1.5 s behind, dump 1 s of
            # symbols (whole frames, so mod-frame labels stay consistent)
            # and count it (reference tracker_thread.cpp:857-867 /
            # display_thread.cpp:538)
            sym_per_sec = self.state.fs_programmed \
                * (20 * cell.n_symb_dl()) / 19200.0
            if len(fifo) > 1.5 * sym_per_sec:
                fifo.drop_front(int(sym_per_sec))
                self.state.cell_seconds_dropped += 1

    def drop_cell(self, n_id_cell: int) -> None:
        self._cell_state.pop(n_id_cell, None)
        self.fifos.pop(n_id_cell, None)
