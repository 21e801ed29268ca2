"""Batched front end of the tracker: get_fd over (cells, symbols).

The reference runs one thread per tracked cell, each calling get_fd once
per OFDM symbol (reference src/tracker_thread.cpp:91-174: ICI removal
mixer, 2-sample rotation, 128-point DFT, 72-subcarrier extraction,
bulk-phase + lateness compensation).  Here all pending symbols of ALL
tracked cells become one [n_cells, n_symbols, 128] batch of tensor
operations on the runner's device: the mixers and DFTs (cuFFT on the
card) are the tracker's FLOPs.  The sequential bulk-phase accumulator
becomes an inclusive cumulative sum of per-symbol phase increments.
All of it runs in complex128/float64 on every device, as the reference
implementation's tick does; the host carries each cell's phase between
ticks in float64.

The small per-symbol control-loop math (CE filtering, FOE/TOE blending,
MIB bookkeeping -- 12-element vectors) stays on the host in float64
(cell_tracker.py), consuming the precomputed symbols.

Shapes are bucketed (symbol axis rounded up to a multiple of 32, the
extended raw block to 16 Ki samples) so the card sees a handful of
shapes (cuFFT plans, allocator blocks) instead of one per tick; the
padding rows gather zeros from a guard window and change no output.

``backend="host"`` runs the same math on the host instead, in float64:
the native C runtime (native/tracker_math.cpp get_fd_batch, its own
radix-2 FFT).  No runner selects it; the tests hold it and the device
program against the JAX package's numpy get_fd.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..constants import FS_LTE
from ..device import resolve_device
from ..ops.dsp import extract_center_subcarriers

_CN = np.concatenate([np.arange(-36, 0), np.arange(1, 37)])
_BUCKET = 32            # symbol-axis rounding
_EXT_BUCKET = 16384     # extended raw-block rounding (samples)


@lru_cache(maxsize=None)
def _ramps(device: torch.device, dtype: torch.dtype):
    """The DFT window's sample ramp n = 0..127 and the 72 kept bins'
    indices _CN, made once per device and type (no upload per tick)."""
    return (torch.arange(128, dtype=dtype, device=device),
            torch.as_tensor(_CN, dtype=dtype).to(device))


def _get_fd_core(data: torch.Tensor, fo, late, n_samp_elapsed, valid,
                 init_phase, fc_requested: float, fc_programmed: float,
                 fs_programmed: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """data [B,S,128] complex; fo/late/n_samp_elapsed [B,S] real, valid
    [B,S] bool, init_phase [B] (one device, one working type).  Returns
    (syms [B,S,72], final_phase [B] wrapped to [-pi, pi))."""
    rdt = data.real.dtype
    dev = data.device
    n, cn = _ramps(dev, rdt)

    k_factor = (fc_requested - fo) / fc_programmed            # [B,S]
    mix = torch.exp((-2j * math.pi) * fo[..., None] * n
                    / (fs_programmed * k_factor)[..., None])
    mixed = data * mix
    dft_in = torch.roll(mixed, -2, dims=-1)
    dft_out = torch.fft.fft(dft_in, dim=-1) / math.sqrt(128.0)
    syms = extract_center_subcarriers(dft_out, 72)           # [B,S,72]

    incr = 2 * math.pi * n_samp_elapsed * (16.0 / FS_LTE) * (-fo)
    incr = torch.where(valid, incr, torch.zeros((), dtype=rdt, device=dev))
    phase = init_phase[:, None] + torch.cumsum(incr, dim=1)  # [B,S]
    comp = torch.exp(1j * (phase[..., None]
                           - 2 * math.pi * late[..., None] / 128.0 * cn))
    syms = syms * comp
    # the last running phase is init + sum(incr): padding rows add zero,
    # so it does not depend on the bucket
    final = phase[:, -1]
    final = torch.remainder(final + math.pi, 2 * math.pi) - math.pi
    return syms, final


def _get_fd_block_core(block: torch.Tensor, starts: torch.Tensor, fo, late,
                       n_samp_elapsed, valid, init_phase, fc_requested,
                       fc_programmed, fs_programmed):
    """_get_fd_core with the [B,S,128] symbol windows gathered on the
    device from one shared raw block (plus appendix rows for symbols
    that straddled producer blocks): the stream crosses to the card
    once per tick instead of once per cell."""
    win = torch.arange(128, dtype=starts.dtype, device=starts.device)
    data = block[starts[..., None] + win]                    # [B,S,128]
    return _get_fd_core(data, fo, late, n_samp_elapsed, valid, init_phase,
                        fc_requested, fc_programmed, fs_programmed)


def n_samp_elapsed_of(sym_num: int, extended_cp: bool) -> int:
    """Samples consumed by this symbol (reference tracker_thread.cpp
    :121-131): extended CP 160, else 138 for symbol 0, 137 otherwise."""
    if extended_cp:
        return 128 + 32
    return 128 + 10 if sym_num == 0 else 128 + 9


def _nse_of_chunk(chunk, n_symb: int) -> np.ndarray:
    """Per-symbol sample strides for a PduChunk (n_samp_elapsed_of over
    the chunk's running symbol index)."""
    n = len(chunk)
    if n_symb == 6:
        return np.full(n, float(n_samp_elapsed_of(0, True)))
    sym = (chunk.sym0 + np.arange(n)) % n_symb
    return np.where(sym == 0, float(n_samp_elapsed_of(0, False)),
                    float(n_samp_elapsed_of(1, False)))


def _get_fd_native(cell_pdus: Sequence[Tuple[object, object]], state,
                   lib) -> List[np.ndarray]:
    """One native C call per cell (native/tracker_math.cpp get_fd_batch:
    mixer + radix-2 FFT-128 + phase compensation)."""
    out: List[np.ndarray] = []
    fc_req = float(state.fc_requested)
    fc_prog = float(state.fc_programmed)
    fs_prog = float(state.fs_programmed)
    for proc, chunk in cell_pdus:
        m = len(chunk)
        data = np.ascontiguousarray(chunk.data, dtype=np.complex128)
        fo = np.ascontiguousarray(chunk.fo, dtype=np.float64)
        late = np.ascontiguousarray(chunk.late, dtype=np.float64)
        nse = _nse_of_chunk(chunk, proc.cell.n_symb_dl())
        o = np.empty((m, 72), np.complex128)
        final = lib.get_fd_batch(
            data.ctypes.data, m, fo.ctypes.data, late.ctypes.data,
            nse.ctypes.data, proc.bulk_phase_offset, fc_req, fc_prog,
            fs_prog, FS_LTE, o.ctypes.data)
        proc.bulk_phase_offset = float(final)
        out.append(o)
    return out


class _Staging:
    """A tick's host staging buffer and its one upload.  The native
    stager (csrc/stage_tick.cpp, through stage_inputs and device_loop's
    plan) writes every section into ``buf`` in the layout the device
    program reads and records the layout in ``lay``; ``send`` makes the
    one copy and the typed views are taken of its result.

    ``reuse``: on the card, one pinned buffer (the arena) serves every
    tick and grows to the largest seen; it is rewritten only once the
    previous tick's copy from it has completed (an event recorded after
    the copy), and each tick's copy lands in a fresh device buffer.
    Otherwise each tick writes a fresh buffer (pinned on the card), which
    off the card is itself the tensors handed out.  ``on_grow`` is
    called when a reused arena is allocated.  One tick at a time."""

    def __init__(self, device: torch.device, reuse: bool = False,
                 on_grow=None):
        from ..io.native import load
        self.lib = load()
        self.device = device
        self.pinned = device.type == "cuda"
        self.reuse = reuse and self.pinned
        self.on_grow = on_grow
        self.cap = 0
        self.buf = None
        self.lay = np.zeros(15, np.int64)
        self.lay_at = self.lay.ctypes.data
        self._copied = torch.cuda.Event() if self.reuse else None

    def _alloc(self, cap: int) -> torch.Tensor:
        return torch.empty(cap, dtype=torch.uint8, pin_memory=self.pinned)

    def take(self) -> None:
        """Make ``buf`` writable for this tick."""
        if self.reuse and self.buf is not None:
            self._copied.synchronize()
        else:
            self.buf = self._alloc(self.cap)

    def write(self, entry, *head, keep: int = 0) -> None:
        """Call a stager entry (its own leading arguments ``head``) on
        ``buf``; when it needs more room, grow ``buf`` to the next power
        of two, keeping its first ``keep`` bytes, and call again."""
        need = entry(*head, self.buf.data_ptr(), self.cap, self.lay_at)
        if need:
            cap = 1 << (int(need) - 1).bit_length()
            buf = self._alloc(cap)
            buf[:keep].copy_(self.buf[:keep])
            self.buf, self.cap = buf, cap
            if self.reuse and self.on_grow is not None:
                self.on_grow()
            if entry(*head, self.buf.data_ptr(), self.cap, self.lay_at):
                raise RuntimeError("tick stager: the grown buffer is short")

    def send(self, n: int) -> torch.Tensor:
        """The first n bytes on the device: one copy into a fresh buffer
        on the card, the fresh host buffer itself elsewhere."""
        if not self.pinned:
            return self.buf[:n]
        out = torch.empty(n, dtype=torch.uint8, device=self.device)
        out.copy_(self.buf[:n], non_blocking=True)
        if self.reuse:
            self._copied.record(torch.cuda.current_stream(self.device))
        return out


class _Sections:
    """Typed views of the sections of one uploaded staging buffer: one
    view of the whole buffer per type, strided views of it per
    section."""

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.typed = {}

    def __call__(self, off: int, dtype: torch.dtype, shape) -> torch.Tensor:
        t = self.typed.get(dtype)
        if t is None:
            t = self.typed[dtype] = self.buf.view(dtype)
        stride = [1] * len(shape)
        for i in range(len(shape) - 1, 0, -1):
            stride[i - 1] = stride[i] * shape[i]
        return t.as_strided(shape, stride, off // dtype.itemsize)


def stage_inputs(cell_pdus: Sequence[Tuple[object, object]], raw_block,
                 block_seq: int, staging: _Staging) -> Tuple[int, int]:
    """The staging shared by the batched device paths, in one native call
    (csrc/stage_tick.cpp::stage_tick_inputs) into ``staging``: per-cell
    symbol metadata padded to the (B, S) bucket, plus either the [B, S,
    128] window copies (raw_block=None) or the extended raw block as
    (re, im) planes in the narrowest exact wire type -- float16 for
    blocks on the 8-bit ADC grid (dongle codes /128 are exact in
    float16's 11-bit mantissa), else float64, the tick's working type on
    every device -- with per-symbol start indices for the on-device
    window gather.  Symbols whose window is not in the block (stale
    blocks, straddlers, chunks with no starts) ride in an appendix of
    their windows; padding rows gather zeros from one trailing guard
    window, and the extended block is zero-padded to the _EXT_BUCKET so
    the card sees few shapes.  Returns (B, S)."""
    B = len(cell_pdus)
    ms = [len(c) for _, c in cell_pdus]
    S = -(-max(ms) // _BUCKET) * _BUCKET
    use_block = raw_block is not None
    keep, cells, phase = [], [], []
    for (proc, chunk), m in zip(cell_pdus, ms):
        data = np.ascontiguousarray(chunk.data, np.complex128)
        fo = np.ascontiguousarray(chunk.fo, np.float64)
        late = np.ascontiguousarray(chunk.late, np.float64)
        st = chunk.start if use_block and chunk.block_seq == block_seq \
            else None
        if st is not None:
            st = np.ascontiguousarray(st, np.int64)
        if data.shape != (m, 128) or fo.shape != (m,) \
                or late.shape != (m,) \
                or (st is not None and st.shape != (m,)):
            raise ValueError(f"PduChunk of {m} symbols: data {data.shape}, "
                             f"fo {fo.shape}, late {late.shape}")
        keep += (data, fo, late, st)     # referenced until the call returns
        cells += (data.ctypes.data, fo.ctypes.data, late.ctypes.data,
                  0 if st is None else st.ctypes.data, m, chunk.sym0,
                  proc.cell.n_symb_dl())
        phase.append(proc.bulk_phase_offset)
    cells = np.array(cells, np.int64)
    phase = np.array(phase, np.float64)
    raw = np.ascontiguousarray(raw_block, np.complex128) if use_block \
        else None
    staging.take()
    staging.write(staging.lib.stage_tick_inputs, B, S, cells.ctypes.data,
                  phase.ctypes.data, None if raw is None else raw.ctypes.data,
                  0 if raw is None else len(raw), _EXT_BUCKET)
    return B, S


def input_views(view: _Sections, lay: Sequence[int], B: int, S: int):
    """(planes, data, starts, fln, init_phase) of stage_inputs' sections,
    as recorded in ``lay``: planes [n_ext, 2] and starts [B, S], or data
    [B, S, 128, 2] (the others None); fln [B, 3, S] (fo, late, nse);
    init_phase [B]."""
    f8 = torch.float64
    if lay[3] >= 0:
        planes = view(lay[2], f8 if lay[0] else torch.float16, (lay[1], 2))
        data, starts = None, view(lay[3], torch.int64, (B, S))
    else:
        planes, starts = None, None
        data = view(lay[2], f8, (B, S, 128, 2))
    return (planes, data, starts, view(lay[4], f8, (B, 3, S)),
            view(lay[5], f8, (B,)))


def planes_to_complex(planes: torch.Tensor, rdt: torch.dtype
                      ) -> torch.Tensor:
    return torch.view_as_complex(planes.to(rdt).contiguous())


def batched_get_fd(cell_pdus: Sequence[Tuple[object, object]], state,
                   backend: str = "device", raw_block: np.ndarray = None,
                   block_seq: int = -1, device=None) -> List[np.ndarray]:
    """Run get_fd for every (processor, PduChunk) pair in one batch call.

    Updates each processor's bulk_phase_offset and returns, per cell, an
    array [n_pdus, 72] of compensated frequency-domain symbols.
    backend: 'device' (tensor operations on ``device``, None = the
    card) or 'host' (the native C runtime, built here if it is
    missing; raises without a compiler).

    raw_block/block_seq (device backend): the producer block the chunks
    were framed from.  When given, the device receives the block ONCE
    plus per-symbol start indices and gathers the 128-sample windows
    itself; symbols framed from older blocks (or in chunks that carry no
    starts) ride in a small appendix of host-extracted windows.
    """
    if backend == "host":
        from ..io.native import load
        return _get_fd_native(cell_pdus, state, load())
    if backend != "device":
        raise ValueError(f"unknown get_fd backend {backend!r}")

    dev = resolve_device(device)
    staging = _Staging(dev)
    B, S = stage_inputs(cell_pdus, raw_block, block_seq, staging)
    lay = staging.lay.tolist()
    planes, data, starts, fln, ph = input_views(
        _Sections(staging.send(lay[6])), lay, B, S)
    fc = (float(state.fc_requested), float(state.fc_programmed),
          float(state.fs_programmed))
    core_args = (fln[:, 0], fln[:, 1], fln[:, 2], fln[:, 2] > 0, ph, *fc)
    if planes is not None:
        syms, final = _get_fd_block_core(
            planes_to_complex(planes, torch.float64), starts, *core_args)
    else:
        syms, final = _get_fd_core(torch.view_as_complex(data), *core_args)
    syms = syms.to(torch.complex128).cpu().numpy()
    final = final.double().cpu().numpy()

    out: List[np.ndarray] = []
    for b, (proc, chunk) in enumerate(cell_pdus):
        proc.bulk_phase_offset = float(final[b])
        out.append(syms[b, : len(chunk)])
    return out
