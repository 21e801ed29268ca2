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
_ALIGN = 16             # byte alignment of each section of an upload


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


def _stage_block_inputs(cell_pdus: Sequence[Tuple[object, object]],
                        raw_block, block_seq: int):
    """Host staging shared by the batched device paths: per-cell symbol
    metadata padded to the (B, S) bucket, plus either the [B, S, 128]
    window copies (raw_block=None) or the extended raw block + per-
    symbol start indices for the on-device window gather.

    Returns (ext, data, starts, fo, late, nse, valid, init_phase), all
    host numpy (complex128/float64); exactly one of ext/data is not
    None."""
    B = len(cell_pdus)
    s_max = max(len(c) for _, c in cell_pdus)
    S = -(-s_max // _BUCKET) * _BUCKET

    fo = np.zeros((B, S))
    late = np.zeros((B, S))
    nse = np.zeros((B, S))
    valid = np.zeros((B, S), dtype=bool)
    init_phase = np.zeros(B)
    use_block = raw_block is not None
    data = None if use_block else np.zeros((B, S, 128), np.complex128)
    starts = np.zeros((B, S), dtype=np.int64) if use_block else None
    appendix = [] if use_block else None
    n_app = 0
    L = len(raw_block) if use_block else 0
    for b, (proc, chunk) in enumerate(cell_pdus):
        m = len(chunk)
        if use_block:
            cs = chunk.start if (chunk.start is not None
                                 and chunk.block_seq == block_seq) \
                else np.full(m, -1, np.int64)
            ok = (cs >= 0) & (cs <= L - 128)
            row = np.empty(m, np.int64)
            row[ok] = cs[ok]
            n_bad = int(m - ok.sum())
            if n_bad:                      # straddlers / stale blocks
                row[~ok] = L + 128 * (n_app + np.arange(n_bad))
                appendix.append(np.ascontiguousarray(
                    chunk.data[~ok]).ravel())
                n_app += n_bad
            starts[b, :m] = row
        else:
            data[b, :m] = chunk.data
        fo[b, :m] = chunk.fo
        late[b, :m] = chunk.late
        nse[b, :m] = _nse_of_chunk(chunk, proc.cell.n_symb_dl())
        valid[b, :m] = True
        init_phase[b] = proc.bulk_phase_offset
    ext = None
    if use_block:
        # padding rows gather zeros from one trailing guard window; ext
        # is zero-padded to the _EXT_BUCKET so the card sees few shapes
        pad_at = L + 128 * n_app
        starts[~valid] = pad_at
        ext_len = -(-(pad_at + 128) // _EXT_BUCKET) * _EXT_BUCKET
        ext = np.zeros(ext_len, np.complex128)
        ext[:L] = np.asarray(raw_block)
        if n_app:
            ext[L: pad_at] = np.concatenate(appendix)
    return ext, data, starts, fo, late, nse, valid, init_phase


def upload(arrays: Sequence[np.ndarray], device: torch.device
           ) -> List[torch.Tensor]:
    """Host arrays -> tensors on ``device`` through ONE copy: the arrays
    are laid out in one byte buffer (each section 16-byte aligned;
    pinned memory on the card) that crosses once and is viewed back as
    typed tensors of the same shapes."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs = []
    off = 0
    for a in arrays:
        off = -(-off // _ALIGN) * _ALIGN
        offs.append(off)
        off += a.nbytes
    host = torch.empty(max(off, 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    hb = host.numpy()
    for a, o in zip(arrays, offs):
        hb[o: o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True)
    return [buf[o: o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


def wire_planes(ext: np.ndarray) -> np.ndarray:
    """The extended raw block as [n, 2] (re, im) planes in the narrowest
    exact wire type: float16 for blocks on the 8-bit ADC grid (dongle
    codes /128 are exact in float16's 11-bit mantissa), else float64,
    the tick's working type on every device."""
    from ..ops.corr_cuda import is_adc_grid
    wire = np.float16 if is_adc_grid(ext) else np.float64
    return np.ascontiguousarray(ext.view(np.float64).reshape(-1, 2), wire)


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
    rdt = torch.float64
    wdt = np.float64
    (ext, data, starts, fo, late, nse, valid, init_phase) = \
        _stage_block_inputs(cell_pdus, raw_block, block_seq)
    meta = [np.stack([fo, late, nse], axis=1).astype(wdt),
            init_phase.astype(wdt)]
    fc = (float(state.fc_requested), float(state.fc_programmed),
          float(state.fs_programmed))
    if ext is not None:
        planes, starts_t, fln, ph = upload(
            [wire_planes(ext), starts] + meta, dev)
        syms, final = _get_fd_block_core(
            planes_to_complex(planes, rdt), starts_t, fln[:, 0], fln[:, 1],
            fln[:, 2], fln[:, 2] > 0, ph, *fc)
    else:
        d, fln, ph = upload([np.ascontiguousarray(
            data.view(np.float64).reshape(data.shape + (2,)), wdt)] + meta,
            dev)
        syms, final = _get_fd_core(
            torch.view_as_complex(d), fln[:, 0], fln[:, 1], fln[:, 2],
            fln[:, 2] > 0, ph, *fc)
    syms = syms.to(torch.complex128).cpu().numpy()
    final = final.double().cpu().numpy()

    out: List[np.ndarray] = []
    for b, (proc, chunk) in enumerate(cell_pdus):
        proc.bulk_phase_offset = float(final[b])
        out.append(syms[b, : len(chunk)])
    return out
