"""Device-resident tracker tick: demod + CRS extraction on the device.

The host control loops read, per tick and cell, only the 12 CRS
subcarriers of each RS symbol (reference per-symbol loop,
src/tracker_thread.cpp:856-906, extracts CRS from each demodulated
symbol; :176-393 runs the per-RS-window statistics and FOE/TOE feedback
on them) and a few SPECIAL symbols: the PSS/SSS sync-SNR pair at each
half frame and the 4 PBCH symbols per frame (slot 1, syms 0-3).  So the
tick's device program runs the batched demod (tracker/batched.py), then

- the per-port CRS extraction (shift-table gather x conjugated-RS
  multiply), so only the [n_rs, 12] raw channel-estimate rows come down
  (12/72 of the RS symbols' bins, none of the other symbols);
- the special rows, gathered and downloaded as a dense [n_spec, 72]
  slab (~6% of symbols).

Everything downstream is unchanged host float64: the RS-window
statistics, the sequential FOE/frame-timing register chain, interp72 +
pair interpolation, sync SNR and the 40 ms MIB re-decode run in the
same native runtime as the dense path
(cell_tracker.TrackedCellProcessor.process_device).

A tick crosses the host-device boundary twice: ONE upload (the raw block
as (re, im) planes -- float16 when it sits on the 8-bit ADC grid -- plus
the gather metadata) and ONE download (a packed float vector: raw-CE
planes, special-row planes and final phases).  The gather indices are
built on the host, which knows every label; masked rows carry a zero
table value (CRS) or a zero mask (special rows), so they come back as
zeros.  The host staging is two native calls (csrc/stage_tick.cpp) that
write every section into one byte buffer in the layout the program
reads: on the card a pinned arena that every tick reuses, sent in one
copy into a fresh device buffer (batched._Staging).

On the card the device program is about 50 small complex128 operations,
each a few microseconds of device work behind more of host dispatch.
So _tick_program replays it as a CUDA graph, one per bucket (_bucket_key):
the first tick of a bucket runs eagerly, the second captures the graph,
every later one copies its arguments into the graph's static inputs,
replays it and clones the static output.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.debug import stage
from .batched import (_get_fd_block_core, _get_fd_core, _Sections,
                      _Staging, input_views, planes_to_complex,
                      stage_inputs)

_RS_BUCKET = 64        # rs-row / special-row axis rounding
_GRAPHS_MAX = 32       # buckets remembered (seen once, or captured)

# How the tick's device program ran since the process started: captured
# as a CUDA graph, replayed from one, run eagerly (the CPU, and a
# bucket's first tick), and graphs dropped as least recently used; and
# how its inputs were staged: ticks whose inputs went as float16 planes
# (the 8-bit ADC grid) and as float64, and pinned arenas allocated.
tick_counts = {"captures": 0, "replays": 0, "eager": 0, "evictions": 0,
               "wire_f16": 0, "wire_f64": 0, "arenas": 0}
# bucket key -> its _TickGraph, or None after the bucket's first tick
_graphs: "OrderedDict[tuple, Optional[_TickGraph]]" = OrderedDict()
# device -> its staging buffer (_staging)
_stagings: "dict[torch.device, _Staging]" = {}
# the timings dict of the tick this thread is launching, for the span
# "program.capture" (_tick_program's arguments are fixed)
_launching = threading.local()


def _tick_math(planes, data, starts, fln, init_phase, fc_requested,
               fc_programmed, fs_programmed, rs_flat, rs_tab, spec_rows,
               spec_mask) -> torch.Tensor:
    """The tick's device program: batched demod + CRS/special gather.

    planes [n_ext, 2] raw-block (re, im) planes with starts [B, S] (or
    data [B, S, 128, 2] window planes); fln [B, 3, S]: (fo, late, nse)
    per symbol -- padding rows have nse == 0, the validity mask.
    rs_flat [B, P, NR, 12]: each CRS sample's index into the flattened
    [B, S, 72] symbols; rs_tab [B, P, NR, 12, 2]: its conjugated RS
    value (zero for masked rows).  spec_rows [B, NQ]: each special row's
    index into [B * S] symbol rows, spec_mask [B, NQ] 1/0.

    Returns one float vector: [ce_re, ce_im, spec_re, spec_im, final]
    raveled in that order (the host unpacks by the known sizes)."""
    rdt = fln.dtype
    fo, late, nse = fln[:, 0], fln[:, 1], fln[:, 2]
    valid = nse > 0
    if planes is not None:
        syms, final = _get_fd_block_core(
            planes_to_complex(planes, rdt), starts, fo, late, nse, valid,
            init_phase, fc_requested, fc_programmed, fs_programmed)
    else:
        syms, final = _get_fd_core(
            torch.view_as_complex(data), fo, late, nse, valid, init_phase,
            fc_requested, fc_programmed, fs_programmed)
    vals = torch.view_as_real(syms).reshape(-1, 2)[rs_flat]  # [..., 12, 2]
    v_re, v_im = vals[..., 0], vals[..., 1]
    t_re, t_im = rs_tab[..., 0], rs_tab[..., 1]
    ce_re = v_re * t_re - v_im * t_im
    ce_im = v_re * t_im + v_im * t_re
    spec = torch.view_as_real(syms.reshape(-1, 72)[spec_rows]) \
        * spec_mask[..., None, None]                        # [B, NQ, 72, 2]
    return torch.cat([ce_re.reshape(-1), ce_im.reshape(-1),
                      spec[..., 0].reshape(-1), spec[..., 1].reshape(-1),
                      final])


def _bucket_key(args) -> tuple:
    """What a captured tick program depends on: each tensor argument's
    shape, dtype and device (None for the absent one of planes and
    data, and for starts with data), and the bits of the three
    frequencies, which a capture bakes in as kernel arguments."""
    return tuple((a.shape, a.dtype, a.device)
                 if isinstance(a, torch.Tensor)
                 else None if a is None else float(a).hex() for a in args)


class _TickGraph:
    """One bucket's tick program as a CUDA graph: static inputs, the
    graph and its static output.  Built from one tick's arguments: an
    eager warm-up on a side stream (cuFFT plans, _ramps' tensors), then
    the capture."""

    def __init__(self, args):
        dev = args[3].device
        self.inputs = [torch.empty(a.shape, dtype=a.dtype, device=dev)
                       if isinstance(a, torch.Tensor) else a for a in args]
        self._load(args)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            _tick_math(*self.inputs)
        cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.out = _tick_math(*self.inputs)

    def _load(self, args) -> None:
        for s, a in zip(self.inputs, args):
            if isinstance(a, torch.Tensor):
                s.copy_(a)

    def __call__(self, args) -> torch.Tensor:
        self._load(args)
        self.graph.replay()
        return self.out.clone()


def _tick_program(planes, data, starts, fln, init_phase, fc_requested,
                  fc_programmed, fs_programmed, rs_flat, rs_tab, spec_rows,
                  spec_mask) -> torch.Tensor:
    """_tick_math's packed output, a fresh tensor each call.  On a CUDA
    device the first tick of a bucket (_bucket_key) runs eagerly, the
    second captures a CUDA graph (span "program.capture") and later
    ones replay it; elsewhere every tick runs eagerly.  tick_counts
    counts each way."""
    args = (planes, data, starts, fln, init_phase, fc_requested,
            fc_programmed, fs_programmed, rs_flat, rs_tab, spec_rows,
            spec_mask)
    if fln.device.type != "cuda":
        tick_counts["eager"] += 1
        return _tick_math(*args)
    key = _bucket_key(args)
    if key not in _graphs:
        _graphs[key] = None
        if len(_graphs) > _GRAPHS_MAX:
            if _graphs.popitem(last=False)[1] is not None:
                tick_counts["evictions"] += 1
        tick_counts["eager"] += 1
        return _tick_math(*args)
    _graphs.move_to_end(key)
    graph = _graphs[key]
    if graph is not None:
        tick_counts["replays"] += 1
        return graph(args)
    with stage("program.capture",
               timings=getattr(_launching, "timings", None)):
        graph = _graphs[key] = _TickGraph(args)
        tick_counts["captures"] += 1
        return graph(args)


def _staging(dev: torch.device) -> _Staging:
    """The device's staging buffer: one pinned arena reused by every
    tick on the card (tick_counts["arenas"] counts its allocations), a
    fresh buffer per tick elsewhere."""
    st = _stagings.get(dev)
    if st is None:
        st = _stagings[dev] = _Staging(dev, reuse=True,
                                       on_grow=_count_arena)
    return st


def _count_arena() -> None:
    tick_counts["arenas"] += 1


def _stage_plan(cell_pdus: Sequence[Tuple[object, object]], S: int,
                staging: _Staging) -> list:
    """Per-cell structural plans from each processor's running (slot,
    sym) counter -- (slots_a, syms_a, sh_all [m, 4], rs_sel per port,
    spec_sel): labels, CRS shifts, the RS rows of each port and the
    special rows, as views of one fresh int64 buffer -- and from them the
    gather tables in ``staging``, in one native call
    (csrc/stage_tick.cpp::stage_tick_plan)."""
    B = len(cell_pdus)
    ms = [len(c) for _, c in cell_pdus]
    cells = []
    for (proc, _), m in zip(cell_pdus, ms):
        n_symb = proc.cell.n_symb_dl()
        cells += (m, proc.slot_num * n_symb + proc.sym_num, n_symb,
                  proc.cell.n_ports, proc._shift_at, proc._rs_conj_at)
    cells = np.array(cells, np.int64)
    buf = np.empty(5 * B + 11 * sum(ms), np.int64)
    staging.write(staging.lib.stage_tick_plan, B, S, cells.ctypes.data,
                  _RS_BUCKET, buf.ctypes.data, keep=int(staging.lay[6]))
    counts = buf[: 5 * B].tolist()       # per cell: nr of ports 0-3, nq
    plans = []
    o = 5 * B
    for b, ((proc, _), m) in enumerate(zip(cell_pdus, ms)):
        rs = o + 6 * m
        plans.append((buf[o: o + m], buf[o + m: o + 2 * m],
                      buf[o + 2 * m: rs].reshape(m, 4),
                      [buf[rs + p * m: rs + p * m + counts[5 * b + p]]
                       for p in range(proc.cell.n_ports)],
                      buf[o + 10 * m: o + 10 * m + counts[5 * b + 4]]))
        o += 11 * m
    return plans


def stage_tick(cell_pdus: Sequence[Tuple[object, object]], state,
               raw_block: np.ndarray = None, block_seq: int = -1,
               device=None, timings: dict = None):
    """Host staging of one tick and its single upload.  Returns (the
    arguments of _tick_program, plans (_stage_plan), the packed output's
    (B, P, NR, NQ)).  The tensors and plans of a tick are its own: no
    later tick writes them.  ``timings``: the spans "stage.inputs" (the
    symbols' windows and metadata as they go on the wire:
    batched.stage_inputs), "stage.plan" (_stage_plan) and "stage.upload"
    (the one copy and the typed views) (utils/debug.py::stage)."""
    dev = resolve_device(device)
    staging = _staging(dev)
    with stage("stage.inputs", timings=timings, host=True):
        B, S = stage_inputs(cell_pdus, raw_block, block_seq, staging)
        tick_counts["wire_f64" if staging.lay[0] else "wire_f16"] += 1
    with stage("stage.plan", timings=timings, host=True):
        plans = _stage_plan(cell_pdus, S, staging)
    with stage("stage.upload", timings=timings):
        lay = staging.lay.tolist()
        view = _Sections(staging.send(lay[14]))
        P, NR, NQ = lay[7:10]
        args = input_views(view, lay, B, S) + (
            float(state.fc_requested), float(state.fc_programmed),
            float(state.fs_programmed),
            view(lay[10], torch.int64, (B, P, NR, 12)),
            view(lay[11], torch.float64, (B, P, NR, 12, 2)),
            view(lay[12], torch.int64, (B, NQ)),
            view(lay[13], torch.float64, (B, NQ)))
    return args, plans, (B, P, NR, NQ)


def download(packed: torch.Tensor) -> np.ndarray:
    """The tick's one download, as float64 (pinned staging on the
    card)."""
    if packed.device.type != "cuda":
        return packed.double().numpy()
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    torch.cuda.current_stream(packed.device).synchronize()
    return host.numpy().astype(np.float64)


def unpack(packed: np.ndarray, shape):
    """(ce_raw [B, P, NR, 12], spec_rows [B, NQ, 72], final [B])."""
    B, P, NR, NQ = shape
    n_ce = B * P * NR * 12
    n_sp = B * NQ * 72
    ce_re = packed[:n_ce].reshape(B, P, NR, 12)
    ce_im = packed[n_ce: 2 * n_ce].reshape(B, P, NR, 12)
    sp_re = packed[2 * n_ce: 2 * n_ce + n_sp].reshape(B, NQ, 72)
    sp_im = packed[2 * n_ce + n_sp: 2 * (n_ce + n_sp)].reshape(B, NQ, 72)
    final = packed[2 * (n_ce + n_sp):]
    return ce_re + 1j * ce_im, sp_re + 1j * sp_im, final


def batched_tick_extract(cell_pdus: Sequence[Tuple[object, object]],
                         state, raw_block: np.ndarray = None,
                         block_seq: int = -1, device=None,
                         timings: dict = None) -> None:
    """Run one tracker tick for every (processor, PduChunk) pair with
    the demod + CRS extraction on ``device`` (None = the card), then
    drive each processor's host control loops on the downloaded rows
    (TrackedCellProcessor.process_device).

    The planner reads the processors' (slot, sym) counters; the
    processors advance them when applying the tick.  ``timings``: if a
    dict is given, the wall seconds of the host staging with its upload
    ("stage", split as stage_tick says), the device program,
    synchronised ("program"; its launch alone "program.launch", a
    CUDA graph's capture within it "program.capture"), the
    download ("download") and the host control loops ("control", split
    as process_device says) are added to it (utils/debug.py::stage)."""
    with stage("stage", timings=timings):
        args, plans, shape = stage_tick(cell_pdus, state, raw_block,
                                        block_seq, device, timings=timings)
    with stage("program", timings=timings) as sp:
        with stage("program.launch", timings=timings):
            _launching.timings = timings
            try:
                out = _tick_program(*args)
            finally:
                _launching.timings = None
        if sp.on and out.device.type == "cuda":
            torch.cuda.current_stream(out.device).synchronize()
    with stage("download", timings=timings):
        packed = download(out)
    with stage("control", timings=timings, host=True):
        ce_raw, spec_rows, final = unpack(packed, shape)
        for b, ((proc, chunk), plan) in enumerate(zip(cell_pdus, plans)):
            slots_a, syms_a, _sh_all, rs_sel, spec_sel = plan
            proc.process_device(chunk, slots_a, syms_a, rs_sel,
                                ce_raw[b], spec_sel,
                                spec_rows[b, : len(spec_sel)],
                                float(final[b]), timings=timings)
