"""The tracker's device-loop program alone, across batch shapes: the
counterpart of tools/bench_tracker_device.py.

    python3 tools_torch/bench_tracker_device.py [--cells 1,4,16,64]
        [--syms 64,256,1024] [--repeats 20] [--device cuda|cpu] [--json]

The tracker's FLOPs live in get_fd (ICI-removal mixer, 128-point DFT,
72-subcarrier extract, phase compensation -- reference
tracker_thread.cpp:91-174); the device loop
(tracker/device_loop.py::_tick_program) runs it for all tracked cells'
pending symbols as one [cells, symbols, 128] batch, then gathers the CRS
and special rows into one packed vector.  This bench stages a tick of B
cells (2 ports, normal CP) x S symbols from one random raw block through
the tracker's own staging (stage_tick: host plans and the one upload,
done once), then times the program alone, twice: dispatched eagerly
(_tick_math) and as the tracker runs it (_tick_program, which replays a
CUDA graph on the card).  Each is the median over --repeats windows of 5
calls, in CUDA events on the card and the host clock on the CPU, and in
host time per call (the launches alone on the card).  The host staging,
the download and the control loops are not in the number
(tools_torch/bench_tracker.py measures the whole tick).  Each row gives
ms per call of each, symbols per second and the implied realtime factor
of the eager call (B x S symbols of 1.92 Msps stream, 137.14 samples per
symbol).  Prints one JSON line with --json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FS = 1.92e6
FC = 739e6
SAMP_PER_SYM = 19200 / 140.0          # 137.14 avg samples per symbol


def staged_cells(B: int, S: int, adc_grid: bool = False, seed: int = 0):
    """A tick's inputs for B cells (2 ports, normal CP) x S symbols, all
    framed from one random raw block: ((processor, PduChunk) pairs, the
    shared state, the block).  adc_grid puts the block on the dongle's
    8-bit (x - 127)/128 grid, as a u8 stream's blocks are."""
    from lte_cell_scanner_tpu_torch.cell import CpType
    from lte_cell_scanner_tpu_torch.tracker.cell_tracker import \
        TrackedCellProcessor
    from lte_cell_scanner_tpu_torch.tracker.producer import PduChunk
    from lte_cell_scanner_tpu_torch.tracker.state import (GlobalState,
                                                          TrackedCell)

    rng = np.random.default_rng(seed)
    L = 137 * S + 256
    block = (rng.normal(size=L) + 1j * rng.normal(size=L)) * 0.1
    if adc_grid:
        block = (np.clip(np.round(block.real * 128), -127, 128)
                 + 1j * np.clip(np.round(block.imag * 128), -127, 128)) / 128
    state = GlobalState(fc_requested=FC, fc_programmed=FC, fs_programmed=FS,
                        frequency_offset=-2050.0)
    pairs = []
    for b in range(B):
        n_id = 3 * b + 1
        cell = TrackedCell(n_id_cell=n_id, n_id_1=n_id // 3, n_id_2=n_id % 3,
                           cp_type=CpType.NORMAL, n_ports=2,
                           frame_timing=0.0)
        starts = (b % 128) + 137 * np.arange(S)
        pairs.append((TrackedCellProcessor(cell, state), PduChunk(
            data=np.stack([block[s: s + 128] for s in starts]),
            late=np.zeros(S), fo=np.full(S, -2050.0), ft=np.zeros(S),
            sym0=0, start=starts.astype(np.int64), block_seq=1)))
    return pairs, state, block


def staged_tick(B: int, S: int, device, adc_grid: bool = False,
                seed: int = 0):
    """The arguments of _tick_program for staged_cells(B, S, adc_grid,
    seed), staged by the tracker's own stage_tick: float16 planes on
    the ADC grid, else float64."""
    from lte_cell_scanner_tpu_torch.tracker.device_loop import stage_tick
    pairs, state, block = staged_cells(B, S, adc_grid, seed)
    args, _plans, _shape = stage_tick(pairs, state, raw_block=block,
                                      block_seq=1, device=device)
    return args


def _time(fn, args, repeats: int, cuda: bool):
    """(device ms, host ms) per call: the medians over ``repeats``
    windows of 5 calls, CUDA events and the host's clock around the
    launches (the host clock alone on the CPU, where both are one)."""
    import torch
    per = 5
    dev_ms, host_ms = [], []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(per):
            fn(*args)
        host_ms.append((time.perf_counter() - t0) * 1e3 / per)
        if cuda:
            end.record()
            end.synchronize()
            dev_ms.append(start.elapsed_time(end) / per)
    host = statistics.median(host_ms)
    return (statistics.median(dev_ms) if cuda else host), host


def bench_shape(B: int, S: int, repeats: int, device) -> dict:
    from lte_cell_scanner_tpu_torch.tracker.device_loop import (_tick_math,
                                                                _tick_program)
    args = staged_tick(B, S, device)
    cuda = args[3].device.type == "cuda"
    for _ in range(3):       # the eager run, the capture, a replay
        _tick_program(*args)
    ms, host_ms = _time(_tick_math, args, repeats, cuda)
    replay_ms, replay_host_ms = _time(_tick_program, args, repeats, cuda)
    stream_s = B * S * SAMP_PER_SYM / FS
    return {"cells": B, "syms": S, "ms_per_call": ms,
            "host_ms_per_call": host_ms, "replay_ms_per_call": replay_ms,
            "replay_host_ms_per_call": replay_host_ms,
            "sym_per_s": B * S / (ms * 1e-3),
            "realtime_factor": stream_s / (ms * 1e-3),
            "replay_realtime_factor": stream_s / (replay_ms * 1e-3)}


def main(argv=None) -> int:
    from tools_torch.bench_tracker import device_name

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="1,4,16,64")
    ap.add_argument("--syms", default="64,256,1024")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    kind = device_name(args.device)
    if kind is None:
        print("FAIL: no CUDA device", flush=True)
        return 1
    rows = [bench_shape(B, S, args.repeats, args.device)
            for B in (int(x) for x in args.cells.split(","))
            for S in (int(x) for x in args.syms.split(","))]
    best = max(rows, key=lambda r: r["realtime_factor"])
    out = {"device": kind, "rows": rows,
           "best_realtime_factor": best["realtime_factor"],
           "best_shape": [best["cells"], best["syms"]]}
    if args.json:
        print(json.dumps(out))
    else:
        print("                   eager ms (host)      replayed ms (host)")
        for r in rows:
            print(f"B={r['cells']:3d} S={r['syms']:5d}  "
                  f"{r['ms_per_call']:8.4f} ({r['host_ms_per_call']:7.4f})  "
                  f"{r['replay_ms_per_call']:8.4f} "
                  f"({r['replay_host_ms_per_call']:7.4f})  "
                  f"{r['sym_per_s']:14.0f} sym/s  "
                  f"{r['realtime_factor']:10.2f}x realtime")
        print(f"best: {best['realtime_factor']:.2f}x realtime at "
              f"[{best['cells']} cells x {best['syms']} syms] on {kind}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
