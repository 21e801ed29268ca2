"""Steady-state multi-cell tracker realtime benchmark of the port: the
counterpart of tools/bench_tracker.py.

    python3 tools_torch/bench_tracker.py [--cells 4] [--runs 3]
        [--seconds 5.5] [--snr 12] [--acq-seconds 30] [--block 10000]
        [--sweep] [--async-search] [--parallel N]
        [--device-loop auto|on|off] [--profile] [--device cuda|cpu]
        [--json]

Measures the streaming tracker's realtime factor (stream-seconds
processed per wall-clock second) with N simultaneous simulated eNodeBs,
the figure the reference documents as "can track approximately 4 cells
with two antenna ports" in realtime (doc/LTE-Tracker.html):

- N cells x 2 antenna ports from CELL_PLAN, distinct cell IDs and
  non-overlapping frame timings (distinct slot_start), summed at equal
  power + AWGN at --snr dB, +200 Hz, quantized to the dongle's 8-bit
  grid (the stream an RTL2832 delivers), in ticks of --block samples;
- acquisition streams until all N cells are tracked (untimed, at most
  --acq-seconds of stream), then
  ``--runs`` timed segments of ``--seconds`` stream-seconds each run
  through the full event loop (producer framing, the tick's device
  program, RS-window control loops, CE interpolation, MIB re-decodes,
  the background searcher at its duty-cycled cadence, inline or with
  --async-search on its worker thread); the signal is generated before
  each segment, outside the timing.  Best of runs is the result: the
  host is shared, and the best run the least preempted.  --sweep runs
  1..N cells.

Each result also carries the tick's time split over the timed segments
in ms per stream-second, the spans of ``TrackerRunner.timings``
(utils/debug.py::stage): producer, pop, stage = host staging and the
one upload (nested in it stage.inputs, stage.plan, stage.upload),
program = the device program, synchronised (program.launch, its
launch), download, control = host control loops (control.rs, the
RS-window chain; control.phase_c and in it control.mib, the MIB
re-decodes), search = inline searches; off the device loop fd and
control (control.phase_c, control.mib).  It carries the worst
tick, the cells' health and the frequency-offset register.  On the CPU
(``--device cpu``) the numbers describe the host, not any card.  Prints
one line per cell count, or one JSON line per cell count with --json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FC = 739e6
FS = 1.92e6
CHUNK_MS = 1000

# distinct (n_id_1, slot_start, sfn0) per cell; slot starts spread over
# the 10 ms frame so no two cells share symbol framing ticks
CELL_PLAN = [(92, 0, 4), (90, 7, 8), (88, 13, 16), (86, 5, 32),
             (84, 11, 64), (82, 17, 128), (80, 3, 256), (78, 9, 512)]


class MultiCellStream:
    """Endless summed N-eNodeB stream, generated in 1 s chunks.

    Each cell's CRS/PBCH sequence continues exactly across chunk
    boundaries (the SFN advances by CHUNK_MS/10 frames per chunk); only
    the random QPSK filler re-rolls, which no tracker stage depends on.
    """

    def __init__(self, n_cells, snr_db, f_off=200.0, seed=7):
        from lte_cell_scanner_tpu_torch.cell import CpType
        self.cp = CpType.NORMAL
        self.plan = CELL_PLAN[:n_cells]
        self.snr_db = snr_db
        self.f_off = f_off
        self.rng = np.random.default_rng(seed)
        self.chunk_idx = 0
        self.pending = np.zeros(0, np.complex64)
        self.pos = 0  # absolute sample index (continuous mixer phase)

    def _chunk(self):
        from lte_cell_scanner_tpu_torch.sim import awgn, create_dl_sig
        n = int(CHUNK_MS * FS / 1000)
        acc = np.zeros(n, np.complex128)
        frames_per_chunk = CHUNK_MS // 10
        for (n_id_1, slot_start, sfn0) in self.plan:
            sfn = (sfn0 + self.chunk_idx * frames_per_chunk) % 1024
            acc += create_dl_sig(self.cp, CHUNK_MS, slot_start, n_id_1, 1,
                                 0.4, rng=self.rng, n_ports=2, sfn=sfn)
        self.chunk_idx += 1
        t = self.pos + np.arange(n)
        acc *= np.exp(1j * 2 * np.pi * self.f_off * t / FS)
        self.pos += n
        sig = awgn(acc, self.snr_db, rng=self.rng)
        # the dongle source model (capbuf.cpp:174): per-plane RMS at
        # ~1/4 full scale, quantized onto the 8-bit (x-127)/128 grid --
        # what lets the device loop's upload ride exact float16 planes
        rms = float(np.sqrt(np.mean(sig.real ** 2 + sig.imag ** 2) / 2))
        s = 0.25 / max(rms, 1e-30)
        k_re = np.clip(np.round(sig.real * s * 128), -127, 128)
        k_im = np.clip(np.round(sig.imag * s * 128), -127, 128)
        return ((k_re + 1j * k_im) / 128.0).astype(np.complex64)

    def take(self, n: int) -> np.ndarray:
        """The next n samples (generated here, so callers keep the
        generation outside their timed regions)."""
        parts = [self.pending]
        have = len(self.pending)
        while have < n:
            c = self._chunk()
            parts.append(c)
            have += len(c)
        buf = np.concatenate(parts)
        self.pending = buf[n:]
        return buf[:n]


def bench_one(n_cells, runs, seconds, snr_db=12.0, verbose=True,
              profile=False, parallel=0, acq_seconds=30.0, device_loop=None,
              block=10000, device=None, search_async=False,
              stream=None) -> dict:
    """Acquire ``n_cells`` of the stream (MultiCellStream at ``snr_db``
    unless ``stream``, any object with take(n), is given) within
    ``acq_seconds`` of stream, then time ``runs`` segments of ``seconds``
    stream-seconds in ticks of ``block`` samples.  ``parallel`` > 1 ticks
    the cells on a pool of that many threads and ``device_loop`` picks
    the tick's route (TrackerRunner's ``parallel_cells`` and
    ``device_loop``: None = the device loop on the card); ``profile``
    prints cProfile's top entries of the timed segments to stderr.
    Returns the realtime factors, the tick split, the worst tick and the
    cells' state."""
    from lte_cell_scanner_tpu_torch.tracker import TrackerRunner

    stream = stream or MultiCellStream(n_cells, snr_db)
    runner = TrackerRunner(FC, FC, FS, device=device,
                           search_async=search_async,
                           parallel_cells=parallel, device_loop=device_loop)
    prof = None
    if profile:
        import cProfile
        prof = cProfile.Profile()
    try:
        t0 = time.perf_counter()
        runner.warmup()
        warmup_s = time.perf_counter() - t0

        # acquisition (untimed): all N cells tracked
        fed = 0
        limit = int(acq_seconds * FS)
        while len(runner.cells) < n_cells:
            runner.process_block(stream.take(block))
            fed += block
            if fed > limit:
                raise RuntimeError(
                    f"acquired only {len(runner.cells)}/{n_cells} cells "
                    f"in {fed / FS:.1f} s of stream")
        acq_s = fed / FS
        # settle: let the last cell reach MIB sync before timing
        for _ in range(int(0.5 * FS) // block):
            runner.process_block(stream.take(block))

        n_blocks = int(seconds * FS) // block
        factors, ticks = [], []
        runner.timings = {}
        searches = 0
        for r in range(runs):
            seg = stream.take(n_blocks * block)
            t_run = time.perf_counter()
            if prof is not None:
                prof.enable()
            for i in range(n_blocks):
                t = time.perf_counter()
                busy = runner._search_future is not None
                runner.process_block(seg[i * block: (i + 1) * block])
                ticks.append((time.perf_counter() - t, busy))
                searches += runner._last_search_at == runner._samples_fed
            if prof is not None:
                prof.disable()
            wall = time.perf_counter() - t_run
            factors.append(n_blocks * block / FS / wall)
            if verbose:
                print(f"  run {r + 1}: {n_blocks * block / FS:.1f} s stream "
                      f"/ {wall:.3f} s wall = {factors[-1]:.2f}x realtime",
                      file=sys.stderr)
        if prof is not None:
            import pstats
            pstats.Stats(prof, stream=sys.stderr).sort_stats(
                "cumulative").print_stats(35)
        stream_s = runs * n_blocks * block / FS
        during = [t for t, busy in ticks if busy]
        cells = [{"n_id_cell": tc.n_id_cell, "health": tc.health_pct(),
                  "mib_synced": runner.processors[
                      tc.n_id_cell].mib_fifo_synchronized,
                  "frame_timing": tc.frame_timing,
                  "mib_decode_failures": tc.mib_decode_failures}
                 for tc in runner.cells]
        return {
            "cells": n_cells, "value": max(factors), "factors": factors,
            "healthy": all(c["health"] > 95.0 for c in cells),
            "split_ms_per_stream_s": {
                k: 1e3 * v / stream_s for k, v in runner.timings.items()},
            "worst_tick_ms": 1e3 * max(t for t, _ in ticks),
            "median_tick_ms": 1e3 * float(np.median([t for t, _ in ticks])),
            "worst_tick_ms_search_in_flight":
                1e3 * max(during) if during else None,
            "ticks_search_in_flight": len(during),
            "searches_integrated": int(searches),
            "tick_ms_stream": 1e3 * block / FS, "snr_db": snr_db,
            "parallel_cells": parallel, "device_loop": device_loop,
            "frequency_offset": runner.state.frequency_offset,
            "warmup_s": warmup_s, "acquisition_stream_s": acq_s,
            "tracked": cells}
    finally:
        runner.close()


def device_name(device):
    """The device's name for the result lines, or None when it is a
    card and none is present."""
    import torch

    from lte_cell_scanner_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return str(dev)
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev)


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (its first
    line), for the benches' result lines; the device's name off the
    card, or when nvidia-smi does not run."""
    import subprocess

    from lte_cell_scanner_tpu_torch.device import resolve_device
    name = device_name(device)
    if name is None or resolve_device(device).type != "cuda":
        return name
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
        return out[0] if out else name
    except (OSError, subprocess.SubprocessError):
        return name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.5)
    ap.add_argument("--snr", type=float, default=12.0)
    ap.add_argument("--acq-seconds", type=float, default=30.0,
                    help="acquisition stream budget before giving up "
                         "(co-channel cells interfere; high counts "
                         "acquire slowly)")
    ap.add_argument("--sweep", action="store_true",
                    help="bench 1..--cells instead of just --cells")
    ap.add_argument("--block", type=int, default=10000,
                    help="samples per process_block tick")
    ap.add_argument("--profile", action="store_true",
                    help="cProfile the timed segments, print top stats")
    ap.add_argument("--parallel", type=int, default=0,
                    help=">1: per-cell tracker ticks on a thread pool "
                         "(the reference's thread-per-cell layout; only "
                         "off the device loop)")
    ap.add_argument("--device-loop", default="auto",
                    choices=["auto", "on", "off"],
                    help="the tick's route: the device loop (one upload, "
                         "one program, one download per tick) or the "
                         "batched host path; auto = on on the card")
    ap.add_argument("--async-search", action="store_true",
                    help="the background searcher on its worker thread")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    kind = device_name(args.device)
    if kind is None:
        print("FAIL: no CUDA device", flush=True)
        return 1
    counts = range(1, args.cells + 1) if args.sweep else [args.cells]
    for n in counts:
        print(f"[{n} cell(s)]", file=sys.stderr)
        res = bench_one(n, args.runs, args.seconds, args.snr,
                        profile=args.profile, parallel=args.parallel,
                        acq_seconds=args.acq_seconds,
                        device_loop={"auto": None, "on": True,
                                     "off": False}[args.device_loop],
                        block=args.block, device=args.device,
                        search_async=args.async_search)
        if args.json:
            print(json.dumps({"metric": "tracker_realtime_factor",
                              "unit": "x_realtime", "device": kind, **res}))
        else:
            print(f"{n} cells: {res['value']:.2f}x realtime on {kind}"
                  + ("" if res["healthy"] else " (degraded health)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
