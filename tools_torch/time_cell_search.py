"""Time the port's single-carrier ``cell_search`` and its band scan on one
NVIDIA GPU, for comparing two versions of the port within one machine
session.

    python3 tools_torch/time_cell_search.py [--root DIR] [--label NAME]

Imports ``lte_cell_scanner_tpu_torch`` from DIR (default: this checkout),
so the same script times an unpacked older tree beside the current one;
run the versions in alternation (old, new, new, old) in one session, as
host-side stages drift between sessions.  For the two-cell 739 MHz
capture, float (bf16 kernel) and on the 8-bit ADC grid (int8 kernel), at
+-100 ppm: the wall seconds of ``cell_search`` synchronised at both ends
(no stage timings), each of ``--reps`` runs after two warm-ups, and one
run under torch.profiler (device operations, device-busy seconds).  Then
``scan_band`` over the 101-carrier band of ``sim/scenarios.py::
band_captures`` (float and ADC grid, chunks of 64, the carriers_per_s of
``chip_smoke.py`` phase 7): carriers per second of each of ``--reps``
runs after one warm-up.  Prints one JSON line per capture and per band.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import sys
import time

FC = 739e6
PPM = 100.0


def profile_run(run):
    """(device operations, device-busy seconds, wall seconds) of one
    run() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ops), sum(e.device_time_total for e in ops) / 1e6, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import lte_cell_scanner_tpu_torch as port
    if root not in pathlib.Path(port.__file__).resolve().parents:
        print(f"FAIL: imported the port from {port.__file__}, not {root}")
        return 1
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import (
        cell_search, default_f_search_set)
    from lte_cell_scanner_tpu_torch.parallel.carriers import scan_band
    from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                          band_captures,
                                                          two_cell_capture)

    f_set = default_f_search_set(FC, PPM)
    cap_float = two_cell_capture(seed=0, f_off=35e3, fc=FC)
    for name, cap in (("float", cap_float), ("adc", adc_quantize(cap_float))):
        def run():
            return cell_search(cap, f_set, FC, FC, FS_WORK, device="cuda")
        for _ in range(2):
            cells = run()
        totals = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            totals.append(time.perf_counter() - t0)
        n_ops, busy, wall = profile_run(run)
        print(json.dumps({
            "label": args.label, "capture": name,
            "capture_sha1": hashlib.sha1(cap.tobytes()).hexdigest()[:12],
            "cells": sorted(c.n_id_cell() for c in cells),
            "s_per_carrier_median": statistics.median(totals),
            "totals": totals, "profiled_device_ops": n_ops,
            "profiled_busy_s": busy, "profiled_wall_s": wall}), flush=True)

    for name, band in zip(("float band", "adc band"), band_captures()):
        def run_band():
            return scan_band(band, f_set, FS_WORK, device="cuda",
                             max_carriers_per_program=64)
        lists = run_band()
        totals = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_band()
            torch.cuda.synchronize()
            totals.append(time.perf_counter() - t0)
        print(json.dumps({
            "label": args.label, "capture": name,
            "cells": sorted(c.n_id_cell() for cells in lists for c in cells),
            "carriers_per_s_median": len(band) / statistics.median(totals),
            "totals": totals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
