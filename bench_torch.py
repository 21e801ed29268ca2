"""Benchmark of the PyTorch/CUDA port on one NVIDIA GPU: PSS-scan
throughput and the full single-carrier chain (the counterpart of
bench.py).

    python3 bench_torch.py [--device cuda] [--carriers 64] [--capture FILE]
        [--ppm 100] [--rounds 5] [--iters 6] [--runs 5]

Prints ONE JSON line:
  {"metric": "pss_scan_samples_per_sec", "value": N, "unit": "samples/s",
   "value_min", "value_max", "n_rounds", "vs_baseline", "useful_tflops",
   "datasheet_peak_tflops", "share_of_datasheet_peak", "route",
   "full_chain": {...}}

Capture: ``--capture FILE`` reads a recorded ``capbuf`` .it file (the
reference's test/capbuf_0000.it); without it, the synthetic two-cell
capture ``sim/scenarios.py::two_cell_capture(seed=0, f_off=35e3,
fc=739e6)`` (cells 277 and 271 at +35 kHz).  bench.py falls back to pure
noise when the recorded file is absent, on which ``valid`` can never be
true; the synthetic capture decodes.

Primary metric: the production band front end, ``parallel/carriers.py``
``_front_batch`` (correlation and k_factor fold, delay-spread combining,
hypothesis collapse, sp_est and the refinement slab) on --carriers rolled
copies of the capture, each carrier planned at fc + 100 kHz * c as
scan_band plans it: on the card the fused v4 kernel (pss_corr_fold_bf16,
or pss_corr_fold_int8 on an 8-bit ADC-grid capture) on the tensor cores,
one launch per call.  Rounds of --iters calls on distinct captures,
synchronised once per round; the median round per carrier gives the rate
(min and max beside it).  Reported per carrier as samples/s, against the
reference CellSearch's 6 s per carrier on a dual-core i7-2640
(BASELINE.md: 25.6k samples/s), and as useful TF/s (8 real operations
per complex tap, template and lag) with its share of the H100 SXM
data-sheet peak of the route's operand type (989 TF/s bf16, 1979 TOPS
int8, dense).

full_chain: ``cell_search`` on the capture (front end and device peak
search, fused SSS + fine FOE, fused decode), one warm-up then --runs
runs, each synchronised at both ends; its stage seconds from
``timings=`` (each stage synchronised).  ``valid`` is true when exactly
cells 271 and 277 decode.  ``bytes_uploaded`` counts the capture's one
copy to the card per run (complex64; 0 on the CPU).

``--device cpu`` runs the same code on the CPU (the exact correlation, no
kernel; float64), small with ``--carriers 2 --ppm 5``, for tests.  Exits
non-zero without a CUDA device when --device is cuda.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

FC = 739e6
BASELINE_SAMPLES_PER_S = 153600 / 6.0
PEAK_TFLOPS = {"bf16": 989.0, "int8": 1979.0}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_capture(path) -> np.ndarray:
    if path:
        from lte_cell_scanner_tpu_torch.utils.itfile import read_itfile
        return np.asarray(read_itfile(path)["capbuf"])
    from lte_cell_scanner_tpu_torch.sim.scenarios import two_cell_capture
    return two_cell_capture(seed=0, f_off=35e3, fc=FC)


def scan_rate(capbuf: np.ndarray, f_set: np.ndarray, n_c: int,
              dev: torch.device, rounds: int, iters: int) -> dict:
    """The band front end on n_c rolled copies per call; per-carrier
    seconds of the median, fastest and slowest round."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import SearchConfig
    from lte_cell_scanner_tpu_torch.parallel.carriers import (
        _front_batch, _plan_scan_bands, plan_carrier_inputs)

    n = len(capbuf)
    fcs = [FC + 1e5 * c for c in range(n_c)]
    # staging once, as scan_band stages a chunk: templates, fold starts,
    # the route and its operands
    _cap, tmpl, starts, _nc, _c = plan_carrier_inputs(
        [capbuf] * n_c, fcs, f_set, fcs, FS_WORK)
    route = _plan_scan_bands(tmpl, starts, [capbuf], SearchConfig(), dev)
    from lte_cell_scanner_tpu_torch.device import to_capture
    bufs = [to_capture(np.roll(capbuf, 977 * k + 1), dev)
            for k in range(rounds * iters)]
    # carrier c reads the call's capture rolled by 977 c + 7 (one gather)
    shifts = torch.tensor([977 * c + 7 for c in range(n_c)], device=dev)
    roll_idx = (torch.arange(n, device=dev)[None, :] - shifts[:, None]) % n

    def call(buf):
        return _front_batch(buf[roll_idx], tmpl, starts, route, 2)

    call(bufs[0])
    _sync(dev)
    round_s = []
    for r in range(rounds):
        t0 = time.perf_counter()
        for buf in bufs[r * iters: (r + 1) * iters]:
            call(buf)
        _sync(dev)
        round_s.append((time.perf_counter() - t0) / iters / n_c)
    precision = None if route.kern is None else route.kern.precision
    return {"median": statistics.median(round_s), "min": min(round_s),
            "max": max(round_s),
            "route": "exact" if precision is None else
            ("v4_" if route.mid_starts is not None else "v2_") + precision,
            "precision": precision, "n_t": tmpl.shape[1] * tmpl.shape[2]}


def full_chain(capbuf: np.ndarray, fc: float, f_set: np.ndarray,
               dev: torch.device, runs: int) -> dict:
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import cell_search

    def run(timings=None):
        return cell_search(capbuf, f_set, fc, fc, FS_WORK, device=dev,
                           timings=timings)

    run()                                          # warm-up
    totals = []
    for _ in range(runs):
        _sync(dev)
        t0 = time.perf_counter()
        cells = run()
        _sync(dev)
        totals.append(time.perf_counter() - t0)
    stages = []
    for _ in range(runs):
        st = {}
        run(st)
        stages.append(st)
    med = statistics.median(totals)
    ids = sorted(c.n_id_cell() for c in cells)
    return {"s_per_carrier": med, "s_per_carrier_min": min(totals),
            "s_per_carrier_max": max(totals), "n_runs": runs,
            "vs_baseline": 6.0 / med, "n_cells": len(cells),
            "cell_ids": ids, "valid": ids == [271, 277],
            "bytes_uploaded": len(capbuf) * 8 if dev.type == "cuda" else 0,
            "stages_ms": {k: 1e3 * statistics.median(s[k] for s in stages)
                          for k in stages[0]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--carriers", type=int, default=64,
                    help="carriers per front-end call (scan_band's chunk)")
    ap.add_argument("--capture", default=None,
                    help="a recorded capbuf .it file (default: the "
                         "synthetic two-cell capture)")
    ap.add_argument("--ppm", type=float, default=100.0)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from lte_cell_scanner_tpu_torch.models.search import default_f_search_set

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    capbuf = load_capture(args.capture)
    f_set = default_f_search_set(FC, args.ppm)
    rate = scan_rate(capbuf, f_set, args.carriers, dev, args.rounds,
                     args.iters)
    n = len(capbuf)
    tflops = 8.0 * rate["n_t"] * 137 * (n - 136) / rate["median"] / 1e12
    peak = PEAK_TFLOPS.get(rate["precision"])
    out = {"metric": "pss_scan_samples_per_sec",
           "value": n / rate["median"], "unit": "samples/s",
           "value_min": n / rate["max"], "value_max": n / rate["min"],
           "n_rounds": args.rounds,
           "vs_baseline": n / rate["median"] / BASELINE_SAMPLES_PER_S,
           "useful_tflops": tflops, "datasheet_peak_tflops": peak,
           "share_of_datasheet_peak": None if peak is None
           else tflops / peak,
           "route": rate["route"], "carriers": args.carriers,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "full_chain": full_chain(capbuf, FC, f_set, dev, args.runs)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
