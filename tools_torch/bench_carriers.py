"""Band-scan rate of the port: the counterpart of tools/bench_carriers.py.

    python3 tools_torch/bench_carriers.py [--batches 1,2,4,8,16,32]
        [--ppm 100] [--repeats 5] [--kernel auto|v4|v2] [--capture-ms 80]
        [--adc-grid] [--full-chain] [--device cuda|cpu] [--json]

A band scan batches many carriers' captures into one front-end call
(``parallel/carriers.py``: the carriers are the batch axis).  Two modes,
both reporting ``carriers_per_s`` per batch size C, as the TPU tool
does:

- default, the front end alone: ``_front_batch`` (correlation and
  k_factor fold, delay-spread combining, hypothesis collapse, sp_est,
  the refinement slab) on C carriers planned at fc + 100 kHz * c as
  ``scan_band`` plans them; on the card the fused v4 kernel
  (pss_corr_fold_bf16, pss_corr_fold_int8 with --adc-grid), or the v2
  map kernel carrier by carrier with --kernel v2.  --repeats calls on
  distinct rolled captures, synchronised once at the end.
- --full-chain, through MIB: ``scan_band`` itself (batched front end,
  device peak search, batched SSS/FOE, fused decode; over every visible
  card when there are several) on C rolled copies
  of a capture that holds two cells, one warm-up then --repeats timed
  calls; ``cells_per_carrier`` and ``cell_ids`` say what decoded (a
  cyclic roll leaves one seam in the capture, so a cell whose only
  complete 40 ms PBCH period straddles it can fail its MIB).

Capture: the synthetic two-cell capture
(``sim/scenarios.py::two_cell_capture``: cells 277 and 271 at +35 kHz),
tiled to --capture-ms, and on the dongle's 8-bit grid with --adc-grid
(rolls keep the grid).  The reference scans carriers serially at ~6 s
each (BASELINE.md), 1/6 carrier/s; ``vs_reference`` is against that.
Prints one line per batch size, or one JSON line with --json (with the
card's name and power limit on the card).
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
REF_CARRIERS_PER_S = 1.0 / 6.0


def _route_name(route) -> str:
    if route.kern is None:
        return "exact"
    return ("v4_" if route.mid_starts is not None else "v2_") \
        + route.kern.precision


def front_rows(base, f_set, batches, repeats, kernel, dev, sync):
    """carriers/s of the front end alone per batch size."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.device import to_capture
    from lte_cell_scanner_tpu_torch.models.search import SearchConfig
    from lte_cell_scanner_tpu_torch.parallel.carriers import (
        BandRoute, _front_batch, _plan_scan_bands, plan_carrier_inputs)

    rows = []
    for C in batches:
        fcs = [FC + 100e3 * i for i in range(C)]
        _cap, tmpl, starts, _n, _c = plan_carrier_inputs(
            [base] * C, fcs, f_set, fcs, FS_WORK)
        route = _plan_scan_bands(tmpl, starts, [base], SearchConfig(), dev)
        if kernel == "v2" or (kernel == "v4" and route.mid_starts is None):
            if kernel == "v4":
                raise ValueError("the v4 gate refuses this grid")
            route = BandRoute(route.kern)
        bufs = [to_capture(np.stack([np.roll(base, 31 * i + 977 * k + 1)
                                     for i in range(C)]), dev)
                for k in range(repeats + 1)]
        _front_batch(bufs[0], tmpl, starts, route, 2)       # warm-up
        sync()
        t0 = time.perf_counter()
        for buf in bufs[1:]:
            _front_batch(buf, tmpl, starts, route, 2)
        sync()
        dt = (time.perf_counter() - t0) / repeats
        rows.append({"carriers": C, "ms": dt * 1e3,
                     "carriers_per_s": C / dt,
                     "samples_per_s": C * len(base) / dt,
                     "route": _route_name(route)})
        del bufs
    return rows


def chain_rows(base, f_set, batches, repeats, dev, sync):
    """carriers/s through MIB (scan_band end to end) per batch size, over
    every visible card when there are several (as the TPU tool spreads
    the band over its mesh)."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.device import visible_devices
    from lte_cell_scanner_tpu_torch.parallel.carriers import scan_band

    devices = visible_devices(dev)
    place = {"mesh": devices} if len(devices) > 1 else {"device": dev}
    rows = []
    for C in batches:
        fcs = [FC + 100e3 * i for i in range(C)]
        reps = [[(np.roll(base, 31 * i + 977 * k + 1), fcs[i], fcs[i])
                 for i in range(C)] for k in range(repeats + 1)]
        res = scan_band(reps[0], f_set, FS_WORK, **place)   # warm-up
        sync()
        t0 = time.perf_counter()
        for caps in reps[1:]:
            res = scan_band(caps, f_set, FS_WORK, **place)
        sync()
        dt = (time.perf_counter() - t0) / repeats
        n_cells = sum(len(r) for r in res)
        rows.append({"carriers": C, "ms": dt * 1e3,
                     "carriers_per_s": C / dt,
                     "cells_per_carrier": n_cells / C,
                     "cell_ids": sorted({c.n_id_cell() for r in res
                                         for c in r})})
    return rows


def main(argv=None) -> int:
    import torch

    from tools_torch.bench_tracker import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,2,4,8,16,32")
    ap.add_argument("--ppm", type=float, default=100.0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--kernel", default="auto", choices=["auto", "v4", "v2"],
                    help="front-end route: v4 = the fused correlation and "
                         "fold kernel, v2 = the map kernel and the fold, "
                         "auto = the band scan's gate")
    ap.add_argument("--capture-ms", type=int, default=80)
    ap.add_argument("--adc-grid", action="store_true",
                    help="the capture on the dongle's 8-bit grid (the "
                         "int8 kernels)")
    ap.add_argument("--full-chain", action="store_true",
                    help="carriers/s through MIB: scan_band end to end")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    card = card_line(args.device)
    if card is None:
        print("FAIL: no CUDA device", flush=True)
        return 1

    from lte_cell_scanner_tpu_torch.device import resolve_device
    from lte_cell_scanner_tpu_torch.models.search import default_f_search_set
    from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                          two_cell_capture)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = two_cell_capture(seed=0, f_off=35e3, fc=FC)
    if args.capture_ms != 80:
        n = int(args.capture_ms * 1920)
        base = np.tile(base, -(-n // len(base)))[:n]
    if args.adc_grid:
        base = adc_quantize(base)
    f_set = default_f_search_set(FC, args.ppm)
    batches = [int(x) for x in args.batches.split(",")]
    if args.full_chain:
        rows = chain_rows(base, f_set, batches, args.repeats, dev, sync)
    else:
        rows = front_rows(base, f_set, batches, args.repeats, args.kernel,
                          dev, sync)
    best = max(rows, key=lambda r: r["carriers_per_s"])
    out = {"device": card, "mode": "full_chain" if args.full_chain
           else "front_end", "adc_grid": args.adc_grid,
           "capture_ms": args.capture_ms, "n_hyp": len(f_set), "rows": rows,
           "best_carriers_per_s": best["carriers_per_s"],
           "vs_reference": best["carriers_per_s"] / REF_CARRIERS_PER_S}
    if args.json:
        print(json.dumps(out))
    else:
        for r in rows:
            extra = f"{r['route']}" if "route" in r else \
                f"{r['cells_per_carrier']:.2f} cells/carrier {r['cell_ids']}"
            print(f"C={r['carriers']:3d}  {r['ms']:9.2f} ms  "
                  f"{r['carriers_per_s']:9.2f} carriers/s  [{extra}]")
        print(f"best {best['carriers_per_s']:.2f} carriers/s on {card} "
              f"({out['mode']}) = {out['vs_reference']:.0f}x the "
              f"reference's 1/6 carrier/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
