"""Stage-by-stage cost of the port's lean PSS front end: the counterpart
of tools/bench_front_stages.py.

    python3 tools_torch/bench_front_stages.py [--ppm 100] [--inner 8]
        [--repeats 5] [--stages kern,fold,ds,slab,sp,full] [--adc-grid]
        [--samples N] [--device cuda|cpu] [--json]

Times cumulative prefixes of one carrier's lean front end
(``models/xcorr.py``, the single-carrier route of ``cell_search``), each
built from the production functions:

  kern   the correlation map kernel alone (``_corr_stage``: the
         pss_corr_bf16 map, or pss_corr_int8 with --adc-grid; on the CPU
         their plain versions)
  fold   + the k_factor incoherent fold (``_fold_stage``)
  ds     + delay-spread combining and the hypothesis collapse
         (``_ds_collapse``)
  slab   + the refinement slab (``_refine_slab``)
  sp     + the fold-then-window sp_est (``_sp_est``)
  full   the production lean front end (``xcorr_core(lean=True)``)

The TPU tool's ``gslab`` stage (a retired gather-based slab) has no
counterpart: the port only ever had the production slab.  Its
``--carriers`` context (vmapped carriers) is ``tools_torch/
bench_carriers.py`` here.

Per stage two figures, each the median of --repeats windows of --inner
back-to-back calls on distinct rolled captures: ``{stage}_ms``, the wall
time per call with the window synchronised at its end (the pipelined
cost, whichever of host and device is slower), and
``{stage}_issue_ms``, the host's time to issue the calls of the window
before that synchronisation (its dispatch cost: CUDA launches return at
once, so when issue_ms is close to ms the stage is bound by the host's
dispatch, not by the card).  Capture: the synthetic two-cell capture
(``sim/scenarios.py::two_cell_capture``), on the 8-bit grid with
--adc-grid.  Prints one line per figure, or one JSON line with --json
(with the card's name and power limit on the card).
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

FC = 739e6
STAGES = ("kern", "fold", "ds", "slab", "sp", "full")


def stage_fns(cap0, f_set, dev):
    """The cumulative prefixes, each a function of a capture tensor on
    ``dev`` (staged once, as the main path stages one carrier)."""
    from lte_cell_scanner_tpu_torch.constants import DS_COMB_ARM, FS_WORK
    from lte_cell_scanner_tpu_torch.models.xcorr import (
        _corr_stage, _ds_collapse, _fold_stage, _front_staging,
        _refine_slab, _sp_est, xcorr_core)
    _cap_t, _tmpl, starts, kern, _n = _front_staging(
        cap0, f_set, FC, FC, FS_WORK, "kernel", dev, None, True)
    arm = DS_COMB_ARM

    def prefix(upto):
        def run(cap_t):
            xc2, _xc, pw = _corr_stage(cap_t, None, False, kern)
            if upto == "kern":
                return xc2
            xc_single = _fold_stage(xc2, starts, cap_t.real.dtype, pw)[None]
            if upto == "fold":
                return xc_single
            _inc, pow_c, frq_c = _ds_collapse(xc_single, arm)
            if upto == "ds":
                return pow_c
            slab = _refine_slab(xc_single, frq_c, arm)
            if upto == "slab":
                return slab
            return _sp_est(cap_t[None], True)
        return run

    fns = {name: prefix(name) for name in STAGES[:-1]}
    fns["full"] = lambda cap_t: xcorr_core(cap_t, None, starts, arm, False,
                                           True, kern)
    return fns, kern


def timed(fn, bufs, sync):
    """One window: ``fn`` on each of ``bufs`` back to back, synchronised
    at the end.  Returns (wall, issue) seconds per call: the window's
    time to the synchronisation, and the host's time to issue it."""
    t0 = time.perf_counter()
    for buf in bufs:
        fn(buf)
    t1 = time.perf_counter()
    sync()
    t2 = time.perf_counter()
    return (t2 - t0) / len(bufs), (t1 - t0) / len(bufs)


def main(argv=None) -> int:
    import torch

    from tools_torch.bench_tracker import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--ppm", type=float, default=100.0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--adc-grid", action="store_true",
                    help="the capture on the dongle's 8-bit grid (the "
                         "int8 map kernel)")
    ap.add_argument("--samples", type=int, default=153600,
                    help="capture length (the 80 ms capture by default)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    card = card_line(args.device)
    if card is None:
        print("FAIL: no CUDA device", flush=True)
        return 1
    names = args.stages.split(",")
    bad = [s for s in names if s not in STAGES]
    if bad:
        raise ValueError(f"unknown stages {bad}; known: {STAGES}")

    from lte_cell_scanner_tpu_torch.device import resolve_device, to_capture
    from lte_cell_scanner_tpu_torch.models.search import default_f_search_set
    from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                          two_cell_capture)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cap = two_cell_capture(seed=0, f_off=35e3, fc=FC)[: args.samples]
    if args.adc_grid:
        cap = adc_quantize(cap)
    f_set = default_f_search_set(FC, args.ppm)
    fns, kern = stage_fns(cap, f_set, dev)
    bufs = [to_capture(np.roll(cap, 131 * r + 977 * k + 1), dev)
            for k in range(args.repeats) for r in range(args.inner)]
    res = {"device": card, "kernel": f"pss_corr_{kern.precision}",
           "n_templates": int(kern.taps.shape[1]),
           "samples": len(cap), "inner": args.inner,
           "repeats": args.repeats}
    for name in names:
        fns[name](bufs[0])                                   # warm-up
        sync()
        windows = [timed(fns[name], bufs[k * args.inner:
                                         (k + 1) * args.inner], sync)
                   for k in range(args.repeats)]
        res[f"{name}_ms"] = 1e3 * statistics.median(w for w, _ in windows)
        res[f"{name}_issue_ms"] = 1e3 * statistics.median(
            i for _, i in windows)
    if args.json:
        print(json.dumps(res))
    else:
        print("\n".join(f"{k:14} {v}" for k, v in res.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
