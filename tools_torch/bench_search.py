"""Full-capture cell-search latency of the port: the counterpart of
tools/bench_search.py.

    python3 tools_torch/bench_search.py [--repeats 5] [--ppm 100]
        [--adc-grid] [--device cuda|cpu] [--json]

Times the complete per-carrier pipeline on one 80 ms capture: the PSS
correlation front end over the +-ppm hypothesis grid (the CUDA map
kernel on the card: pss_corr_bf16, or pss_corr_int8 with --adc-grid),
chi-squared thresholding and the greedy host peak search, then the
per-peak back half (SSS detection, fine FOE, OFDM demod, superfine
FOE/TOE, channel estimation, blind MIB decode) through to the decoded
cell list, as the TPU tool splits it: front end, back half peak at a
time (the reference's order) and as one peak batch (the default).  Then
``cell_search`` itself, the production route (on the card the peak
search runs on the device), with its stage seconds (``timings=``, each
stage synchronised).  Each figure is the best of --repeats after a
warm-up.

Capture: the synthetic two-cell capture
(``sim/scenarios.py::two_cell_capture``: cells 277 and 271 at +35 kHz;
the TPU tool read the reference's recorded capture, which is absent
here), on the 8-bit ADC grid with --adc-grid.
The reference takes ~6 s per center frequency for the same work on a
dual-core i7-2640 (BASELINE.md); ``vs_baseline`` is against that.
Prints one line per figure, or one JSON line with --json (with the
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
REF_SECONDS_PER_CARRIER = 6.0


def _best(fn, n, sync):
    ts = []
    out = None
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def main(argv=None) -> int:
    import torch

    from tools_torch.bench_tracker import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--ppm", type=float, default=100.0)
    ap.add_argument("--adc-grid", action="store_true",
                    help="quantize the capture onto the dongle's 8-bit "
                         "grid (the int8 kernel's route)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    card = card_line(args.device)
    if card is None:
        print("FAIL: no CUDA device", flush=True)
        return 1

    from lte_cell_scanner_tpu_torch.constants import DS_COMB_ARM, FS_WORK
    from lte_cell_scanner_tpu_torch.device import resolve_device, to_capture
    from lte_cell_scanner_tpu_torch.models.peaks import peak_search
    from lte_cell_scanner_tpu_torch.models.search import (
        SearchConfig, cell_search, compute_z_th1, default_f_search_set,
        refine_peaks)
    from lte_cell_scanner_tpu_torch.models.xcorr import xcorr_pss
    from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                          two_cell_capture)

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    capbuf = two_cell_capture(seed=0, f_off=35e3, fc=FC)
    if args.adc_grid:
        capbuf = adc_quantize(capbuf)
    fc = FC
    fs = FS_WORK
    fss = default_f_search_set(fc, args.ppm)
    cap_t = to_capture(capbuf, dev)

    def front():
        res = xcorr_pss(capbuf, fss, DS_COMB_ARM, fc, fc, fs, device=dev,
                        cap_t=cap_t)
        z = compute_z_th1(res.sp_incoherent, res.n_comb_xc)
        return peak_search(res.xc_incoherent_collapsed_pow,
                           res.xc_incoherent_collapsed_frq, z, fss, fc, fc,
                           res.xc_incoherent_single, DS_COMB_ARM)

    peaks = front()                       # warm-up
    t_front, peaks = _best(front, args.repeats, sync)

    results = {"device": card, "n_hyp": len(fss), "n_peaks": len(peaks),
               "adc_grid": args.adc_grid, "front_end_s": t_front}
    for label, batch in (("serial", False), ("batched", True)):
        cfg = SearchConfig(batch_peaks=batch)
        refine_peaks(peaks, cap_t, fc, fc, fs, cfg)       # warm-up
        t, cells = _best(
            lambda: refine_peaks(peaks, cap_t, fc, fc, fs, cfg),
            args.repeats, sync)
        results[f"back_half_{label}_s"] = t
        results[f"n_cells_{label}"] = len(cells)

    total = results["front_end_s"] + results["back_half_batched_s"]
    results["total_s"] = total
    results["vs_baseline"] = REF_SECONDS_PER_CARRIER / total

    cell_search(capbuf, fss, fc, fc, fs, device=dev)      # warm-up
    t_cs, cells = _best(lambda: cell_search(capbuf, fss, fc, fc, fs,
                                            device=dev),
                        args.repeats, sync)
    stages = []
    for _ in range(args.repeats):
        st = {}
        cell_search(capbuf, fss, fc, fc, fs, device=dev, timings=st)
        stages.append(st)
    results["cell_search_s"] = t_cs
    results["cell_search_stages_s"] = {
        k: min(s[k] for s in stages) for k in stages[0]}
    results["cell_ids"] = sorted(c.n_id_cell() for c in cells)
    if results["n_cells_serial"] != results["n_cells_batched"]:
        print(f"WARNING: serial decoded {results['n_cells_serial']} cells "
              f"but batched decoded {results['n_cells_batched']}",
              file=sys.stderr)

    if args.json:
        print(json.dumps(results))
    else:
        print(f"{card}  grid {results['n_hyp']} hyps  "
              f"{results['n_peaks']} peaks -> "
              f"{results['n_cells_batched']} cells")
        print(f"front end        {results['front_end_s']*1e3:9.2f} ms")
        print(f"back half serial {results['back_half_serial_s']*1e3:9.2f} ms")
        print(f"back half batch  {results['back_half_batched_s']*1e3:9.2f} ms")
        print(f"TOTAL            {total*1e3:9.2f} ms   "
              f"({results['vs_baseline']:.0f}x the reference's 6 s/carrier)")
        print(f"cell_search      {t_cs*1e3:9.2f} ms   " + ", ".join(
            f"{k} {v*1e3:.2f}" for k, v in
            results["cell_search_stages_s"].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
