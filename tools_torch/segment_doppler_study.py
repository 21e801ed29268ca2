"""Segment-Doppler correlation, quantified: the counterpart of
tools/segment_doppler_study.py (host numpy, no device).

The proposal: instead of correlating 3*n_f freq-shifted 137-tap PSS
templates (O(3*n_f*N*137) complex multiply-adds), correlate only the 3
base templates over short segments of the tap window (O(3*N*137)), then
combine the per-segment partial sums per frequency hypothesis with one
phase rotation per segment (O(3*N*n_seg*n_f)) -- an n_f-point DFT
across segments.  The within-segment constant-phase approximation loses
coherence; this study quantifies that loss on the real PSS templates
and the naive operation count it would save.

Reference anchor: the freq-tolerance design note
reference src/searcher.cpp:158-166 (correlating at 2x rate is already a
matched filter tolerating large offsets).

Usage: python3 tools_torch/segment_doppler_study.py [--json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def coherence_ratio(p0: np.ndarray, f: float, fs: float, L: int) -> float:
    """Amplitude ratio of the segmented (piecewise-constant-phase)
    correlator to the exact freq-shifted matched filter, for a signal
    that is the offset template (the detection operating point).

    Exact: |<p_f, p_f>| = E.  Segmented: base-template segments with
    one phase per segment anchored at the segment center."""
    n = len(p0)
    k = np.arange(n)
    p_f = p0 * np.exp(2j * np.pi * f * k / fs)     # received template
    exact = np.vdot(p_f, p_f).real                 # = E
    # segmented estimator: <p0_seg, x_seg> per segment, one phase
    # rotation anchored at the segment center to align bulk phases
    acc = sum(
        np.vdot(p0[s0: s0 + L], p_f[s0: s0 + L])
        * np.exp(-2j * np.pi * f
                 * (0.5 * (s0 + min(s0 + L, n) - 1)) / fs)
        for s0 in range(0, n, L))
    return float(np.abs(acc) / exact)


def main(argv=None) -> int:
    from lte_cell_scanner_tpu_torch.constants import FS_LTE
    from lte_cell_scanner_tpu_torch.models.pss import PSS_TD

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    fs = FS_LTE / 16
    fc = 739e6
    p0 = np.asarray(PSS_TD()[0], np.complex128)    # 137 taps incl. CP
    f_edge = fc * 100e-6                           # +-100 ppm grid edge
    f_mid = f_edge / 2

    rows = []
    for L in (5, 7, 9, 12, 17, 23, 34, 46, 69, 137):
        r_edge = coherence_ratio(p0, f_edge, fs, L)
        r_mid = coherence_ratio(p0, f_mid, fs, L)
        n_seg = -(-len(p0) // L)
        # naive per-lag real-MAC counts (4 per cmac), n_f = 31 grid
        n_f = 31
        direct = 3 * n_f * 137 * 4
        seg = 3 * 137 * 4 + 3 * n_seg * n_f * 4
        rows.append({
            "L": L, "n_seg": n_seg,
            "loss_db_edge": round(-20 * np.log10(max(r_edge, 1e-9)), 2),
            "loss_db_mid": round(-20 * np.log10(max(r_mid, 1e-9)), 2),
            "naive_flop_cut": round(direct / seg, 2)})

    out = {"study": "segment_doppler", "f_edge_hz": f_edge,
           "rows": rows}
    if args.json:
        print(json.dumps(out))
    else:
        print(f"{'L':>4} {'segs':>5} {'loss@edge':>10} {'loss@mid':>9} "
              f"{'naive cut':>9}")
        for r in rows:
            print(f"{r['L']:>4} {r['n_seg']:>5} "
                  f"{r['loss_db_edge']:>9.2f}dB {r['loss_db_mid']:>8.2f}dB "
                  f"{r['naive_flop_cut']:>8.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
