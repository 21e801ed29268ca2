"""PSS correlation-loss vs frequency-offset characterization: the
counterpart of tools/pss_foff.py (host numpy, no device).

Re-creation of the reference's offline study (reference
Matlab/pss_foff.m): correlate a clean PSS against frequency-shifted
copies of itself and report the normalized peak power as a function of
offset -- the curve that motivates the 5 kHz hypothesis raster: the
137-sample matched filter at 1.92 Msps loses ~0.5 dB at the +-2.5 kHz
raster straddle point, ~4 dB by 7 kHz, with the first sinc null at
fs/128 = 15 kHz.

Usage:
  python3 tools_torch/pss_foff.py [--max-off 10e3] [--step 500] [--plot]

Prints one JSON line per offset; --plot adds an ASCII curve.
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


def corr_loss_db(offs: np.ndarray, n_id_2: int = 0) -> np.ndarray:
    """The PSS matched filter's peak power at each offset (Hz), in dB
    below its zero-offset peak."""
    from lte_cell_scanner_tpu_torch.constants import FS_LTE
    from lte_cell_scanner_tpu_torch.models.pss import PSS_TD

    fs = FS_LTE / 16
    pss = PSS_TD()[n_id_2]               # 137 samples incl. CP
    ref_pow = np.abs(np.vdot(pss, pss)) ** 2
    out = []
    for f in offs:
        shifted = pss * np.exp(1j * 2 * np.pi * f * np.arange(len(pss)) / fs)
        peak = np.abs(np.vdot(pss, shifted)) ** 2
        out.append(10 * np.log10(peak / ref_pow))
    return np.asarray(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-off", type=float, default=10e3)
    ap.add_argument("--step", type=float, default=500.0)
    ap.add_argument("--n-id-2", type=int, default=0)
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args(argv)
    if args.step <= 0 or args.max_off < 0:
        ap.error("--step must be > 0 and --max-off >= 0")
    if not 0 <= args.n_id_2 <= 2:
        ap.error("--n-id-2 must be 0, 1, or 2")

    offs = np.arange(0.0, args.max_off + args.step / 2, args.step)
    rows = []
    for f, loss_db in zip(offs, corr_loss_db(offs, args.n_id_2)):
        rows.append({"f_off_hz": float(f),
                     "corr_loss_db": round(float(loss_db), 3)})
        print(json.dumps(rows[-1]))

    if args.plot:
        lo = min(r["corr_loss_db"] for r in rows)
        width = 60
        print("\ncorrelation loss (dB) vs frequency offset")
        for r in rows:
            n = int((r["corr_loss_db"] - lo) / (0.0 - lo + 1e-12) * width) \
                if lo < 0 else width
            print(f"{r['f_off_hz']:8.0f} Hz {r['corr_loss_db']:8.2f} "
                  + "#" * max(n, 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
