"""Monte-Carlo detection-statistics harness of the port: the counterpart
of tools/monte_carlo.py.

Re-creation of the reference's statistical test harness
(reference Matlab/pss_search_final.m:1-367): each trial draws a random
cell (ID, CP type, frame phase, load factor), a random channel (AWGN;
optional multipath fading; frequency + coupled clock offset), runs the
detection chain (xcorr_pss -> threshold -> peak_search -> sss_detect ->
pss_sss_foe) and classifies the outcome as the MATLAB harness does
(pss_search_final.m:341-363):

  success      -- correct cell ID + CP type + frame timing within tol
  thresh1_fail -- no correlation peak cleared the chi-squared Z_th1 gate
  thresh2_fail -- peak(s) found but the SSS log-likelihood gate rejected
  false_alarm  -- an accepted detection with the wrong cell identity

The numpy draws are those of the TPU tool, so a seed gives the same
trials.  The chain runs on ``--device`` (default the card: the CUDA map
kernels, pss_corr_bf16 on float captures and pss_corr_int8 with
--adc-grid); ``--corr-backend`` takes the port's names (auto, kernel,
exact) and the TPU tool's (pallas = kernel, xla = exact).

Usage:
  python3 tools_torch/monte_carlo.py --trials 50 --snr -8 --fading --seed 0
  python3 tools_torch/monte_carlo.py --trials 20 --snr-sweep -12 -4 2
  python3 tools_torch/monte_carlo.py --device cpu --trials 3 \\
      --corr-backend xla

Prints one JSON line per configuration with the rates, plus per-trial
lines on standard error with --verbose.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from dataclasses import dataclass

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@dataclass
class TrialResult:
    outcome: str
    n_id_cell: int
    detected_id: int = -1
    timing_err: float = float("nan")
    freq_err: float = float("nan")


def run_trial(rng: np.random.Generator, snr_db: float, fading: bool,
              f_off_max: float = 7.5e3, n_subframes: int = 80,
              decode: bool = False, coupled: bool = False,
              corr_backend: str = "auto",
              adc_grid: bool = False, device=None) -> TrialResult:
    from lte_cell_scanner_tpu_torch.cell import CpType
    from lte_cell_scanner_tpu_torch.constants import FS_LTE
    from lte_cell_scanner_tpu_torch.device import resolve_device, to_capture
    from lte_cell_scanner_tpu_torch.interop import _BACKENDS
    from lte_cell_scanner_tpu_torch.models.peaks import peak_search
    from lte_cell_scanner_tpu_torch.models.search import (SearchConfig,
                                                          compute_z_th1,
                                                          refine_peaks)
    from lte_cell_scanner_tpu_torch.models.xcorr import xcorr_pss
    from lte_cell_scanner_tpu_torch.sim import (apply_coupled_offset,
                                                apply_freq_offset, awgn,
                                                create_dl_sig,
                                                multipath_channel)

    dev = resolve_device(device)
    corr_backend = _BACKENDS[corr_backend]
    fs = FS_LTE / 16
    fc = 739e6

    n_id_1 = int(rng.integers(0, 168))
    n_id_2 = int(rng.integers(0, 3))
    n_id_cell = 3 * n_id_1 + n_id_2
    cp_type = CpType.NORMAL if rng.random() < 0.5 else CpType.EXTENDED
    slot_start = int(rng.integers(0, 20))
    load_factor = float(rng.uniform(0.1, 0.9))
    f_off = float(rng.uniform(-f_off_max, f_off_max))

    sig = create_dl_sig(cp_type, n_subframes, slot_start, n_id_1, n_id_2,
                        load_factor, rng=rng, n_ports=2 if decode else 0)
    if fading:
        sig = multipath_channel(sig, rng=rng)
    if coupled:
        # dongle-crystal model: carrier AND sample-clock offset together
        # (frame timing shifts by <= off0*eps < 0.25 sample at 7.5 kHz,
        # well inside the 4-sample success gate)
        sig = apply_coupled_offset(sig, f_off, fc, fs)
    else:
        sig = apply_freq_offset(sig, f_off, fs)
    sig = awgn(sig, snr_db, rng=rng)
    if adc_grid:
        # the dongle source model (capbuf.cpp:174): scale the analog
        # signal so its per-plane RMS sits at ~1/4 full scale (a sane
        # AGC operating point), then quantize onto the 8-bit
        # (x - 127)/128 grid: the int8 kernel's route
        rms = float(np.sqrt(np.mean(sig.real ** 2 + sig.imag ** 2) / 2))
        s = 0.25 / max(rms, 1e-30)
        k_re = np.clip(np.round(sig.real * s * 128), -127, 128)
        k_im = np.clip(np.round(sig.imag * s * 128), -127, 128)
        sig = ((k_re + 1j * k_im) / 128.0).astype(np.complex64)

    f_search_set = np.arange(-10e3, 10e3 + 1, 5e3)
    cfg = SearchConfig(decode=decode, corr_backend=corr_backend)
    cap_t = to_capture(sig, dev)
    # one front-end pass; classify from its stage outputs
    # (pss_search_final.m:341-363 semantics)
    res = xcorr_pss(sig, f_search_set, cfg.ds_comb_arm, fc, fc, fs,
                    corr_backend=corr_backend, device=dev, cap_t=cap_t)
    z = compute_z_th1(res.sp_incoherent, res.n_comb_xc,
                      cfg.ds_comb_arm, cfg.thresh1_n_nines)
    peaks = peak_search(res.xc_incoherent_collapsed_pow,
                        res.xc_incoherent_collapsed_frq, z,
                        f_search_set, fc, fc,
                        res.xc_incoherent_single, cfg.ds_comb_arm)
    if not peaks:
        return TrialResult("thresh1_fail", n_id_cell)
    cells = refine_peaks(peaks, cap_t, fc, fc, fs, cfg)
    if not cells:
        return TrialResult("thresh2_fail", n_id_cell)

    best = max(cells, key=lambda c: c.pss_pow)
    if best.n_id_cell() != n_id_cell or best.cp_type is not cp_type:
        return TrialResult("false_alarm", n_id_cell,
                           detected_id=best.n_id_cell())

    # ground-truth frame boundary: the signal starts at slot_start, so
    # slot 0 lands ((20 - slot_start) % 20) * 960 samples in; the chain
    # reports frame_start with its 2-sample extraction margin
    expect = (((20 - slot_start) % 20) * 960 - 2.0) % 19200.0
    err = (best.frame_start - expect + 9600.0) % 19200.0 - 9600.0
    ferr = best.freq_fine - f_off
    if abs(err) > 4.0:
        return TrialResult("false_alarm", n_id_cell,
                           detected_id=best.n_id_cell(), timing_err=err)
    return TrialResult("success", n_id_cell, detected_id=best.n_id_cell(),
                       timing_err=err, freq_err=ferr)


def run_config(trials: int, snr_db: float, fading: bool, seed: int,
               verbose: bool = False, decode: bool = False,
               coupled: bool = False, corr_backend: str = "auto",
               adc_grid: bool = False, n_subframes: int = 80,
               device=None, results: list = None) -> dict:
    """One configuration's rates over ``trials`` trials drawn from
    ``seed``; ``results``, if a list is given, receives each trial's
    TrialResult."""
    rng = np.random.default_rng(seed)
    counts = {"success": 0, "thresh1_fail": 0, "thresh2_fail": 0,
              "false_alarm": 0}
    terrs, ferrs = [], []
    for t in range(trials):
        r = run_trial(rng, snr_db, fading, n_subframes=n_subframes,
                      decode=decode, coupled=coupled,
                      corr_backend=corr_backend, adc_grid=adc_grid,
                      device=device)
        if results is not None:
            results.append(r)
        counts[r.outcome] += 1
        if r.outcome == "success":
            terrs.append(r.timing_err)
            ferrs.append(r.freq_err)
        if verbose:
            print(json.dumps({"trial": t, "outcome": r.outcome,
                              "cell": r.n_id_cell,
                              "detected": r.detected_id,
                              "timing_err": round(r.timing_err, 3)
                              if np.isfinite(r.timing_err) else None}),
                  file=sys.stderr)
    out = {"snr_db": snr_db, "fading": fading, "coupled": coupled,
           "corr_backend": corr_backend, "adc_grid": adc_grid,
           "capture_ms": n_subframes, "trials": trials,
           **{k: v / trials for k, v in counts.items()}}
    if terrs:
        out["timing_rmse"] = float(np.sqrt(np.mean(np.square(terrs))))
        out["freq_rmse"] = float(np.sqrt(np.mean(np.square(ferrs))))
    return out


def noise_only_config(trials: int, seed: int, corr_backend: str = "auto",
                      adc_grid: bool = False, n_subframes: int = 80,
                      n_nines: int = 12, device=None) -> dict:
    """Calibrate the chi-squared false-alarm tail against noise-only
    captures.

    The Z_th1 design point (reference CellSearch.cpp:500-503, derived in
    Matlab/pss_search_final.m:207-255) models each delay-spread-combined
    folded power cell, normalized by the local noise estimate, as
    chi-squared with 2*n_comb_xc*(2*arm+1) degrees of freedom, and sets
    the threshold at the 10^-12 tail.  This mode measures the empirical
    exceedance curve of the normalized statistic T =
    Z * (rx_cutoff * 137 * 2 * n_comb * (2*arm+1)) / sp_incoherent over
    the 10^-1..10^-6 range where statistics exist, against the chi2
    survival function.

    Neighboring lag cells share fold periods and delay-spread windows,
    so cells are correlated: the per-cell marginal (what the threshold
    acts on) is still chi2, but the effective sample count for the
    ratio's error bars is below the raw cell count -- quote ratios, not
    confidence intervals."""
    from lte_cell_scanner_tpu_torch.constants import FS_LTE
    from lte_cell_scanner_tpu_torch.interop import _BACKENDS
    from lte_cell_scanner_tpu_torch.models.search import SearchConfig
    from lte_cell_scanner_tpu_torch.models.xcorr import xcorr_pss
    from lte_cell_scanner_tpu_torch.ops.dsp import chi2cdf_inv

    backend = _BACKENDS[corr_backend]
    fs = FS_LTE / 16
    fc = 739e6
    cfg = SearchConfig(corr_backend=backend)
    arm = cfg.ds_comb_arm
    rng = np.random.default_rng(seed)
    f_search_set = np.arange(-10e3, 10e3 + 1, 5e3)
    rx_cutoff = (6 * 12 * 15e3 / 2 + 4 * 15e3) / (FS_LTE / 16 / 2)

    n_cap = int(n_subframes * 960)
    # The chi2 model is derived for receiver-filtered noise: the
    # rx_cutoff factor in Z_th1 is the occupied band fraction
    # (6 RB + guards) / fs of the noise the dongle's anti-alias chain
    # delivers (Matlab/pss_search_final.m:207-255), so the calibration
    # uses brickwall noise at that cutoff.
    mask = np.zeros(n_cap)
    f_bins = np.fft.fftfreq(n_cap) * fs
    mask[np.abs(f_bins) <= rx_cutoff * fs / 2] = 1.0
    t_all = []
    n_comb = None
    for _ in range(trials):
        sig = (rng.standard_normal(n_cap)
               + 1j * rng.standard_normal(n_cap)) / np.sqrt(2)
        sig = np.fft.ifft(np.fft.fft(sig) * mask)
        if adc_grid:
            k_re = np.clip(np.round(sig.real * 0.25 * 128), -127, 128)
            k_im = np.clip(np.round(sig.imag * 0.25 * 128), -127, 128)
            sig = ((k_re + 1j * k_im) / 128.0).astype(np.complex64)
        res = xcorr_pss(sig, f_search_set, arm, fc, fc, fs,
                        corr_backend=backend, device=device)
        n_comb = res.n_comb_xc
        scale = rx_cutoff * 137 * 2 * n_comb * (2 * arm + 1)
        # pre-collapse cells: the per-lag-cell statistic the threshold
        # is designed against ([3, n_f, 9600] per capture)
        t = np.asarray(res.xc_incoherent) * scale \
            / np.asarray(res.sp_incoherent)[None, None, :]
        t_all.append(t.ravel())
    t_all = np.concatenate(t_all)
    dof = 2 * n_comb * (2 * arm + 1)

    curve = []
    for p_exp in range(1, 7):
        p = 10.0 ** (-p_exp)
        if p * len(t_all) < 10:      # too few expected events to quote
            break
        thr = float(chi2cdf_inv(1 - p, dof))
        meas = float(np.mean(t_all > thr))
        curve.append({"p_design": p, "threshold": round(thr, 2),
                      "p_measured": meas,
                      "ratio": round(meas / p, 3) if meas else 0.0})
    thr12 = float(chi2cdf_inv(1 - 10.0 ** (-n_nines), dof))
    out = {"mode": "noise_only", "trials": trials, "cells": len(t_all),
           "dof": dof, "corr_backend": corr_backend,
           "adc_grid": adc_grid,
           "t_mean": round(float(t_all.mean()), 2),
           "exceedance": curve,
           "t_max_observed": round(float(t_all.max()), 2),
           "z_th1_dof_threshold": round(thr12, 2),
           "false_alarms_at_design_threshold":
               int(np.sum(t_all > thr12))}
    # exponential tail fit over the deepest measured decades -> the
    # effective per-cell rate at the actual Z_th1 threshold
    deep = [c for c in curve if 0 < c["p_measured"]]
    if len(deep) >= 3:
        xs = np.array([c["threshold"] for c in deep[-3:]])
        ys = np.log([c["p_measured"] for c in deep[-3:]])
        slope = np.polyfit(xs, ys, 1)[0]
        tau = -1.0 / slope
        p12 = deep[-1]["p_measured"] * np.exp(
            -(thr12 - deep[-1]["threshold"]) / tau)
        out["tail_e_folding"] = round(float(tau), 2)
        out["extrapolated_p_at_design_threshold"] = float(p12)
    return out


def main(argv=None) -> int:
    from lte_cell_scanner_tpu_torch.interop import _BACKENDS
    from tools_torch.bench_tracker import device_name

    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--snr", type=float, default=-6.0)
    ap.add_argument("--snr-sweep", nargs=3, type=float, default=None,
                    metavar=("START", "STOP", "STEP"))
    ap.add_argument("--fading", action="store_true")
    ap.add_argument("--coupled", action="store_true",
                    help="apply the frequency offset through the "
                         "coupled-crystal channel (clock offset too)")
    ap.add_argument("--decode", action="store_true",
                    help="run the full chain incl. MIB decode")
    ap.add_argument("--corr-backend", default="auto",
                    choices=sorted(_BACKENDS),
                    help="correlation backend for the trials: auto = the "
                         "CUDA kernels on the card, the exact correlation "
                         "elsewhere; kernel (or pallas) / exact (or xla) "
                         "force either")
    ap.add_argument("--adc-grid", action="store_true",
                    help="quantize each trial's signal onto the dongle's "
                         "8-bit (x-127)/128 ADC grid before detection")
    ap.add_argument("--capture-ms", type=int, default=80,
                    help="capture length per trial (160 ms doubles the "
                         "incoherent integration)")
    ap.add_argument("--noise-only", action="store_true",
                    help="false-alarm tail calibration: noise-only "
                         "captures, empirical exceedance of the "
                         "normalized folded powers vs the chi2 "
                         "prediction over 10^-1..10^-6")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if device_name(args.device) is None:
        print("FAIL: no CUDA device", flush=True)
        return 1

    if args.noise_only:
        print(json.dumps(noise_only_config(
            args.trials, args.seed, args.corr_backend, args.adc_grid,
            args.capture_ms, device=args.device)))
        return 0

    snrs = [args.snr] if args.snr_sweep is None else list(
        np.arange(args.snr_sweep[0], args.snr_sweep[1] + 1e-9,
                  args.snr_sweep[2]))
    for snr in snrs:
        print(json.dumps(run_config(args.trials, float(snr), args.fading,
                                    args.seed, args.verbose, args.decode,
                                    args.coupled, args.corr_backend,
                                    args.adc_grid, args.capture_ms,
                                    device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
