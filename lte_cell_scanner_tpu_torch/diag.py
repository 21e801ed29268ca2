"""Capture-integrity diagnostics (the reference rtl_sdr_check tool).

Behavioral contract: reference src/rtl_sdr_check.cpp:280-424: build an
ideal SSS+PSS time-domain template for a known cell, interpolate it
x1024 with interpft and resample to the capture's true rate
(fs*k_factor), frequency-shift, correlate against the whole capture,
then scan the frame-periodic correlation peaks for missing/extra samples
(dropped-sample detection with */**/*** severity flags).

The template is made on the host (float64); the long correlation runs
on ``device`` through ``ops/corr.py::correlate`` in complex64 on every
device, the precision of the reference implementation's correlation, so
the peak lists agree; the peak periodicity analysis stays on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .constants import FS_LTE
from .device import resolve_device
from .models.pss import pss_td
from .models.sss import sss_td
from .models.xcorr import round_i
from .ops.corr import correlate
from .ops.dsp import interpft_host


@dataclass
class PeakReport:
    location: int
    diff_with_prev: int
    n_dropped: int
    severity: str  # "", "*", "**", or "***"


@dataclass
class CaptureCheckResult:
    n_samples: int
    peak_power_db: float
    expected_period: float
    peaks: List[PeakReport]
    missing: List[int]
    peak_to_average: float = float("inf")

    # Below this peak-to-average correlation ratio the "peaks" are noise:
    # the matched filter against the wrong cell/offset measures ~30 on
    # the reference's air capture vs ~550 for the true cell.
    PAR_FLOOR = 60.0

    def sync_found(self) -> bool:
        return self.peak_to_average >= self.PAR_FLOOR and bool(self.peaks)

    def worst_drop(self) -> int:
        return max((abs(p.n_dropped) for p in self.peaks), default=0)


def build_sync_template(n_id_cell: int, fs: float, k_factor: float,
                        f_off: float, factor: int = 1024) -> np.ndarray:
    """Ideal SSS+PSS sequence resampled to fs*k_factor, conjugated and
    normalized for matched filtering (host complex128)."""
    n_id_1 = n_id_cell // 3
    n_id_2 = n_id_cell - 3 * n_id_1
    pt = pss_td(n_id_2)[9:]          # 128-point bodies
    st = sss_td(n_id_1, n_id_2, 0)[9:]

    pt_i = interpft_host(pt, factor * 128)
    st_i = interpft_host(st, factor * 128)
    seq_interp = np.concatenate([
        st_i[119 * factor:], st_i, pt_i[119 * factor:], pt_i])

    n_samp_fs = int(np.floor((9 + 128 + 9 + 128) * (16 / FS_LTE)
                             * (fs * k_factor)))
    desired_time = np.arange(n_samp_fs) / (fs * k_factor)
    idx = round_i(desired_time * (FS_LTE / 16 * factor))
    idx = np.minimum(idx, len(seq_interp) - 1)
    seq = seq_interp[idx]
    seq = seq * np.exp(1j * 2 * np.pi * f_off * np.arange(len(seq))
                       / (fs * k_factor))
    return np.conj(seq) / len(seq)


def check_capture(cap_data: np.ndarray, fc: float, f_off: float, fs: float,
                  n_id_cell: int, drop_seconds: float = 0.0,
                  peak_rel_db: float = -4.0,
                  device=None) -> CaptureCheckResult:
    """Scan a capture for dropped samples using sync-signal periodicity;
    the correlation runs on ``device`` (None = the card)."""
    dev = resolve_device(device)
    k_factor = (fc - f_off) / fc
    n_drop = int(round(drop_seconds * fs))
    cap = np.asarray(cap_data)[n_drop:]
    n_samp = len(cap)

    seq = build_sync_template(n_id_cell, fs, k_factor, f_off)
    xc = correlate(
        torch.from_numpy(cap.astype(np.complex64)).to(dev),
        torch.from_numpy(seq.astype(np.complex64))[None].to(dev))
    xc = (xc[0].abs() ** 2).cpu().numpy()

    peak = float(xc.max())
    expected_period = fs * 0.010 * k_factor
    thresh = peak * 10.0 ** (peak_rel_db / 10.0)

    peaks: List[PeakReport] = []
    missing: List[int] = []
    is_peak = (xc[1:-1] > thresh) & (xc[1:-1] > xc[:-2]) \
        & (xc[1:-1] > xc[2:])
    locs = np.nonzero(is_peak)[0] + 1
    prev_peak = -1
    for t in locs:
        t = int(t)
        if prev_peak == -1:
            prev_peak = t
            continue
        n_skipped = max(0, int(round((t - prev_peak) / expected_period)) - 1)
        for k in range(n_skipped):
            missing.append(int(round(prev_peak + (k + 1) * expected_period)))
        prev_peak += int(round(n_skipped * expected_period))
        n_dropped = int(round(expected_period - (t - prev_peak)))
        a = abs(n_dropped)
        sev = "***" if a > 100 else "**" if a > 10 else "*" if a > 2 else ""
        peaks.append(PeakReport(t, t - prev_peak, n_dropped, sev))
        prev_peak = t

    return CaptureCheckResult(
        n_samples=n_samp, peak_power_db=float(10 * np.log10(peak)),
        expected_period=expected_period, peaks=peaks, missing=missing,
        peak_to_average=float(peak / xc.mean()))
