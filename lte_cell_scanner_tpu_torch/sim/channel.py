"""Channel impairments for self-tests and fault injection.

Mirrors the reference's simulation toolbox: AWGN injection (the
--noise-power flag / blnoise, reference dsp.h:143-147,
LTE-Tracker.cpp:248-255), carrier frequency offset, the coupled
sample-clock offset implied by the shared crystal (k_factor model,
searcher.cpp:18-43), and a static multipath channel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import FS_WORK
from ..ops.dsp import interpft_host


def awgn(sig: np.ndarray, snr_db: float,
         rng: Optional[np.random.Generator] = None,
         signal_power: Optional[float] = None) -> np.ndarray:
    """Add complex white Gaussian noise at the given SNR, against
    ``signal_power`` when given, else the mean power of sig."""
    rng = rng or np.random.default_rng()
    sp = signal_power if signal_power is not None \
        else float(np.mean(np.abs(sig) ** 2))
    npow = sp / (10.0 ** (snr_db / 10.0))
    noise = (rng.normal(size=len(sig)) + 1j * rng.normal(size=len(sig))) \
        * np.sqrt(npow / 2.0)
    return sig + noise


def apply_freq_offset(sig: np.ndarray, f_off: float,
                      fs: float = FS_WORK) -> np.ndarray:
    """Mix the signal up by f_off Hz."""
    t = np.arange(len(sig))
    return sig * np.exp(1j * 2 * np.pi * f_off * t / fs)


def apply_coupled_offset(sig: np.ndarray, f_off: float, fc: float,
                         fs: float = FS_WORK, up: int = 32) -> np.ndarray:
    """Dongle-crystal model: carrier offset WITH the coupled clock error.

    A single crystal drives both the tuner LO and the sampler
    (reference k_factor derivation, searcher.cpp:18-43): a crystal
    error eps makes the receiver tune fc(1+eps) -- an apparent carrier
    offset f_off = -fc*eps -- and simultaneously sample at fs(1+eps).
    This emulates both effects on an ideal-clock signal: mix by f_off,
    then resample with apply_clock_offset at k = 1+eps = (fc-f_off)/fc
    (exactly the reference's k_factor).

    The plain apply_freq_offset leaves the clock ideal, so the
    tracker's k_factor compensation shows up as an apparent
    fs*f_off/fc frame-timing drift; through THIS channel the k_factor
    model is exercised positively and timing must hold still.
    """
    mixed = apply_freq_offset(sig, f_off, fs)
    return apply_clock_offset(mixed, (fc - f_off) / fc, up=up)


def multipath_channel(sig: np.ndarray, n_taps: int = 4,
                      delay_spread: float = 1.5,
                      rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
    """Random static multipath FIR channel.

    Rayleigh taps with an exponential power-delay profile
    (tap k power ~ e^{-k/delay_spread}), normalized to unit average
    gain.  Stands in for the external ``channel_gen`` the reference's
    Monte-Carlo harness uses (Matlab/pss_search_final.m:143-156) for
    frequency-selective fading trials.
    """
    rng = rng or np.random.default_rng()
    pdp = np.exp(-np.arange(n_taps) / delay_spread)
    pdp = pdp / pdp.sum()
    taps = (rng.normal(size=n_taps) + 1j * rng.normal(size=n_taps)) \
        * np.sqrt(pdp / 2.0)          # E[sum |h_k|^2] = sum pdp = 1
    return np.convolve(sig, taps)[: len(sig)]


def apply_clock_offset(sig: np.ndarray, k_factor: float,
                       up: int = 32) -> np.ndarray:
    """Emulate a sampler running at fs*k_factor on an ideal-clock signal.

    Output sample n is the signal at nominal position n/k_factor,
    resampled via interpft x`up` + linear interpolation between fine
    samples (the reference's own resampling recipe,
    rtl_sdr_check.cpp:332-351; interpolation error ~(1/up)^2).
    """
    n = len(sig)
    # long signals: resample in overlapped chunks so the fine grid
    # (n*up complex) never materializes whole
    chunk = 1 << 18
    if n > chunk:
        guard = 256
        out = np.empty(n, dtype=np.complex128)
        start = 0
        while start < n:
            stop = min(start + chunk, n)
            # nominal positions needed for output [start, stop)
            p0 = start / k_factor
            p1 = (stop - 1) / k_factor
            lo = max(0, int(np.floor(p0)) - guard)
            hi = min(n, int(np.ceil(p1)) + guard)
            seg = apply_clock_offset_positions(
                sig[lo:hi], (np.arange(start, stop) / k_factor) - lo, up)
            out[start:stop] = seg
            start = stop
        return out
    return apply_clock_offset_positions(sig, np.arange(n) / k_factor, up)


def apply_clock_offset_positions(sig: np.ndarray, pos: np.ndarray,
                                 up: int) -> np.ndarray:
    """Evaluate sig at fractional positions via interpft + linear interp."""
    n = len(sig)
    fine = interpft_host(sig, n * up)
    # clamp positions BEFORE splitting into (index, frac) so tail samples
    # hold the last fine value instead of blending a mismatched pair
    posu = np.clip(pos * up, 0.0, n * up - 1.0)
    i0 = np.minimum(np.floor(posu).astype(np.int64), n * up - 2)
    frac = posu - i0
    return fine[i0] * (1.0 - frac) + fine[i0 + 1] * frac


class ClockResampler:
    """Streaming coupled-clock resampler with cross-block continuity.

    Feed nominal-rate samples with push(); get back the stream as a
    sampler running at fs*k_factor would have produced it, with the
    fractional position carried across pushes (no per-block phase
    reset).  Used by io/capture.py::SimSource.stream for a coupled
    stream.
    """

    def __init__(self, k_factor: float, up: int = 32, guard: int = 256):
        self.k = k_factor
        self.up = up
        self.guard = guard
        self.buf = np.zeros(0, dtype=np.complex128)
        self.base = 0          # nominal index of buf[0]
        self.next_out = 0      # next output sample index

    def push(self, nominal: np.ndarray) -> np.ndarray:
        self.buf = np.concatenate([self.buf, np.asarray(nominal)])
        # emit every output whose source position stays clear of the
        # window tail (interpft ringing guard)
        hi_pos = self.base + len(self.buf) - self.guard - 2
        n_last = int(np.floor(hi_pos * self.k))
        if n_last < self.next_out:
            return np.zeros(0, dtype=np.complex128)
        ns = np.arange(self.next_out, n_last + 1)
        rel = ns / self.k - self.base
        out = apply_clock_offset_positions(self.buf, rel, self.up)
        self.next_out = n_last + 1
        # trim consumed nominal samples, keeping a leading guard
        keep_from = int(np.floor(self.next_out / self.k)) - self.guard
        drop = max(0, keep_from - self.base)
        if drop:
            self.buf = self.buf[drop:]
            self.base += drop
        return out
