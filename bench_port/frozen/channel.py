"""Channel impairments and the dongle's 8-bit grid, in plain numpy.

Frozen copy of lte_cell_scanner_tpu_torch at commit 7ac09dbc9b43:
sim/channel.py (awgn, apply_freq_offset) and the quantiser of
tools_torch/bench_tracker.py::MultiCellStream.
"""

from __future__ import annotations

import numpy as np

FS = 1.92e6


def awgn(sig: np.ndarray, snr_db: float, rng: np.random.Generator,
         signal_power: float = None) -> np.ndarray:
    """sig plus complex white noise at snr_db below signal_power (the
    mean power of sig when None)."""
    sp = float(np.mean(np.abs(sig) ** 2)) if signal_power is None \
        else signal_power
    npow = sp / 10.0 ** (snr_db / 10.0)
    return sig + noise(len(sig), npow, rng)


def noise(n: int, power: float, rng: np.random.Generator) -> np.ndarray:
    """n samples of complex white Gaussian noise of the given power."""
    return (rng.normal(size=n) + 1j * rng.normal(size=n)) \
        * np.sqrt(power / 2.0)


def apply_freq_offset(sig: np.ndarray, f_off: float, t0: int = 0,
                      fs: float = FS) -> np.ndarray:
    """Mix up by f_off Hz; t0 is the first sample's index."""
    t = t0 + np.arange(len(sig))
    return sig * np.exp(1j * 2 * np.pi * f_off * t / fs)


def adc_quantize_rms(sig: np.ndarray) -> np.ndarray:
    """The tracker stream's dongle model: per-plane RMS at 1/4 of full
    scale, codes clip(round(128 x), -127, 128) / 128, complex64."""
    rms = float(np.sqrt(np.mean(sig.real ** 2 + sig.imag ** 2) / 2))
    s = 0.25 / max(rms, 1e-30)
    k_re = np.clip(np.round(sig.real * s * 128), -127, 128)
    k_im = np.clip(np.round(sig.imag * s * 128), -127, 128)
    return ((k_re + 1j * k_im) / 128.0).astype(np.complex64)
