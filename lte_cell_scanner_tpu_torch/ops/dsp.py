"""DSP substrate: Matlab-semantics helpers (mod, wrap, range), power
and dB, the unitary DFT pair, mixers and shifts, linear and FFT
interpolation, the chi-squared CDF and its inverse, and the OFDM
center-subcarrier extraction.

Behavioral contracts mirror the reference's IT++/FFTW veneer
(reference include/dsp.h, src/dsp.cpp, include/itpp_ext.h).  Tensor
functions follow the dtype of their inputs: complex128 on the CPU,
complex64 on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _as_tensor(x) -> torch.Tensor:
    """A tensor as is; anything else through numpy, so Python floats
    stay float64."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


# ---------------------------------------------------------------------------
# Matlab-semantics helpers (reference include/itpp_ext.h:24-104)
# ---------------------------------------------------------------------------

def matlab_mod(k, n):
    """Matlab-compatible mod for ints and floats: k - n*floor(k/n), n==0 -> k."""
    if isinstance(k, (int, np.integer)) and isinstance(n, (int, np.integer)):
        return int(k - n * np.floor(k / n)) if n != 0 else int(k)
    if isinstance(k, (float, np.floating)):
        return float(k - n * np.floor(k / n)) if n != 0 else float(k)
    k = _as_tensor(k)
    n = _as_tensor(n).to(k.device)
    safe = torch.where(n == 0, torch.ones_like(n), n)
    if k.is_floating_point():
        m = (k - n * torch.floor(k / safe)).to(k.dtype)
    else:
        m = k - n * torch.div(k, safe, rounding_mode="floor")
    return torch.where(n == 0, k, m)


def matlab_range(first, incr, last) -> np.ndarray:
    """The matlab a:b:c range, host numpy (used for index planning).

    Matches reference itpp_ext::matlab_range (src/itpp_ext.cpp:97-149):
    length = floor((last-first)/incr)+1, elements first + t*incr; empty if
    the range runs the wrong way.
    """
    if np.sign(last - first) * np.sign(incr) < 0:
        return np.array([], dtype=np.result_type(first, incr, last))
    n = int(np.floor((last - first) / incr)) + 1
    return first + np.arange(n) * incr


def wrap(x, small, large):
    """WRAP macro: wrap x into [small, large) (reference macros.h:49)."""
    return matlab_mod(x - small, large - small) + small


# ---------------------------------------------------------------------------
# Power / dB
# ---------------------------------------------------------------------------

def sigpower(v) -> torch.Tensor:
    """Mean |v|^2 (reference dsp.h:23-29)."""
    v = _as_tensor(v)
    if v.is_complex():
        return torch.mean(v.real ** 2 + v.imag ** 2)
    return torch.mean(v ** 2)


def db10(x) -> torch.Tensor:
    return 10.0 * torch.log10(_as_tensor(x))


def udb10(x) -> torch.Tensor:
    return 10.0 ** (_as_tensor(x) / 10.0)


# ---------------------------------------------------------------------------
# FFT wrappers: unitary scaling so sigpower(dft(x)) == sigpower(x)
# (reference dsp.h:33-34)
# ---------------------------------------------------------------------------

def dft(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unitary DFT, so the mean power is preserved (reference dsp.h:33)."""
    return torch.fft.fft(x, dim=dim) / math.sqrt(x.shape[dim])


def idft(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unitary inverse DFT (reference dsp.h:34)."""
    return torch.fft.ifft(x, dim=dim) * math.sqrt(x.shape[dim])


# ---------------------------------------------------------------------------
# Mixers / shifts
# ---------------------------------------------------------------------------


def fshift_ramp(n: int, f, fs, dtype: torch.dtype,
                device: torch.device, t0=0) -> torch.Tensor:
    """exp(j*2*pi*f*(t0 + [0..n-1])/fs): the fshift phase ramp (reference
    dsp.h:40-57) starting at sample t0, computed in the real type of
    ``dtype``.

    ``f``/``fs`` may be scalars or tensors of shape [B]; the ramp is then
    [B, n], one row per (f, fs) pair.
    """
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    t = t0 + torch.arange(n, dtype=rdt, device=device)
    f = torch.as_tensor(f, dtype=rdt, device=device)
    fs = torch.as_tensor(fs, dtype=rdt, device=device)
    k = torch.tensor(2.0 * np.pi, dtype=rdt, device=device) * f / fs
    ang = k[..., None] * t
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(dtype)


def fshift(seq: torch.Tensor, f, fs=2.0) -> torch.Tensor:
    """Shift seq up in frequency by f Hz, sampled at fs Hz."""
    return seq * fshift_ramp(seq.shape[-1], f, fs, seq.dtype, seq.device)


def tshift(v: torch.Tensor, n: int) -> torch.Tensor:
    """Cyclically shift vector right by n samples (reference dsp.h:77-97)."""
    return torch.roll(v, int(n), dims=-1)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------


def interp1(X: torch.Tensor, Y: torch.Tensor, x: torch.Tensor
            ) -> torch.Tensor:
    """Linear interpolation with linear extrapolation at the edges,
    over any leading batch axes (broadcast between X [..., n], Y [..., n]
    and x [..., m]) -> [..., m].

    Matches reference interp1 (dsp.h:152-185): X strictly increasing,
    at least two knots; values outside [X[0], X[-1]] extrapolate from the
    edge segment.
    """
    n = X.shape[-1]
    # numpy's broadcast rule: torch.broadcast_shapes imports torch.fx's
    # symbolic-shape machinery on first use (seconds on a cold process)
    lead = np.broadcast_shapes(X.shape[:-1], Y.shape[:-1], x.shape[:-1])
    Y = Y.expand(*lead, n)
    X = X.expand(*lead, n).contiguous()
    x = x.expand(*lead, x.shape[-1]).contiguous()
    # left edge of the bracketing segment, clipped so that out-of-range
    # points use the first/last segment (=> extrapolation)
    idx = torch.clamp(torch.searchsorted(X, x, right=True) - 1, 0, n - 2)
    x0 = torch.gather(X, -1, idx)
    x1 = torch.gather(X, -1, idx + 1)
    y0 = torch.gather(Y, -1, idx)
    y1 = torch.gather(Y, -1, idx + 1)
    w = ((x - x0) / (x1 - x0)).to(Y.real.dtype)
    return y0 + w * (y1 - y0)


def interpft(x: torch.Tensor, n_y: int) -> torch.Tensor:
    """FFT-based resampling of x [..., n_x] to length n_y on x's device
    (reference dsp.cpp:52-91, Matlab interpft): the spectrum zero-padded
    in the middle, an even-length Nyquist bin split between both halves;
    when n_y is not a multiple of n_x, upsampled to the next multiple and
    decimated (or cut)."""
    n_x = x.shape[-1]
    if n_y <= 0:
        raise ValueError("n_y must be positive")
    n_up = -(-n_y // n_x) * n_x
    X = torch.fft.fft(x, dim=-1)
    nyqst = (n_x + 1) // 2
    pad = X.new_zeros(X.shape[:-1] + (n_up - n_x,))
    if n_x % 2 == 0:
        nyq = X[..., nyqst: nyqst + 1] / 2.0
        Xup = torch.cat([X[..., :nyqst], nyq, pad[..., :-1], nyq,
                         X[..., nyqst + 1:]], dim=-1)
    else:
        Xup = torch.cat([X[..., :nyqst], pad, X[..., nyqst:]], dim=-1)
    y = torch.fft.ifft(Xup, dim=-1) * (n_up / n_x)
    if n_up != n_y and n_up % n_y == 0:
        return y[..., :: n_up // n_y]
    return y[..., :n_y]


def interpft_host(x: np.ndarray, n_y: int) -> np.ndarray:
    """FFT-based resampling of x to length n_y on host numpy (reference
    dsp.cpp:52-91), for the sync template and the simulator's channel
    models, which resample chunks of any length.

    Matlab interpft semantics: upsample by zero-padding the spectrum in
    the middle, splitting an even-length Nyquist bin; if n_y is not an
    integer multiple, upsample to a multiple then decimate.
    """
    x = np.asarray(x)
    n_x = x.shape[-1]
    if n_y <= 0:
        raise ValueError("n_y must be positive")
    n_up = int(np.ceil(n_y / n_x)) * n_x
    X = np.fft.fft(x, axis=-1)
    nyqst = (n_x + 1) // 2
    head = X[..., :nyqst]
    tail = X[..., nyqst:]
    pad = np.zeros(X.shape[:-1] + (n_up - n_x,), dtype=X.dtype)
    if n_x % 2 == 0:
        nyq = X[..., nyqst: nyqst + 1] / 2.0
        Xup = np.concatenate([head, nyq, pad[..., :-1], nyq, tail[..., 1:]],
                             axis=-1)
    else:
        Xup = np.concatenate([head, pad, tail], axis=-1)
    y = np.fft.ifft(Xup, axis=-1) * (n_up / n_x)
    if n_up != n_y and n_up % n_y == 0:
        return y[..., :: n_up // n_y]
    return y[..., :n_y]


# ---------------------------------------------------------------------------
# Chi-squared distribution (reference dsp.h:188-201 via boost gamma)
# ---------------------------------------------------------------------------

def chi2cdf(x, k) -> torch.Tensor:
    """Chi-squared CDF at x with k degrees of freedom."""
    x = _as_tensor(x)
    if not x.is_floating_point():
        x = x.double()
    return torch.special.gammainc(
        torch.as_tensor(k / 2.0, dtype=x.dtype, device=x.device), x / 2.0)


def chi2cdf_inv(p: float, k: float) -> float:
    """Inverse chi-squared CDF, host float64 (used once for Z_th1)."""
    from scipy.special import gammaincinv
    return float(2.0 * gammaincinv(k / 2.0, p))


# ---------------------------------------------------------------------------
# OFDM helpers
# ---------------------------------------------------------------------------

def extract_center_subcarriers(dft_out: torch.Tensor, n_sc: int
                               ) -> torch.Tensor:
    """Extract the n_sc center subcarriers (excluding DC) of a 128-pt DFT.

    For n_sc=62 this is cat(dft[-31:], dft[1:32]) -- the PSS/SSS band
    (reference searcher.cpp:529); for n_sc=72 the full used band
    (searcher.cpp:905).
    """
    h = n_sc // 2
    return torch.cat([dft_out[..., -h:], dft_out[..., 1:h + 1]], dim=-1)
