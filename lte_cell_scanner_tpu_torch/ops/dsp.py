"""DSP substrate of the search path: the Matlab range used for index
planning, the frequency-shift phase ramp, the unitary DFT, linear
interpolation and the chi-squared inverse CDF.

Behavioral contracts mirror the reference's IT++/FFTW veneer
(reference include/dsp.h, src/dsp.cpp, include/itpp_ext.h).  Tensor
functions follow the dtype of their inputs: complex128 on the CPU,
complex64 on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


def dft(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unitary DFT, so the mean power is preserved (reference dsp.h:33)."""
    return torch.fft.fft(x, dim=dim) / math.sqrt(x.shape[dim])


def fshift_ramp(n: int, f, fs, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """exp(j*2*pi*f*[0..n-1]/fs): the fshift phase ramp (reference
    dsp.h:40-57), computed in the real type of ``dtype``.

    ``f``/``fs`` may be scalars or tensors of shape [B]; the ramp is then
    [B, n], one row per (f, fs) pair.
    """
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    t = torch.arange(n, dtype=rdt, device=device)
    f = torch.as_tensor(f, dtype=rdt, device=device)
    fs = torch.as_tensor(fs, dtype=rdt, device=device)
    k = torch.tensor(2.0 * np.pi, dtype=rdt, device=device) * f / fs
    ang = k[..., None] * t
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(dtype)


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


def chi2cdf_inv(p: float, k: float) -> float:
    """Inverse chi-squared CDF, host float64 (used once for Z_th1)."""
    from scipy.special import gammaincinv
    return float(2.0 * gammaincinv(k / 2.0, p))
