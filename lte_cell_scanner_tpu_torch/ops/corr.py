"""Exact sliding cross-correlation of the capture against PSS templates.

The counterpart of the reference's xc_correlate (src/searcher.cpp:113-174)
in the working precision of its inputs: complex128 on the CPU, where it
is the port's correlation route and the oracle for the CUDA kernels of
``ops/corr_cuda.py``.  The (pss, hypothesis) axes collapse into one
template axis T.  Three interchangeable methods, as in the TPU package's
``ops/corr.py``:

- "dot" (the default): each chunk of lags is one complex matrix product
  against a window matrix.
- "conv": a real-decomposed ``conv1d`` (PyTorch's convolution is already
  a cross-correlation: no kernel flip), with TF32 off.
- "fft": one full-length FFT product (a power-of-two length).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# lags per window-matrix chunk: bounds the [chunk, 137] temporary
_LAG_CHUNK = 16384


def correlate(capbuf: torch.Tensor, templates: torch.Tensor,
              method: str = "dot") -> torch.Tensor:
    """xc[t, k] = sum_m templates[t, m] * capbuf[k + m]  ->  [T, n - w + 1]."""
    t_count, w = templates.shape
    n_lags = capbuf.shape[0] - w + 1
    if method == "dot":
        out = torch.empty((t_count, n_lags), dtype=capbuf.dtype,
                          device=capbuf.device)
        for l0 in range(0, n_lags, _LAG_CHUNK):
            l1 = min(l0 + _LAG_CHUNK, n_lags)
            win = capbuf[l0: l1 + w - 1].unfold(0, w, 1)      # [l1-l0, w]
            out[:, l0:l1] = templates @ win.T
        return out

    if method == "conv":
        x = torch.stack([capbuf.real, capbuf.imag])[None]      # [1, 2, n]
        tr, ti = templates.real, templates.imag
        # out channels: first T real parts, then T imag parts
        kern = torch.cat([torch.stack([tr, -ti], dim=1),
                          torch.stack([ti, tr], dim=1)]).to(x.dtype)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = F.conv1d(x, kern)[0]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        return torch.complex(out[:t_count], out[t_count:]).to(capbuf.dtype)

    if method == "fft":
        nfft = 1 << int(np.ceil(np.log2(capbuf.shape[0] + w)))
        cf = torch.fft.fft(capbuf, nfft)
        tf = torch.fft.fft(templates.flip(-1), nfft, dim=-1)
        # lag l of the correlation sits at index l + w - 1 of the product
        full = torch.fft.ifft(cf[None, :] * tf, dim=-1)
        return full[:, w - 1: w - 1 + n_lags].to(capbuf.dtype)

    raise ValueError(f"unknown method {method!r}")
