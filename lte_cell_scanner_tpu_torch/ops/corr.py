"""Exact sliding cross-correlation of the capture against PSS templates.

The counterpart of the reference's xc_correlate (src/searcher.cpp:113-174)
in the working precision of its inputs: complex128 on the CPU, where it
is the port's correlation route and the oracle for the CUDA kernels of
``ops/corr_cuda.py``.  The (pss, hypothesis) axes collapse into one
template axis T, so each chunk of lags is one complex matrix product
against a window matrix.
"""

from __future__ import annotations

import torch

# lags per window-matrix chunk: bounds the [chunk, 137] temporary
_LAG_CHUNK = 16384


def correlate(capbuf: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """xc[t, k] = sum_m templates[t, m] * capbuf[k + m]  ->  [T, n - w + 1]."""
    w = templates.shape[1]
    n_lags = capbuf.shape[0] - w + 1
    out = torch.empty((templates.shape[0], n_lags), dtype=capbuf.dtype,
                      device=capbuf.device)
    for l0 in range(0, n_lags, _LAG_CHUNK):
        l1 = min(l0 + _LAG_CHUNK, n_lags)
        win = capbuf[l0: l1 + w - 1].unfold(0, w, 1)      # [l1-l0, w]
        out[:, l0:l1] = templates @ win.T
    return out
