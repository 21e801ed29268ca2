"""Primary synchronization signal (PSS) tables.

Behavioral contract: reference pss_fd_calc / PSS_td
(reference src/lte_lib.cpp:155-193): 62-pt frequency-domain Zadoff-Chu
sequences with roots u in {25,29,34} for N_id_2 in {0,1,2}; time domain is
the 128-pt unitary IDFT of the centered mapping, scaled by sqrt(128/62),
with a 9-sample cyclic prefix prepended (137 samples total).

Computed once in float64 numpy; exposed as ROM arrays.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_ZC_ROOTS = (25, 29, 34)


def pss_fd(n_id_2: int) -> np.ndarray:
    """62-point frequency-domain PSS (complex128)."""
    u = _ZC_ROOTS[n_id_2]
    n = np.arange(63)
    r = np.exp(-1j * np.pi * u * n * (n + 1) / 63.0)
    return np.delete(r, 31)


def _td_from_fd(fd: np.ndarray) -> np.ndarray:
    """Map 62 center subcarriers into a 128-pt grid, IDFT, prepend 9-sample CP."""
    idft_in = np.concatenate([
        np.zeros(1, complex), fd[31:62], np.zeros(65, complex), fd[0:31]])
    td = np.fft.ifft(idft_in) * np.sqrt(128.0) * np.sqrt(128.0 / 62.0)
    return np.concatenate([td[119:128], td])


def pss_td(n_id_2: int) -> np.ndarray:
    """137-sample time-domain PSS (CP + body), complex128."""
    return _td_from_fd(pss_fd(n_id_2))


@lru_cache(maxsize=1)
def PSS_FD() -> np.ndarray:
    """(3, 62) complex128 ROM table."""
    return np.stack([pss_fd(t) for t in range(3)])


@lru_cache(maxsize=1)
def PSS_TD() -> np.ndarray:
    """(3, 137) complex128 ROM table."""
    return np.stack([pss_td(t) for t in range(3)])
