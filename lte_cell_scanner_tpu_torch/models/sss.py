"""Secondary synchronization signal (SSS) tables.

Behavioral contract: reference sss_fd_calc
(reference src/lte_lib.cpp:199-274): m0/m1 derived from N_id_1;
s/c/z length-31 m-sequences; slot-0 vs slot-10 swap the (m0,m1) roles; the
two 31-chip subsequences are interleaved even/odd onto 62 subcarriers.

The s/c/z m-sequences are generated from their defining LFSR recurrences
(not hard-coded): s,c,z all start [0 0 0 0 1] with feedback taps per
36.211 6.11.2.1.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _mseq(taps) -> np.ndarray:
    """Length-31 binary m-sequence x(n+5) = sum_{t in taps} x(n+t) mod 2, x=[0,0,0,0,1]."""
    x = np.zeros(31, dtype=np.int64)
    x[4] = 1
    for n in range(26):
        x[n + 5] = sum(x[n + t] for t in taps) % 2
    return 1 - 2 * x  # BPSK


@lru_cache(maxsize=1)
def _base_sequences():
    s = _mseq((0, 2))       # s(n+5)=s(n+2)+s(n)
    c = _mseq((0, 3))       # c(n+5)=c(n+3)+c(n)
    z = _mseq((0, 1, 2, 4))  # z(n+5)=z(n+4)+z(n+2)+z(n+1)+z(n)
    return s, c, z


def sss_fd(n_id_1: int, n_id_2: int, slot_num: int) -> np.ndarray:
    """62-point SSS (values +-1, int64) for slot_num in {0, 10}."""
    s_td, c_td, z_td = _base_sequences()

    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31

    idx = np.arange(31)
    s0_m0 = s_td[(idx + m0) % 31]
    s1_m1 = s_td[(idx + m1) % 31]
    c0 = c_td[(idx + n_id_2) % 31]
    c1 = c_td[(idx + n_id_2 + 3) % 31]
    z1_m0 = z_td[(idx + (m0 % 8)) % 31]
    z1_m1 = z_td[(idx + (m1 % 8)) % 31]

    if slot_num == 0:
        ssc1 = s0_m0 * c0
        ssc2 = s1_m1 * c1 * z1_m0
    else:
        ssc1 = s1_m1 * c0
        ssc2 = s0_m0 * c1 * z1_m1

    out = np.empty(62, dtype=np.int64)
    out[0::2] = ssc1
    out[1::2] = ssc2
    return out


@lru_cache(maxsize=1)
def SSS_FD() -> np.ndarray:
    """(168, 3, 2, 62) int8 ROM table; last-but-one axis is slot {0,10}."""
    table = np.empty((168, 3, 2, 62), dtype=np.int8)
    for n1 in range(168):
        for n2 in range(3):
            for si, slot in enumerate((0, 10)):
                table[n1, n2, si] = sss_fd(n1, n2, slot)
    return table



def sss_td(n_id_1: int, n_id_2: int, slot_num: int) -> np.ndarray:
    """137-sample time-domain SSS (CP + 128 body), complex128.

    Same IDFT+CP recipe as the PSS (reference lte_lib.cpp:280-300); used by
    the capture diagnostics (diag.py).
    """
    from .pss import _td_from_fd
    return _td_from_fd(sss_fd(n_id_1, n_id_2, slot_num).astype(complex))
