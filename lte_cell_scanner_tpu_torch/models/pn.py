"""3GPP Gold-sequence (length-31) pseudo-noise generator.

Behavioral contract: reference lte_pn (reference src/lte_lib.cpp:41-147):
two 31-bit LFSRs (x1: taps 0,3; x2: taps 0,1,2,3), output x1(0)^x2(0) after
discarding Nc=1600 startup bits.

Design: instead of hard-coding the 1600-step advance matrices,
they are derived once by GF(2) matrix exponentiation; sequence emission is a
vectorized "blocked" generation: the LFSR output at time t is a fixed GF(2)
linear functional of the initial state, so a whole block of outputs is one
(bits x 31) @ (31,) boolean matmul.  Host precompute (numpy); results are
ROM tables shipped to device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_NC = 1600


def _step_matrix(taps) -> np.ndarray:
    """One-step state update matrix over GF(2); state s, s'[i]=s[i+1], s'[30]=sum taps."""
    m = np.zeros((31, 31), dtype=np.uint8)
    for i in range(30):
        m[i, i + 1] = 1
    for t in taps:
        m[30, t] = 1
    return m


def _mat_pow_gf2(m: np.ndarray, p: int) -> np.ndarray:
    r = np.eye(31, dtype=np.uint8)
    while p:
        if p & 1:
            r = (r @ m) & 1
        m = (m @ m) & 1
        p >>= 1
    return r


@lru_cache(maxsize=None)
def _emission_matrices(length: int):
    """Rows t of E1/E2 map the state at time Nc to output bit x(0) at Nc+t."""
    m1 = _step_matrix((0, 3))
    m2 = _step_matrix((0, 1, 2, 3))
    a1 = _mat_pow_gf2(m1, _NC)
    a2 = _mat_pow_gf2(m2, _NC)
    e1 = np.empty((length, 31), dtype=np.uint8)
    e2 = np.empty((length, 31), dtype=np.uint8)
    s1 = a1
    s2 = a2
    for t in range(length):
        e1[t] = s1[0]
        e2[t] = s2[0]
        s1 = (m1 @ s1) & 1
        s2 = (m2 @ s2) & 1
    return e1, e2


def lte_pn(c_init: int, length: int) -> np.ndarray:
    """Return `length` bits of the Gold sequence for seed c_init (uint8 0/1)."""
    x1_0 = np.zeros(31, dtype=np.uint8)
    x1_0[0] = 1
    x2_0 = np.array([(c_init >> t) & 1 for t in range(31)], dtype=np.uint8)
    e1, e2 = _emission_matrices(length)
    return ((e1 @ x1_0) + (e2 @ x2_0)) & 1
