"""QPSK/QAM16/QAM64 modulation and soft demodulation.

Behavioral contract: reference Mod_map / lte_modulate / lte_demodulate
(reference src/lte_lib.cpp:559-634): LTE 36.211 Gray constellations;
soft demod returns ln(P(bit==0)/P(bit==1)) with per-symbol noise weighting
(the channel is assumed already removed; exact log-MAP).

Constellation tables are generated from the 36.211 nesting formula;
``lte_modulate`` is host numpy (the simulator's transmitter),
``lte_demodulate`` a tensor logsumexp over the constellation, and
``lte_demodulate_host`` the same log-MAP in numpy (the tracker's MIB
re-decode).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_BPS = {"qpsk": 2, "qam16": 4, "qam64": 6}
_NORM = {"qpsk": np.sqrt(2.0), "qam16": np.sqrt(10.0), "qam64": np.sqrt(42.0)}


def _level(bits) -> float:
    """I/Q amplitude for one axis, bits MSB-first (1, 2 or 3 bits).

    36.211 nesting: level(b) = 1-2b ; level(b0,rest) =
    (1-2b0) * (2^len(rest) - level(rest)).
    """
    if len(bits) == 1:
        return 1.0 - 2.0 * bits[0]
    return (1.0 - 2.0 * bits[0]) * (2 ** len(bits[1:]) - _level(bits[1:]))


@lru_cache(maxsize=None)
def mod_map(modulation: str) -> np.ndarray:
    """Constellation table indexed by the bit word (MSB-first), complex128.

    I bits are the even positions (b0, b2, b4), Q bits the odd ones
    (reference lte_lib.cpp:559-570).
    """
    bps = _BPS[modulation]
    n = 1 << bps
    table = np.zeros(n, dtype=np.complex128)
    for idx in range(n):
        bits = [(idx >> (bps - 1 - k)) & 1 for k in range(bps)]
        i_val = _level(tuple(bits[0::2]))
        q_val = _level(tuple(bits[1::2]))
        table[idx] = (i_val + 1j * q_val) / _NORM[modulation]
    return table


def lte_modulate(bits: np.ndarray, modulation: str = "qpsk") -> np.ndarray:
    """Map bits (len divisible by bps) to constellation symbols."""
    bits = np.asarray(bits, dtype=np.int64).reshape(-1, _BPS[modulation])
    weights = 1 << np.arange(_BPS[modulation])[::-1]
    idx = bits @ weights
    return mod_map(modulation)[idx]


def lte_demodulate(syms: torch.Tensor, np_vec: torch.Tensor,
                   modulation: str = "qpsk") -> torch.Tensor:
    """Exact log-MAP soft bits ln(P(b==0|r)/P(b==1|r)) of syms [..., n]
    with per-symbol noise power np_vec [..., n] -> [..., n*bps].

    Matches IT++ demodulate_soft_bits(syms/sqrt(np), 1/sqrt(np), 1,
    LOGMAP) as called at reference lte_lib.cpp:630-631.
    """
    bps = _BPS[modulation]
    table = torch.from_numpy(mod_map(modulation)).to(device=syms.device,
                                                     dtype=syms.dtype)
    d = syms[..., None] - table
    metric = -(d.real ** 2 + d.imag ** 2) / np_vec[..., None]
    idx = np.arange(table.shape[0])
    neg_inf = torch.full((), -np.inf, dtype=metric.dtype,
                         device=metric.device)
    out = []
    for b in range(bps):
        bit = torch.from_numpy((idx >> (bps - 1 - b)) & 1).to(syms.device)
        m0 = torch.logsumexp(torch.where(bit == 0, metric, neg_inf), dim=-1)
        m1 = torch.logsumexp(torch.where(bit == 1, metric, neg_inf), dim=-1)
        out.append(m0 - m1)
    return torch.stack(out, dim=-1).reshape(*syms.shape[:-1], -1)


def lte_demodulate_host(syms: np.ndarray, np_vec: np.ndarray,
                        modulation: str = "qpsk") -> np.ndarray:
    """Numpy lte_demodulate of syms [n] with noise powers np_vec [n] ->
    [n*bps] (identical log-MAP math)."""
    syms = np.asarray(syms)
    np_vec = np.asarray(np_vec, dtype=np.float64)
    bps = _BPS[modulation]
    if modulation == "qpsk":
        # exact log-MAP closed form: the log(2cosh) term of the other
        # bit axis cancels in m0-m1, leaving llr = 2*sqrt(2)*I_or_Q/np
        s = (2.0 * np.sqrt(2.0)) / np_vec
        out = np.empty((syms.shape[0], 2))
        out[:, 0] = syms.real * s
        out[:, 1] = syms.imag * s
        return out.reshape(-1)
    table = mod_map(modulation)
    d = syms[:, None] - table[None, :]
    metric = -(d.real ** 2 + d.imag ** 2) / np_vec[:, None]
    idx = np.arange(table.shape[0])
    out = np.empty((syms.shape[0], bps))
    for b in range(bps):
        bit = (idx >> (bps - 1 - b)) & 1
        m0 = np.logaddexp.reduce(
            np.where(bit == 0, metric, -np.inf), axis=1)
        m1 = np.logaddexp.reduce(
            np.where(bit == 1, metric, -np.inf), axis=1)
        out[:, b] = m0 - m1
    return out.reshape(-1)
