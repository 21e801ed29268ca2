"""LTE physical-layer tables the signal generator needs, in plain numpy.

Frozen copy of lte_cell_scanner_tpu_torch at commit 7ac09dbc9b43:
models/pss.py (pss_fd), models/sss.py (sss_fd), models/pn.py (lte_pn,
here the plain two-register recurrence), models/rs.py (rs_dl_symbols,
rs_dl_shift), models/coding.py (conv_encode, ratematch_map,
conv_ratematch, crc_parity), models/modulation.py (QPSK of
lte_modulate).  The benchmark's generator and its reference use these;
nothing here imports the program.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

N_RB_MAXDL = 110
_ZC_ROOTS = (25, 29, 34)


@lru_cache(maxsize=None)
def pss_fd(n_id_2: int) -> np.ndarray:
    """62-point frequency-domain PSS (complex128), 36.211 6.11.1."""
    u = _ZC_ROOTS[n_id_2]
    n = np.arange(63)
    r = np.delete(np.exp(-1j * np.pi * u * n * (n + 1) / 63.0), 31)
    r.flags.writeable = False
    return r


@lru_cache(maxsize=None)
def _mseq(taps) -> np.ndarray:
    x = np.zeros(31, dtype=np.int64)
    x[4] = 1
    for n in range(26):
        x[n + 5] = sum(x[n + t] for t in taps) % 2
    x = 1 - 2 * x
    x.flags.writeable = False
    return x


@lru_cache(maxsize=None)
def sss_fd(n_id_1: int, n_id_2: int, slot_num: int) -> np.ndarray:
    """62-point SSS (+-1) for slot 0 or 10, 36.211 6.11.2."""
    s_td, c_td, z_td = _mseq((0, 2)), _mseq((0, 3)), _mseq((0, 1, 2, 4))
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
        ssc1, ssc2 = s0_m0 * c0, s1_m1 * c1 * z1_m0
    else:
        ssc1, ssc2 = s1_m1 * c0, s0_m0 * c1 * z1_m1
    out = np.empty(62, dtype=np.int64)
    out[0::2] = ssc1
    out[1::2] = ssc2
    out.flags.writeable = False
    return out


@lru_cache(maxsize=None)
def _x1(length: int) -> np.ndarray:
    x = np.zeros(1600 + length + 31, dtype=np.uint8)
    x[0] = 1
    for n in range(len(x) - 31):
        x[n + 31] = x[n + 3] ^ x[n]
    return x


@lru_cache(maxsize=4096)
def lte_pn(c_init: int, length: int) -> np.ndarray:
    """Gold sequence c(n), 36.211 7.2 (Nc = 1600), uint8 0/1."""
    x1 = _x1(length)
    x2 = np.zeros(1600 + length + 31, dtype=np.uint8)
    x2[:31] = [(c_init >> t) & 1 for t in range(31)]
    for n in range(len(x2) - 31):
        x2[n + 31] = x2[n + 3] ^ x2[n + 2] ^ x2[n + 1] ^ x2[n]
    out = x1[1600: 1600 + length] ^ x2[1600: 1600 + length]
    out.flags.writeable = False
    return out


def rs_dl_symbols(slot_num: int, sym_num: int, n_id_cell: int, n_rb_dl: int,
                  normal_cp: bool) -> np.ndarray:
    """The 2*n_rb_dl CRS values of one symbol (36.211 6.10.1.1)."""
    c_init = ((1 << 10) * (7 * (slot_num + 1) + sym_num + 1)
              * (2 * n_id_cell + 1) + 2 * n_id_cell + int(normal_cp))
    c = lte_pn(c_init, 4 * N_RB_MAXDL).astype(np.float64)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2.0)
    lo = N_RB_MAXDL - n_rb_dl
    return r[lo: lo + 2 * n_rb_dl]


def rs_dl_shift(slot_num: int, sym_num: int, port: int, n_symb_dl: int,
                n_id_cell: int) -> int:
    """Comb offset of port's CRS in (slot, symbol); -1 where it has none."""
    table = {(0, 0): 0, (0, n_symb_dl - 3): 3, (1, 0): 3,
             (1, n_symb_dl - 3): 0}
    if (port, sym_num) in table:
        v = table[(port, sym_num)]
    elif port == 2 and sym_num == 1:
        v = 3 * (slot_num & 1)
    elif port == 3 and sym_num == 1:
        v = 3 + 3 * (slot_num & 1)
    else:
        return -1
    return (v + n_id_cell) % 6


_GENS = (0o133, 0o171, 0o165)
_PERM = np.array([1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
                  0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30])
_CRC16 = [1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]


def conv_encode(c: np.ndarray) -> np.ndarray:
    """Tail-biting rate-1/3 convolutional code (36.212 5.1.3.1): [3, n]."""
    c = np.asarray(c, dtype=np.uint8)
    d = np.zeros((3, len(c)), dtype=np.uint8)
    for i, g in enumerate(_GENS):
        for j in range(7):
            if (g >> (6 - j)) & 1:
                d[i] ^= np.roll(c, j)
    return d


def conv_ratematch(d: np.ndarray, n_e: int) -> np.ndarray:
    """Sub-block interleave and circular selection (36.212 5.1.4.2)."""
    n_c = d.shape[1]
    n_r = -(-n_c // 32)
    pad = n_r * 32 - n_c
    w = []
    for r in range(3):
        row = np.concatenate([np.full(pad, -1, dtype=np.int64),
                              np.arange(n_c, dtype=np.int64)])
        w.append(row.reshape(n_r, 32)[:, _PERM].T.reshape(-1))
    stream = np.repeat(np.arange(3), n_r * 32)
    w = np.concatenate(w)
    keep = w >= 0
    order_s, order_c = stream[keep], w[keep]
    k = np.arange(n_e) % len(order_c)
    return d[order_s[k], order_c[k]]


def crc16(a: np.ndarray) -> np.ndarray:
    """CRC16 parity bits of a (36.212 5.1.1, g_CRC16)."""
    poly = np.array(_CRC16, dtype=np.uint8)
    reg = np.concatenate([np.asarray(a, dtype=np.uint8),
                          np.zeros(16, dtype=np.uint8)])
    for i in range(len(a)):
        if reg[i]:
            reg[i: i + 17] ^= poly
    return reg[-16:]


def qpsk(bits: np.ndarray) -> np.ndarray:
    """36.211 7.1.2 QPSK: (1 - 2 b0 + j (1 - 2 b1)) / sqrt 2."""
    b = np.asarray(bits, dtype=np.float64).reshape(-1, 2)
    return ((1 - 2 * b[:, 0]) + 1j * (1 - 2 * b[:, 1])) / np.sqrt(2.0)
