"""Cell-specific downlink reference signals (CRS).

Behavioral contract: reference rs_dl_calc / rs_dl_shift_calc / RS_DL
(reference src/lte_lib.cpp:305-405): QPSK symbols from the Gold
sequence with c_init = 2^10*(7*(ns+1)+l+1)*(2*N_cell+1) + 2*N_cell + n_cp,
taken from the center n_rb_dl RBs of the maximal 110-RB grid; per-symbol
frequency shift v depends on (port, symbol, slot parity) and the cell ID.

Design: the whole 20-slot table is built as one vectorized numpy pass and
exposed as dense arrays (a ROM per cell), ready to be placed on device:
  rs(slot, sym)   -> (20, n_symb_dl, 2*n_rb_dl) complex128
  shift(slot, sym, port) -> (20, n_symb_dl, 4) int32 (-1 where no RS)
"""

from __future__ import annotations

import numpy as np

from .pn import lte_pn
from ..cell import CpType
from ..constants import N_RB_MAXDL


def rs_dl_symbols(slot_num: int, sym_num: int, n_id_cell: int, n_rb_dl: int,
                  cp_type: CpType) -> np.ndarray:
    """The 2*n_rb_dl RS QPSK values for one OFDM symbol."""
    n_cp = 1 if cp_type is CpType.NORMAL else 0
    c_init = ((1 << 10) * (7 * (slot_num + 1) + sym_num + 1)
              * (2 * n_id_cell + 1) + 2 * n_id_cell + n_cp)
    c = lte_pn(c_init, 4 * N_RB_MAXDL).astype(np.float64)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2.0)
    lo = N_RB_MAXDL - n_rb_dl
    return r[lo: lo + 2 * n_rb_dl]


def rs_dl_shift(slot_num: int, sym_num: int, port: int, cp_type: CpType,
                n_id_cell: int) -> int:
    """Frequency shift of the RS comb for (slot, symbol, port); -1 if no RS."""
    n_symb_dl = 7 if cp_type is CpType.NORMAL else 6
    v = None
    if port == 0 and sym_num == 0:
        v = 0
    elif port == 0 and sym_num == n_symb_dl - 3:
        v = 3
    elif port == 1 and sym_num == 0:
        v = 3
    elif port == 1 and sym_num == n_symb_dl - 3:
        v = 0
    elif port == 2 and sym_num == 1:
        v = 3 * (slot_num & 1)
    elif port == 3 and sym_num == 1:
        v = 3 + 3 * (slot_num & 1)
    if v is None:
        return -1
    return (v + n_id_cell) % 6


class RsDl:
    """Precomputed CRS tables for one cell (reference RS_DL class)."""

    def __init__(self, n_id_cell: int, n_rb_dl: int, cp_type: CpType):
        self.n_id_cell = n_id_cell
        self.n_rb_dl = n_rb_dl
        self.cp_type = cp_type
        self.n_symb_dl = 7 if cp_type is CpType.NORMAL else 6

        n_symb = self.n_symb_dl
        self.rs_table = np.zeros((20, n_symb, 2 * n_rb_dl), dtype=np.complex128)
        self.shift_table = np.full((20, n_symb, 4), -1, dtype=np.int32)
        for slot in range(20):
            for t in range(3):
                sym = (n_symb - 3) if t == 2 else t
                self.rs_table[slot, sym] = rs_dl_symbols(
                    slot, sym, n_id_cell, n_rb_dl, cp_type)
                if t in (0, 2):
                    ports = (0, 1)
                else:
                    ports = (2, 3)
                for p in ports:
                    self.shift_table[slot, sym, p] = rs_dl_shift(
                        slot, sym, p, cp_type, n_id_cell)

    def get_rs(self, slot_num: int, sym_num: int) -> np.ndarray:
        return self.rs_table[slot_num, sym_num]

    def get_shift(self, slot_num: int, sym_num: int, port: int) -> int:
        return int(self.shift_table[slot_num, sym_num, port])
