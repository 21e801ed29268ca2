"""Synthetic eNodeB downlink generator (the framework's fake transmitter).

Behavioral contract: the reference's only signal simulator,
Matlab/create_dl_sig.m:1-115 -- a 6-RB OFDM grid at 1.92 Msps carrying
CRS (ports 0+1), PSS/SSS in slots 0/10, and random-QPSK filler at a
configurable load factor.

Extension beyond the reference: optional PBCH transmission (1, 2, or 4
TX ports; 2-port Alamouti SFBC and 4-port SFBC+FSTD per 36.211 transmit
diversity) with a chosen SFN, so the *entire* receive chain -- including
every branch of the blind MIB decode -- can be self-tested against known
ground truth (the reference could only test through SSS detection on
synthetic data).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..cell import CpType
from ..constants import FS_WORK, NFFT, N_SC
from ..models.coding import conv_encode, conv_ratematch, crc_parity
from ..models.modulation import lte_modulate
from ..models.pn import lte_pn
from ..models.pss import pss_fd
from ..models.rs import RsDl, rs_dl_shift
from ..models.sss import sss_fd


def _mib_bits(n_rb_dl: int, sfn: int, phich_duration: str = "normal",
              phich_resource: str = "one") -> np.ndarray:
    bw_map = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}
    res_map = {"1/6": 0, "1/2": 1, "one": 2, "two": 3}
    bits = np.zeros(24, dtype=np.uint8)
    bw = bw_map[n_rb_dl]
    bits[0] = (bw >> 2) & 1
    bits[1] = (bw >> 1) & 1
    bits[2] = bw & 1
    bits[3] = 1 if phich_duration == "extended" else 0
    res = res_map[phich_resource]
    bits[4] = (res >> 1) & 1
    bits[5] = res & 1
    sfn_high = (sfn >> 2) & 0xFF
    for i in range(8):
        bits[6 + i] = (sfn_high >> (7 - i)) & 1
    return bits


def _pbch_symbols(n_id_cell: int, n_ports: int, period_sfn: int,
                  cp_type: CpType, n_rb_dl: int = 6) -> np.ndarray:
    """Encode one 40 ms PBCH period -> [n_ports, m_bit/2] RE symbols.

    period_sfn is the SFN of the period's first frame (multiple of 4).
    """
    m_bit = 1920 if cp_type is CpType.NORMAL else 1728
    mib = _mib_bits(n_rb_dl, period_sfn)
    crc = crc_parity(mib, "crc16")
    if n_ports == 2:
        crc = crc ^ 1
    elif n_ports == 4:
        crc = crc ^ np.tile(np.array([0, 1], dtype=np.uint8), 8)
    cw = np.concatenate([mib, crc])
    e = conv_ratematch(conv_encode(cw), m_bit)
    scr = lte_pn(n_id_cell, m_bit)
    x = lte_modulate(e ^ scr, "qpsk")            # [m_bit/2]
    if n_ports == 1:
        return x[None, :]
    x1 = x[0::2]
    x2 = x[1::2]
    if n_ports == 2:
        # 36.211 SFBC: y0 = (x1, x2)/sqrt2 ; y1 = (-x2*, x1*)/sqrt2
        y0 = np.stack([x1, x2], axis=1).reshape(-1) / np.sqrt(2)
        y1 = np.stack([-np.conj(x2), np.conj(x1)], axis=1).reshape(-1) \
            / np.sqrt(2)
        return np.stack([y0, y1])
    if n_ports == 4:
        # 36.211 SFBC+FSTD: ports (0,2) Alamouti-code even symbol pairs
        # onto REs 4i/4i+1 and are silent on 4i+2/4i+3; ports (1,3) carry
        # the odd pairs on REs 4i+2/4i+3 -- the pairing the blind decoder
        # inverts (reference searcher.cpp:1592-1601, mod(t,4) branch).
        n_pair = len(x1)
        even = (np.arange(n_pair) % 2) == 0
        ya = np.stack([x1, x2], axis=1).reshape(-1) / np.sqrt(2)
        yb = np.stack([-np.conj(x2), np.conj(x1)], axis=1).reshape(-1) \
            / np.sqrt(2)
        on_a = np.repeat(even, 2)
        return np.stack([np.where(on_a, ya, 0), np.where(on_a, 0, ya),
                         np.where(on_a, yb, 0), np.where(on_a, 0, yb)])
    raise ValueError("n_ports must be 1, 2, or 4 in the simulator")


def create_dl_sig(cp_type: CpType, n_subframes: int, slot_start: int,
                  n_id_1: int, n_id_2: int, load_factor: float,
                  rng: Optional[np.random.Generator] = None,
                  n_ports: int = 0, sfn: int = 0) -> np.ndarray:
    """Generate n_subframes ms of downlink signal at 1.92 Msps.

    n_ports=0 reproduces the reference simulator (no PBCH, CRS for ports
    0 and 1 both present); n_ports in {1, 2, 4} additionally transmits
    the PBCH (with CRS on every transmitting port).  ``sfn`` is the
    system frame number of the signal's first frame (slot_start is its
    position inside that frame).
    """
    rng = rng or np.random.default_rng()
    n_id_cell = 3 * n_id_1 + n_id_2
    n_ofdm = 7 if cp_type is CpType.NORMAL else 6
    rs_tab = RsDl(n_id_cell, 6, cp_type)
    if n_ports == 1:
        crs_ports: tuple = (0,)
    elif n_ports == 4:
        crs_ports = (0, 1, 2, 3)
    else:
        crs_ports = (0, 1)
    v3 = n_id_cell % 3

    # REs per PBCH symbol index (CRS-possible positions skipped)
    if n_ofdm == 7:
        per_sym = (48, 48, 72, 72)
    else:
        per_sym = (48, 48, 72, 48)
    per_frame = sum(per_sym)
    pbch_cache: Dict[int, np.ndarray] = {}

    def pbch_period(abs_frame: int) -> np.ndarray:
        period_sfn = (abs_frame - abs_frame % 4) % 1024
        if period_sfn not in pbch_cache:
            pbch_cache[period_sfn] = _pbch_symbols(
                n_id_cell, n_ports, period_sfn, cp_type)
        return pbch_cache[period_sfn]

    out = np.zeros(int(n_subframes * 0.001 * FS_WORK), dtype=np.complex128)
    offset = 0
    for t in range(2 * n_subframes):
        abs_slot = slot_start + t
        slot_num = abs_slot % 20
        abs_frame = sfn + abs_slot // 20
        for k in range(n_ofdm):
            syms = np.zeros(N_SC, dtype=np.complex128)

            # CRS (reference sim writes both port combs)
            rs_ind: list = []
            for port in crs_ports:
                sh = rs_dl_shift(slot_num, k, port, cp_type, n_id_cell)
                if sh >= 0:
                    ind = np.arange(sh, N_SC, 6)
                    syms[ind] = rs_tab.get_rs(slot_num, k)
                    rs_ind.extend(ind.tolist())

            # random QPSK filler at the requested load
            cand = np.setdiff1d(np.arange(N_SC), np.asarray(rs_ind, int))
            n_fill = round(len(cand) * load_factor)
            if n_fill:
                pick = rng.permutation(len(cand))[:n_fill]
                bits = rng.integers(0, 2, 2 * n_fill)
                syms[cand[pick]] = lte_modulate(bits, "qpsk")

            # PBCH in slot 1, symbols 0..3
            if n_ports and slot_num == 1 and k <= 3:
                mask = np.ones(N_SC, dtype=bool)
                if k in (0, 1) or (k == 3 and n_ofdm == 6):
                    mask[v3::3] = False
                sc_list = np.nonzero(mask)[0]
                pbch = pbch_period(abs_frame)
                pos = (abs_frame % 4) * per_frame + sum(per_sym[:k])
                for p in range(pbch.shape[0]):
                    syms[sc_list] = syms[sc_list] \
                        + pbch[p, pos: pos + len(sc_list)]

            # map to the 128-pt IDFT grid (DC stays empty)
            idft_in = np.zeros(NFFT, dtype=np.complex128)
            idft_in[1: 1 + N_SC // 2] = syms[N_SC // 2:]
            idft_in[NFFT - N_SC // 2:] = syms[: N_SC // 2]

            # PSS / SSS overwrite the center 62 subcarriers
            if slot_num % 10 == 0 and k >= n_ofdm - 2:
                ovw = pss_fd(n_id_2) if k == n_ofdm - 1 \
                    else sss_fd(n_id_1, n_id_2, slot_num).astype(complex)
                idft_in[1:37] = np.concatenate([ovw[31:62], np.zeros(5)])
                idft_in[NFFT - 36:] = np.concatenate([np.zeros(5), ovw[0:31]])

            td = np.fft.ifft(idft_in) * np.sqrt(NFFT)
            if cp_type is CpType.EXTENDED:
                cp_len = 32
            else:
                cp_len = 10 if k == 0 else 9
            td = np.concatenate([td[-cp_len:], td])
            out[offset: offset + len(td)] = td
            offset += len(td)

    assert offset == len(out)
    return out
