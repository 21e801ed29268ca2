"""Synthetic eNodeB downlink at 1.92 Msps, vectorised over symbols.

Frozen copy of lte_cell_scanner_tpu_torch/sim/dl_sig.py (create_dl_sig,
_mib_bits, _pbch_symbols) at commit 7ac09dbc9b43, with the same grid:
CRS on the transmitting ports, PSS/SSS in slots 0 and 10, PBCH in slot 1
(1, 2 or 4 ports, SFBC / SFBC+FSTD), random QPSK filler at the load
factor on the other subcarriers of the central six RBs, and the filler
and PBCH summed where they meet, as the original does.  Changes: every
symbol is built at once (the random draws therefore differ from the
original's, the deterministic parts do not), the MIB carries ``n_rb_dl``
(the original always sent 6), and the tables that do not depend on the
draws (CRS, the PBCH of each 40 ms period) are made once per cell.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .lte import (conv_encode, conv_ratematch, crc16, lte_pn, pss_fd, qpsk,
                  rs_dl_shift, rs_dl_symbols, sss_fd)

NFFT = 128
N_SC = 72
FRAME_LEN = 19200
_BW = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}


def mib_bits(n_rb_dl: int, sfn: int) -> np.ndarray:
    """The 24 MIB bits (36.331): bandwidth, PHICH normal / one, SFN's
    eight most significant bits, ten spare zeros."""
    bits = np.zeros(24, dtype=np.uint8)
    bw = _BW[n_rb_dl]
    bits[0:3] = [(bw >> 2) & 1, (bw >> 1) & 1, bw & 1]
    bits[3] = 0
    bits[4:6] = [1, 0]
    hi = (sfn >> 2) & 0xFF
    bits[6:14] = [(hi >> (7 - i)) & 1 for i in range(8)]
    return bits


@lru_cache(maxsize=8192)
def pbch_symbols(n_id_cell: int, n_ports: int, period_sfn: int,
                 normal_cp: bool, n_rb_dl: int) -> np.ndarray:
    """One 40 ms PBCH period -> [n_ports, m_bit / 2] RE values."""
    m_bit = 1920 if normal_cp else 1728
    mib = mib_bits(n_rb_dl, period_sfn)
    crc = crc16(mib)
    if n_ports == 2:
        crc = crc ^ 1
    elif n_ports == 4:
        crc = crc ^ np.tile(np.array([0, 1], dtype=np.uint8), 8)
    e = conv_ratematch(conv_encode(np.concatenate([mib, crc])), m_bit)
    x = qpsk(e ^ lte_pn(n_id_cell, m_bit))
    if n_ports == 1:
        return _frozen(x[None, :])
    x1, x2 = x[0::2], x[1::2]
    ya = np.stack([x1, x2], axis=1).reshape(-1) / np.sqrt(2)
    yb = np.stack([-np.conj(x2), np.conj(x1)], axis=1).reshape(-1) \
        / np.sqrt(2)
    if n_ports == 2:
        return _frozen(np.stack([ya, yb]))
    on_a = np.repeat(np.arange(len(x1)) % 2 == 0, 2)
    return _frozen(np.stack([np.where(on_a, ya, 0), np.where(on_a, 0, ya),
                             np.where(on_a, yb, 0), np.where(on_a, 0, yb)]))


def _frozen(a: np.ndarray) -> np.ndarray:
    """A cached table, read-only for every caller that shares it."""
    a.flags.writeable = False
    return a


@lru_cache(maxsize=None)
def _crs_tables(n_id_cell: int, n_ofdm: int, ports, normal_cp: bool):
    """[20, n_ofdm, 72] CRS values and their mask over the 20 slots."""
    val = np.zeros((20, n_ofdm, N_SC), dtype=np.complex128)
    mask = np.zeros((20, n_ofdm, N_SC), dtype=bool)
    for sn in range(20):
        for k in range(n_ofdm):
            rs = None
            for port in ports:
                sh = rs_dl_shift(sn, k, port, n_ofdm, n_id_cell)
                if sh < 0:
                    continue
                if rs is None:
                    rs = rs_dl_symbols(sn, k, n_id_cell, 6, normal_cp)
                val[sn, k, sh::6] = rs
                mask[sn, k, sh::6] = True
    val.flags.writeable = mask.flags.writeable = False
    return val, mask


def create_dl_sig(normal_cp: bool, n_subframes: int, slot_start: int,
                  n_id_1: int, n_id_2: int, load_factor: float,
                  rng: np.random.Generator, n_ports: int = 2, sfn: int = 0,
                  n_rb_dl: int = 6) -> np.ndarray:
    """n_subframes ms of one cell's downlink (complex128), starting at
    slot ``slot_start`` of frame ``sfn``; n_ports in {1, 2, 4} sends the
    PBCH on that many ports (0: no PBCH, CRS of ports 0 and 1)."""
    n_id_cell = 3 * n_id_1 + n_id_2
    n_ofdm = 7 if normal_cp else 6
    ports = {1: (0,), 4: (0, 1, 2, 3)}.get(n_ports, (0, 1))
    n_slots = 2 * n_subframes
    abs_slot = slot_start + np.arange(n_slots)
    slot_num = abs_slot % 20
    abs_frame = sfn + abs_slot // 20

    crs_val, crs_mask = _crs_tables(n_id_cell, n_ofdm, ports, normal_cp)
    syms = crs_val[slot_num].copy()                      # [S, K, 72]
    is_rs = crs_mask[slot_num]
    n_cand = N_SC - is_rs.sum(-1)
    n_fill = np.round(n_cand * load_factor).astype(np.int64)
    keys = rng.random(syms.shape)
    keys[is_rs] = 2.0
    rank = np.argsort(np.argsort(keys, axis=-1), axis=-1)
    fill = rank < n_fill[..., None]
    syms[fill] = qpsk(rng.integers(0, 2, 2 * int(fill.sum())))

    if n_ports:
        v3 = n_id_cell % 3
        per_sym = (48, 48, 72, 72) if n_ofdm == 7 else (48, 48, 72, 48)
        per_frame = sum(per_sym)
        scs = []
        for k in range(4):
            keep = np.ones(N_SC, dtype=bool)
            if k in (0, 1) or (k == 3 and n_ofdm == 6):
                keep[v3::3] = False
            scs.append((np.nonzero(keep)[0], sum(per_sym[:k])))
        for s in np.nonzero(slot_num == 1)[0]:
            f = int(abs_frame[s])
            pb = pbch_symbols(n_id_cell, n_ports, (f - f % 4) % 1024,
                              normal_cp, n_rb_dl).sum(0)
            for k, (sc, off) in enumerate(scs):
                pos = (f % 4) * per_frame + off
                syms[s, k, sc] += pb[pos: pos + len(sc)]

    grid = np.zeros(syms.shape[:2] + (NFFT,), dtype=np.complex128)
    grid[..., 1: 1 + N_SC // 2] = syms[..., N_SC // 2:]
    grid[..., NFFT - N_SC // 2:] = syms[..., : N_SC // 2]
    pss = pss_fd(n_id_2)
    for sn in (0, 10):
        at = np.nonzero(slot_num == sn)[0]
        sss = sss_fd(n_id_1, n_id_2, sn).astype(complex)
        for k, ovw in ((n_ofdm - 1, pss), (n_ofdm - 2, sss)):
            grid[at, k, 1:37] = np.concatenate([ovw[31:62], np.zeros(5)])
            grid[at, k, NFFT - 36:] = np.concatenate([np.zeros(5),
                                                      ovw[0:31]])

    return _time_domain(grid, normal_cp)


def _time_domain(grid: np.ndarray, normal_cp: bool) -> np.ndarray:
    """[slots, symbols, 128] grid -> samples, each symbol with its CP."""
    n_slots = grid.shape[0]
    td = np.fft.ifft(grid, axis=-1) * np.sqrt(NFFT)
    if normal_cp:
        first = np.concatenate([td[:, 0, -10:], td[:, 0]], axis=-1)
        rest = np.concatenate([td[:, 1:, -9:], td[:, 1:]], axis=-1)
        slots = np.concatenate([first, rest.reshape(n_slots, -1)], axis=-1)
    else:
        slots = np.concatenate([td[..., -32:], td], axis=-1).reshape(
            n_slots, -1)
    return slots.reshape(-1)
