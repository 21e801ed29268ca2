"""PBCH extraction and blind MIB decode.

Behavioral contract: reference pbch_extract / decode_mib
(reference src/searcher.cpp:1479-1692): channel-estimate all four
ports, then blindly try 4 frame phases x {1,2,4} TX ports; for each
candidate combine (single-port MRC or Alamouti SFBC zero-forcing), QPSK
soft-demodulate, descramble, de-ratematch to 40 coded bits, tail-biting
Viterbi decode, and check CRC16 under the port-count mask.  First success
wins; SFN = mod(sfn_bits*4 - frame_guess, 1024).

The PBCH RE positions are a host index plan per (n_symb_dl, v_shift mod
3); all 12 (frame phase, port count) candidates of every peak decode as
one batch, and only the host scan of the results keeps the reference's
first-success order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..cell import Cell, CpType, PhichDuration, PhichResource
from .coding import conv_decode_tailbite, conv_deratematch, crc_matrix
from .modulation import lte_demodulate
from .pn import lte_pn

_N_RB_TABLE = {0: 6, 1: 15, 2: 25, 3: 50, 4: 75, 5: 100}
_PHICH_RES = {0: PhichResource.ONE_SIXTH, 1: PhichResource.HALF,
              2: PhichResource.ONE, 3: PhichResource.TWO}


@lru_cache(maxsize=8)
def pbch_index_plan(n_symb_dl: int, v_shift_m3: int) -> np.ndarray:
    """[m_bit/2, 2] (symbol row, subcarrier) of PBCH REs over 4 frames.

    Skips positions that may carry CRS: mod(sc,3)==v_shift_m3 on symbols
    0,1 (and 3 for extended CP) -- reference searcher.cpp:1504-1520.
    """
    out = []
    for fr in range(4):
        for sym in range(4):
            for sc in range(72):
                if (sc % 3 == v_shift_m3) and (
                        sym in (0, 1) or (sym == 3 and n_symb_dl == 6)):
                    continue
                row = fr * 10 * 2 * n_symb_dl + n_symb_dl + sym
                out.append((row, sc))
    return np.asarray(out, dtype=np.int64)


def pbch_extract(cell: Cell, tfg: torch.Tensor, ce_list):
    """The PBCH symbols and the 4-port channel estimates at the PBCH REs
    (reference pbch_extract, searcher.cpp:1479-1520): tfg [n_ofdm, 72],
    ce_list four tensors like tfg -> (pbch_sym [n_re], pbch_ce [4, n_re])
    on tfg's device."""
    plan = torch.from_numpy(
        pbch_index_plan(cell.n_symb_dl(), cell.n_id_cell() % 3)).to(
            tfg.device)
    rows, cols = plan[:, 0], plan[:, 1]
    return tfg[rows, cols], torch.stack([c[rows, cols] for c in ce_list])


def _combine(pbch_sym, pbch_ce, np_v, n_ports: int):
    """Channel compensation: MRC (1 port) or Alamouti SFBC ZF (2/4 ports)
    over leading batch axes.  pbch_sym [..., n_re]; pbch_ce
    [..., 4, n_re]; np_v [..., 4].  Returns (syms, np_per_sym)
    (reference searcher.cpp:1567-1612)."""
    if n_ports == 1:
        h = pbch_ce[..., 0, :]
        h2 = h.real ** 2 + h.imag ** 2
        gain = torch.conj(h / h2.to(pbch_ce.dtype))
        syms = pbch_sym * gain
        np_out = np_v[..., 0:1] * (gain.real ** 2 + gain.imag ** 2)
        return syms, np_out

    x1 = pbch_sym[..., 0::2]
    x2 = pbch_sym[..., 1::2]

    def pair_mean(port):
        return (pbch_ce[..., port, 0::2] + pbch_ce[..., port, 1::2]) / 2

    if n_ports == 2:
        h1 = pair_mean(0)
        h2 = pair_mean(1)
        np_temp = ((np_v[..., 0] + np_v[..., 1]) / 2)[..., None] \
            .expand(x1.shape)
    else:
        # port pairs (0,2) and (1,3) alternate every 2 REs
        even_pair = (torch.arange(x1.shape[-1], device=x1.device) % 2) == 0
        h1 = torch.where(even_pair, pair_mean(0), pair_mean(1))
        h2 = torch.where(even_pair, pair_mean(2), pair_mean(3))
        np_temp = torch.where(even_pair,
                              ((np_v[..., 0] + np_v[..., 2]) / 2)[..., None],
                              ((np_v[..., 1] + np_v[..., 3]) / 2)[..., None])
    scale = (h1.real ** 2 + h1.imag ** 2 + h2.real ** 2 + h2.imag ** 2)
    s1 = (torch.conj(h1) * x1 + h2 * torch.conj(x2)) / scale
    s2 = torch.conj((-torch.conj(h2) * x1 + h1 * torch.conj(x2)) / scale)
    np_out_pair = ((torch.abs(h1) / scale) ** 2
                   + (torch.abs(h2) / scale) ** 2) * np_temp
    syms = torch.stack([s1, s2], dim=-1).reshape(pbch_sym.shape) \
        * np.sqrt(2.0)
    np_out = torch.stack([np_out_pair, np_out_pair], dim=-1) \
        .reshape(pbch_sym.shape)
    return syms, np_out


def _mib_impl(tfg, ce4, np_v, rows, cols, scr_sign, crc_m,
              frame_len_sym: int):
    """All 12 blind candidates (4 frame phases x {1,2,4} ports) of B peaks:
    combine -> log-MAP demod -> descramble -> de-ratematch -> tail-biting
    Viterbi -> CRC16.  tfg [B, n_sym, 72]; ce4 [B, 4, n_sym, 72]; np_v
    [B, 4]; rows/cols [B, n_re]; scr_sign [B, m_bit]; crc_m [24, 16].
    Returns (c_est [B, 3 port-cfgs, 4 phases, 40] bits, crc_calc
    [B, 3, 4, 16] unmasked parity of bits[:24])."""
    bsz = tfg.shape[0]
    dev = tfg.device
    offs = torch.arange(4, device=dev) * frame_len_sym         # frame phases
    rows_b = rows[:, None, :] + offs[None, :, None]            # [B, 4, n_re]
    cols_b = cols[:, None, :]
    b = torch.arange(bsz, device=dev)[:, None, None]
    pbch_sym = tfg[b, rows_b, cols_b]                          # [B, 4, n_re]
    pbch_ce = torch.stack([ce4[:, i][b, rows_b, cols_b] for i in range(4)],
                          dim=2)                               # [B, 4, 4, n_re]
    np_b = np_v[:, None, :]                                    # [B, 1, 4]

    e_all = torch.stack([
        lte_demodulate(*_combine(pbch_sym, pbch_ce, np_b, n), "qpsk")
        for n in (1, 2, 4)], dim=1)                            # [B, 3, 4, m_bit]
    e_all = e_all * scr_sign[:, None, None, :]                 # descramble
    e_flat = e_all.reshape(bsz * 12, -1)
    d_flat = conv_deratematch(e_flat, 40)
    c_flat = conv_decode_tailbite(d_flat)                      # [B*12, 40]
    # GF(2) product as a sum of 0/1 products (integer matmul has no CUDA
    # kernel in PyTorch)
    crc_flat = (c_flat[:, :24, None] * crc_m).sum(dim=1) % 2  # [B*12, 16]
    return c_flat.reshape(bsz, 3, 4, 40), crc_flat.reshape(bsz, 3, 4, -1)


def _mib_device_args(cell: Cell):
    """Host plans for _mib_impl beyond tfg/ce4/np_v: (rows, cols,
    scr_sign, frame_len_sym)."""
    n_symb_dl = cell.n_symb_dl()
    n_id_cell = cell.n_id_cell()
    frame_len_sym = 10 * 2 * n_symb_dl
    m_bit = 1920 if cell.cp_type is CpType.NORMAL else 1728
    scr = lte_pn(n_id_cell, m_bit).astype(np.float64)
    scr_sign = 1.0 - 2.0 * scr
    plan = pbch_index_plan(n_symb_dl, n_id_cell % 3)
    return plan[:, 0], plan[:, 1], scr_sign, frame_len_sym


@lru_cache(maxsize=1)
def _crc16_matrix() -> np.ndarray:
    return crc_matrix(24, "crc16").astype(np.int64)


def _scan_mib_results(cell: Cell, c_all: np.ndarray, crc_all: np.ndarray
                      ) -> Cell:
    """Host scan of the 12 decoded candidates in the reference's
    first-success-wins order (phases outer, ports inner), CRC16 checked
    under the per-port-count mask; unpack the MIB on success
    (searcher.cpp:1628-1686)."""
    for frame_timing_guess in range(4):
        for pi, n_ports in enumerate((1, 2, 4)):
            c_est = c_all[pi, frame_timing_guess]
            crc_calc = crc_all[pi, frame_timing_guess]
            if n_ports == 2:
                crc_calc = crc_calc ^ 1
            elif n_ports == 4:
                crc_calc = crc_calc ^ np.tile([0, 1], 8)
            if np.array_equal(crc_calc, c_est[24:40]):
                bits = c_est
                bw_packed = bits[0] * 4 + bits[1] * 2 + bits[2]
                n_rb_dl = _N_RB_TABLE.get(int(bw_packed), -1)
                phich_dur = PhichDuration.EXTENDED if bits[3] \
                    else PhichDuration.NORMAL
                phich_res = _PHICH_RES[int(bits[4] * 2 + bits[5])]
                sfn_high = 0
                for b in bits[6:14]:
                    sfn_high = (sfn_high << 1) | int(b)
                sfn = (sfn_high * 4 - frame_timing_guess) % 1024
                return cell.evolve(
                    n_ports=n_ports, n_rb_dl=n_rb_dl,
                    phich_duration=phich_dur, phich_resource=phich_res,
                    sfn=int(sfn))
    return cell
