"""Time/frequency grid extraction and superfine TOE/FOE/TOC/FOC.

Behavioral contract: reference extract_tfg and tfoec
(reference src/searcher.cpp:852-1069).

extract_tfg's per-symbol DFT loop is one batched gather + FFT over all
~854 OFDM symbols; the fractional, k_factor-stretched symbol positions are
planned on the host in float64 (the reference's double math) and handed
to the device as integer window starts plus per-symbol "late" phase-ramp
compensations (searcher.cpp:922-931).  tfoec's CRS-based estimators are
reductions over host-planned RS gathers.  Device functions carry a
leading peak axis B.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cell import Cell, CpType
from ..constants import FS_LTE
from ..ops.dsp import dft, extract_center_subcarriers, fshift_ramp
from .rs import RsDl
from .xcorr import round_i

_CN = np.concatenate([np.arange(-36, 0), np.arange(1, 37)])  # used SC offsets


def _phase_comp(late: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """exp(-j*2*pi*late/128 * cn) for per-symbol timing compensation:
    late [..., n] -> [..., n, 72]."""
    cn = torch.from_numpy(_CN).to(device=late.device, dtype=late.dtype)
    ang = (-2.0 * np.pi / 128.0) * late[..., None] * cn
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(dtype)


def plan_dft_locations(cell: Cell, fc_requested: float, fc_programmed: float,
                       fs_programmed: float, n_cap: int) -> np.ndarray:
    """Float64 host plan of the fractional DFT positions for 6 frames + 2
    slots of OFDM symbols (reference searcher.cpp:875-920)."""
    k_factor = (fc_requested - cell.freq_fine) / fc_programmed
    s = 16 / FS_LTE * fs_programmed * k_factor
    n_symb_dl = cell.n_symb_dl()
    if cell.cp_type is CpType.NORMAL:
        dft_location = cell.frame_start + 10 * s
    else:
        dft_location = cell.frame_start + 32 * s

    # See if we can advance the frame start by one subframe.
    if dft_location - 0.01 * fs_programmed * k_factor > -0.5:
        dft_location -= 0.01 * fs_programmed * k_factor

    n_ofdm = 6 * 10 * 2 * n_symb_dl + 2 * n_symb_dl
    locs = np.empty(n_ofdm, dtype=np.float64)
    sym_num = 0
    for t in range(n_ofdm):
        locs[t] = dft_location
        if n_symb_dl == 6:
            dft_location += (128 + 32) * s
        else:
            dft_location += (128 + 10) * s if sym_num == 6 else (128 + 9) * s
            sym_num = (sym_num + 1) % 7
    if round_i(locs[-1]) + 127 >= n_cap:
        raise ValueError("capture too short for the time/frequency grid")
    return locs


def _tfg_impl(capbuf: torch.Tensor, ci: torch.Tensor, locs_i: torch.Tensor,
              late: torch.Tensor, freq_fine: torch.Tensor,
              fs_true: torch.Tensor) -> torch.Tensor:
    """Device half of extract_tfg for B peaks: full-capture FOC mixer
    (searcher.cpp:892), windowed gather, batched 128-pt DFTs, and the
    per-symbol fractional-timing phase ramp (searcher.cpp:922-931).
    capbuf [C, n] is a capture stack and ci [B] each peak's row;
    locs_i/late [B, n_ofdm]; freq_fine/fs_true [B] -> tfg [B, n_ofdm, 72]."""
    dtype = capbuf.dtype
    foc = capbuf[ci] * fshift_ramp(capbuf.shape[-1], -freq_fine, fs_true,
                                   dtype, capbuf.device)       # [B, n]
    idx = locs_i[..., None] + torch.arange(128, device=locs_i.device)
    segs = torch.gather(foc, 1, idx.reshape(idx.shape[0], -1)) \
        .reshape(idx.shape)                                    # [B, n_ofdm, 128]
    dft_out = dft(segs)
    tfg = extract_center_subcarriers(dft_out, 72)
    return tfg * _phase_comp(late, dtype)


def _tfg_plan(cell: Cell, n_cap: int, fc_requested: float,
              fc_programmed: float, fs_programmed: float):
    """Host half of extract_tfg: integer window starts, fractional-timing
    compensations, timestamps, and the true mixer rate."""
    k_factor = (fc_requested - cell.freq_fine) / fc_programmed
    locs = plan_dft_locations(cell, fc_requested, fc_programmed,
                              fs_programmed, n_cap)
    int_locs = round_i(locs)
    late = int_locs.astype(np.float64) - locs
    return int_locs, late, locs, fs_programmed * k_factor


def _tfoec_impl(tfg, ts, rows0, cols0, tab0, rows_mid, cols_mid, tab_mid,
                r1_off, cols1, r1_tab, r2_off, cols2, r2_tab,
                fc_requested, fc_programmed):
    """Device half of tfoec for B peaks: superfine FOE from the CRS
    slot-to-slot phase drift, FOC with the k_factor_residual timestamp
    rescale, TOE from subcarrier k vs k+3 CRS phase, and the TOC phase ramp
    (searcher.cpp:952-1069).  Every plan argument carries the leading B
    axis; fc_requested/fc_programmed are [B].
    Returns (residual_f [B], tfg_comp [B, n_ofdm, 72], timestamps)."""
    dtype = tfg.dtype
    rdt = tfg.real.dtype
    b = torch.arange(tfg.shape[0], device=tfg.device)[:, None, None]

    # ---- superfine FOE from CRS phase drift across slots ------------------
    foe = torch.zeros(tfg.shape[0], dtype=dtype, device=tfg.device)
    for rows, cols, tab in ((rows0, cols0, tab0),
                            (rows_mid, cols_mid, tab_mid)):
        r = tfg[b, rows[:, :, None], cols[:, None, :]] * torch.conj(tab)
        foe = foe + torch.sum(torch.conj(r[:, :-1]) * r[:, 1:], dim=(1, 2))
    residual_f = torch.atan2(foe.imag, foe.real) / (2 * np.pi) / 0.0005

    # ---- FOC with timestamp rescale by k_factor_residual ------------------
    k_factor_residual = (fc_requested - residual_f) / fc_programmed
    ts = ts.to(rdt)
    tfg_comp_timestamp = k_factor_residual[:, None] * ts
    ang = 2 * np.pi * (-residual_f[:, None]) * tfg_comp_timestamp \
        / (FS_LTE / 16)
    rot = torch.complex(torch.cos(ang), torch.sin(ang)).to(dtype)
    tfg_comp = tfg * rot[..., None]
    late = ts - tfg_comp_timestamp
    tfg_comp = tfg_comp * _phase_comp(late, dtype)

    # ---- TOE by comparing subcarrier k with k+3 across RS symbols ---------
    r1v = tfg_comp[b, r1_off[:, :, None], cols1] * torch.conj(r1_tab)
    r2v = tfg_comp[b, r2_off[:, :, None], cols2] * torch.conj(r2_tab)
    toe1 = torch.sum(torch.conj(r1v) * r2v, dim=(1, 2))
    toe2 = torch.sum(torch.conj(r2v[:, :, 0:11]) * r1v[:, :, 1:12],
                     dim=(1, 2))
    toe = toe1 + toe2
    delay = -torch.atan2(toe.imag, toe.real) / 3 / (2 * np.pi / 128)

    # ---- TOC --------------------------------------------------------------
    cn = torch.from_numpy(_CN).to(device=tfg.device, dtype=rdt)
    ang = (2 * np.pi / 128) * delay[:, None] * cn
    comp = torch.complex(torch.cos(ang), torch.sin(ang)).to(dtype)
    tfg_comp = tfg_comp * comp[:, None, :]
    return residual_f, tfg_comp, tfg_comp_timestamp


def _tfoec_plan(cell: Cell, rs_dl: RsDl, n_ofdm: int):
    """Host half of tfoec: every CRS gather index and expected-RS table
    (float64), in _tfoec_impl argument order."""
    n_symb_dl = cell.n_symb_dl()
    n_slot = n_ofdm // n_symb_dl
    shift0 = rs_dl.get_shift(0, 0, 0)
    shift_mid = rs_dl.get_shift(0, n_symb_dl - 3, 0)
    rs0 = np.stack([rs_dl.get_rs(s, 0) for s in range(20)])            # [20,12]
    rs_mid = np.stack([rs_dl.get_rs(s, n_symb_dl - 3) for s in range(20)])

    slots = np.arange(n_slot)
    slot_mod = slots % 20
    rows0 = slots * n_symb_dl + 0
    rows_mid = slots * n_symb_dl + (n_symb_dl - 3)
    cols0 = shift0 + 6 * np.arange(12)
    cols_mid = shift_mid + 6 * np.arange(12)
    tab0 = rs0[slot_mod]                                   # [n_slot, 12]
    tab_mid = rs_mid[slot_mod]

    nt = 2 * n_slot - 1
    t_arr = np.arange(nt)
    cur_sym = np.where(t_arr & 1, n_symb_dl - 3, 0)
    cur_slot = (t_arr >> 1) % 20
    cur_off = (t_arr >> 1) * n_symb_dl + cur_sym
    cur_shift = np.where(t_arr & 1, shift_mid, shift0)
    nxt = t_arr + 1
    nxt_sym = np.where(nxt & 1, n_symb_dl - 3, 0)
    nxt_slot = (nxt >> 1) % 20
    nxt_off = (nxt >> 1) * n_symb_dl + nxt_sym
    nxt_shift = np.where(nxt & 1, shift_mid, shift0)

    swap = cur_shift >= nxt_shift      # r1 = the smaller-shift symbol
    r1_off = np.where(swap, nxt_off, cur_off)
    r1_shift = np.where(swap, nxt_shift, cur_shift)
    r1_sym = np.where(swap, nxt_sym, cur_sym)
    r1_slot = np.where(swap, nxt_slot, cur_slot)
    r2_off = np.where(swap, cur_off, nxt_off)
    r2_shift = np.where(swap, cur_shift, nxt_shift)
    r2_sym = np.where(swap, cur_sym, nxt_sym)
    r2_slot = np.where(swap, cur_slot, nxt_slot)

    def rs_val(slot_arr, sym_arr):
        out = np.empty((nt, 12), dtype=np.complex128)
        for i in range(nt):
            out[i] = rs_dl.get_rs(int(slot_arr[i]), int(sym_arr[i]))
        return out

    cols1 = r1_shift[:, None] + 6 * np.arange(12)[None, :]
    cols2 = r2_shift[:, None] + 6 * np.arange(12)[None, :]
    return (rows0, cols0, tab0, rows_mid, cols_mid, tab_mid,
            r1_off, cols1, rs_val(r1_slot, r1_sym),
            r2_off, cols2, rs_val(r2_slot, r2_sym))


def extract_tfg(cell: Cell, capbuf: torch.Tensor, fc_requested: float,
                fc_programmed: float, fs_programmed: float):
    """OFDM-demodulate one peak's capture into tfg [n_ofdm, 72] (a device
    tensor) + its float64 host timestamps."""
    dev = capbuf.device
    rdt = capbuf.real.dtype
    locs_i, late, locs, fs_true = _tfg_plan(cell, int(capbuf.shape[0]),
                                            fc_requested, fc_programmed,
                                            fs_programmed)
    tfg = _tfg_impl(capbuf[None], torch.zeros(1, dtype=torch.int64,
                                              device=dev),
                    torch.from_numpy(locs_i[None]).to(dev),
                    torch.from_numpy(late[None]).to(dev, rdt),
                    torch.tensor([cell.freq_fine], dtype=rdt, device=dev),
                    torch.tensor([fs_true], dtype=rdt, device=dev))
    return tfg[0], locs


def tfoec(cell: Cell, tfg: torch.Tensor, tfg_timestamp: np.ndarray,
          fc_requested: float, fc_programmed: float, rs_dl: RsDl):
    """Superfine FOE/FOC then TOE/TOC for one peak (reference
    searcher.cpp:952-1069).  Returns (cell_out, tfg_comp [n_ofdm, 72],
    tfg_comp_timestamp)."""
    dev = tfg.device
    rdt = tfg.real.dtype
    plan = _tfoec_plan(cell, rs_dl, int(tfg.shape[0]))
    args = [torch.from_numpy(np.asarray(a)[None]).to(dev) for a in plan]
    args = [a.to(tfg.dtype) if a.is_complex() else a for a in args]
    fc = [torch.tensor([v], dtype=rdt, device=dev)
          for v in (fc_requested, fc_programmed)]
    residual_f, tfg_comp, ts2 = _tfoec_impl(
        tfg[None], torch.from_numpy(np.asarray(tfg_timestamp,
                                               np.float64)[None]).to(dev),
        *args, *fc)
    cell_out = cell.evolve(
        freq_superfine=float(cell.freq_fine + residual_f[0].item()))
    return cell_out, tfg_comp[0], ts2[0].cpu().numpy()
