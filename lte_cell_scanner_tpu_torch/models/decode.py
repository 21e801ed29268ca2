"""Decode back half: extract_tfg -> tfoec -> 4-port hex chan_est -> blind
MIB candidates for all SSS-accepted peaks of one capture, or of a whole
band scan, at once; and ``decode_mib``, the CE + MIB step of one peak's
compensated grid with any of the three interpolators (the staged back
half of the 2-stage and frequency-then-time interpolators).

The reference runs these as four separate stages per detected peak
(CellSearch.cpp:542-570); here each stage's device half carries a
leading peak axis, so the whole back half of a capture (or band) is one
pass per CP type (the two CP types have different grid shapes), and one
transfer brings the residual frequencies and decoded candidate bits to
the host.  Each peak reads its own row of a capture stack and carries
its own carrier frequencies.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cell import Cell
from ..device import real_dtype, tensor
from .chan_est import _chan_est_hex_impl, _hex_device_args_split, \
    chan_est, hex_plan_compact
from .mib import _crc16_matrix, _mib_device_args, _mib_impl, \
    _scan_mib_results
from .rs import RsDl
from .tfg import _tfg_impl, _tfg_plan, _tfoec_impl, _tfoec_plan


def _decode_impl(capbuf, ci, tfg_args, tfoec_args, ce01, ce23, mib_args,
                 crc_m, frame_len_sym: int):
    """The whole decode chain for B peaks of one CP type, peak b reading
    row ci[b] of the capture stack capbuf [C, n].  Returns (residual_f
    [B], c_est [B, 3, 4, 40], crc_calc [B, 3, 4, 16])."""
    locs_i, late, freq_fine, fs_true, ts = tfg_args
    tfg = _tfg_impl(capbuf, ci, locs_i, late, freq_fine, fs_true)
    residual_f, tfg_comp, _ts2 = _tfoec_impl(tfg, ts, *tfoec_args)
    c_all, crc_all = _ce_mib_impl(tfg_comp, ce01, ce23, mib_args, crc_m,
                                  frame_len_sym)
    return residual_f, c_all, crc_all


def _ce_mib_impl(tfg_comp, ce01, ce23, mib_args, crc_m,
                 frame_len_sym: int):
    """4-port hex channel estimation + the 12 blind MIB candidates of B
    compensated grids -> (c_est [B, 3, 4, 40], crc_calc [B, 3, 4, 16])."""
    ce_a, np_a = _chan_est_hex_impl(tfg_comp, *ce01)      # ports 0, 1
    ce_b, np_b = _chan_est_hex_impl(tfg_comp, *ce23)      # ports 2, 3
    ce4 = torch.cat([ce_a, ce_b], dim=1)                  # [B, 4, n_ofdm, 72]
    np_v = torch.cat([np_a, np_b], dim=1)
    return _mib_impl(tfg_comp, ce4, np_v, *mib_args, crc_m, frame_len_sym)


def _ce_mib_plans(cell: Cell, rs_dl: RsDl, n_ofdm: int):
    """Host plans of one peak's (ce01, ce23, mib) argument groups (the ce
    groups hold their hex plan keys in the last slot)."""
    def pair(ports):
        splits = [_hex_device_args_split(rs_dl, n_ofdm, p) for p in ports]
        small = tuple(np.stack(arrs) for arrs in zip(*(s[0] for s in splits)))
        return small + ([s[1] for s in splits],)

    rows, cols, scr_sign, _fl = _mib_device_args(cell)
    return pair((0, 1)), pair((2, 3)), (rows, cols, scr_sign)


def _cell_plans(cell: Cell, n_cap: int, fc_requested: float,
                fc_programmed: float, fs_programmed: float):
    """Host plans of one peak: (tfg, tfoec, ce01, ce23, mib) argument
    groups as numpy arrays."""
    rs_dl = RsDl(cell.n_id_cell(), 6, cell.cp_type)
    locs_i, late, locs, fs_true = _tfg_plan(cell, n_cap, fc_requested,
                                            fc_programmed, fs_programmed)
    n_ofdm = len(locs_i)
    tfg = (locs_i, late, cell.freq_fine, fs_true, locs)
    tf = _tfoec_plan(cell, rs_dl, n_ofdm) + (fc_requested, fc_programmed)
    return (tfg, tf) + _ce_mib_plans(cell, rs_dl, n_ofdm)


def _stack(groups, device: torch.device, rdt: torch.dtype):
    """Stack one argument group across peaks onto the device: float
    arrays in the working real type, complex in its complex type."""
    out = []
    for vals in zip(*groups):
        arr = np.stack([np.asarray(v) for v in vals])
        t = torch.from_numpy(arr).to(device)
        if t.is_complex():
            t = t.to(torch.complex64 if rdt == torch.float32
                     else torch.complex128)
        elif t.is_floating_point():
            t = t.to(rdt)
        out.append(t)
    return out


def _plan_tables(keys, device: torch.device, rdt: torch.dtype):
    """(idx [B, 2, n_ofdm*72, 6], w [B, 2, n_ofdm*72, 6]) for a [B][2]
    list of hex plan keys; each distinct plan is built and uploaded once
    per call."""
    uniq: Dict[tuple, tuple] = {}
    for k in {k for ks in keys for k in ks}:
        i32, w32 = hex_plan_compact(k)
        uniq[k] = (torch.from_numpy(i32.astype(np.int64)).to(device),
                   torch.from_numpy(w32).to(device))
    idx = torch.stack([torch.stack([uniq[k][0] for k in ks]) for ks in keys])
    w = torch.stack([torch.stack([uniq[k][1] for k in ks]) for ks in keys])
    return idx, w.to(rdt)


def _ce_mib_args(plans, device: torch.device, rdt: torch.dtype):
    """Device (ce01, ce23, mib, crc_m) arguments from per-peak
    _ce_mib_plans."""
    ce = []
    for g in (0, 1):
        small = _stack([p[g][:-1] for p in plans], device, rdt)
        ce.append(small + list(_plan_tables([p[g][-1] for p in plans],
                                            device, rdt)))
    mib_args = _stack([p[2] for p in plans], device, rdt)
    crc_m = torch.from_numpy(_crc16_matrix()).to(device)
    return ce[0], ce[1], mib_args, crc_m


def _run_group(cells: Sequence[Cell], fcs: Sequence[Tuple[float, float]],
               capbuf: torch.Tensor, carrier_idx: Sequence[int],
               fs_programmed: float) -> List[Cell]:
    """Decode a same-CP-type group of peaks as one batched pass: peak i
    reads row carrier_idx[i] of the capture stack capbuf [C, n] and
    plans at its (fc_requested, fc_programmed) = fcs[i]."""
    dev = capbuf.device
    rdt = real_dtype(dev)
    n_cap = int(capbuf.shape[-1])
    plans = [_cell_plans(c, n_cap, fcr, fcp, fs_programmed)
             for c, (fcr, fcp) in zip(cells, fcs)]
    tfg_args = _stack([p[0] for p in plans], dev, rdt)
    tfoec_args = _stack([p[1] for p in plans], dev, rdt)
    residual_f, c_all, crc_all = _decode_impl(
        capbuf, torch.as_tensor(list(carrier_idx), dtype=torch.int64,
                                device=dev),
        tfg_args, tfoec_args,
        *_ce_mib_args([p[2:] for p in plans], dev, rdt),
        10 * 2 * cells[0].n_symb_dl())
    residual_f = residual_f.cpu().numpy()
    c_all = c_all.cpu().numpy()
    crc_all = crc_all.cpu().numpy()
    out = []
    for i, c in enumerate(cells):
        c = c.evolve(freq_superfine=float(c.freq_fine + residual_f[i]))
        out.append(_scan_mib_results(c, c_all[i], crc_all[i]))
    return out


def _decode_grouped(cells: Sequence[Cell], fcs: Sequence[Tuple[float, float]],
                    capbuf: torch.Tensor, carrier_idx: Sequence[int],
                    fs_programmed: float) -> List[Cell]:
    """Run each CP type's peaks as one group; cells in input order."""
    groups: Dict[object, List[int]] = {}
    for i, c in enumerate(cells):
        groups.setdefault(c.cp_type, []).append(i)
    out: List[Optional[Cell]] = [None] * len(cells)
    for members in groups.values():
        decoded = _run_group([cells[i] for i in members],
                             [fcs[i] for i in members], capbuf,
                             [carrier_idx[i] for i in members],
                             fs_programmed)
        for i, c in zip(members, decoded):
            out[i] = c
    return out  # type: ignore[return-value]


def decode_back_half_batch(cells: Sequence[Cell], capbuf: torch.Tensor,
                           fc_requested: float, fc_programmed: float,
                           fs_programmed: float) -> List[Cell]:
    """Decode every SSS-accepted peak of one capture, grouped by CP type.
    Returns the cells in input order with freq_superfine set, and the MIB
    fields set where one of the 12 blind candidates passed its CRC."""
    return _decode_grouped(cells, [(fc_requested, fc_programmed)] * len(cells),
                           capbuf[None], [0] * len(cells), fs_programmed)


def decode_back_half_batch_multi(cells: Sequence[Cell],
                                 capbufs: torch.Tensor,
                                 carrier_idx: Sequence[int],
                                 fs_programmed: float) -> List[Cell]:
    """Band-scan variant: peak i reads row carrier_idx[i] of the capture
    stack capbufs [C, n] and decodes at its own fc_requested /
    fc_programmed."""
    return _decode_grouped(cells, [(c.fc_requested, c.fc_programmed)
                                   for c in cells],
                           capbufs, carrier_idx, fs_programmed)


def decode_back_half_fused(cell: Cell, capbuf: torch.Tensor,
                           fc_requested: float, fc_programmed: float,
                           fs_programmed: float) -> Cell:
    """decode_back_half_batch of one SSS-accepted peak (the
    peak-at-a-time order of ``SearchConfig(batch_peaks=False)``)."""
    return decode_back_half_batch([cell], capbuf, fc_requested,
                                  fc_programmed, fs_programmed)[0]


def decode_mib(cell: Cell, tfg: torch.Tensor, rs_dl: RsDl,
               interp: str = "hex") -> Cell:
    """Channel estimation of all four ports with ``interp`` + blind MIB
    decode of one peak's compensated grid tfg [n_ofdm, 72] (reference
    searcher.cpp:1526-1692); rs_dl holds the cell's reference signals."""
    dev = tfg.device
    rdt = tfg.real.dtype
    frame_len_sym = 10 * 2 * cell.n_symb_dl()
    if interp == "hex":
        plans = [_ce_mib_plans(cell, rs_dl, int(tfg.shape[0]))]
        c_all, crc_all = _ce_mib_impl(
            tfg[None], *_ce_mib_args(plans, dev, rdt), frame_len_sym)
    else:
        ces = [chan_est(cell, rs_dl, tfg, port, interp)
               for port in range(4)]
        rows, cols, scr_sign, _fl = _mib_device_args(cell)
        mib_args = [tensor(a, dev)[None] for a in (rows, cols, scr_sign)]
        c_all, crc_all = _mib_impl(
            tfg[None], torch.stack([ce for ce, _ in ces])[None],
            torch.stack([npv for _, npv in ces])[None], *mib_args,
            torch.from_numpy(_crc16_matrix()).to(dev), frame_len_sym)
    return _scan_mib_results(cell, c_all[0].cpu().numpy(),
                             crc_all[0].cpu().numpy())
