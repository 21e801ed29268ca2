"""SSS detection (N_id_1, CP type, frame timing) and PSS/SSS fine FOE.

Behavioral contract: reference sss_detect_getce_sss / sss_detect_ml /
sss_detect / pss_sss_foe (reference src/searcher.cpp:516-850), in either
of two semantic variants selected by ``compat``:

- "production" (default): the modern reference C++ semantics -- segment
  mixers and frequency conversions run at the true sample rate
  fs_programmed*k_factor (searcher.cpp:523, 741, 848).
- "golden": the semantics of the reference's golden vectors (the MATLAB
  prototype, Matlab/sss_detect.m / pss_sss_foe.m): mixers at the nominal
  FS_LTE/16 rate, half-frame increment 9600*k (not 9600*k*s), a
  frame_start wrap window of exactly 19200 samples, and 1-based range
  upper bounds.

All per-peak device work carries an explicit leading peak axis B, and the
n_pss 5 ms-spaced PSS/SSS positions of a peak a second axis R (padded to
a capture-length-only capacity; padded rows carry weight 0).  Device
functions read a capture stack [C, n_cap] through per-peak carrier
indices ci [B]: a band scan's peaks of all carriers in one pass, one
carrier's peaks with C = 1.
Fractional-timing planning (k_factor strides, rounding) stays in float64
host scalars exactly as the reference's double math does; the host makes
the authoritative accept decision in float64 from the device's
log-likelihood tables.
"""

from __future__ import annotations

import logging
import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..cell import Cell, CpType
from ..constants import FS_LTE
from ..device import resolve_device, tensor, to_capture
from ..ops.dsp import (dft, extract_center_subcarriers, fshift_ramp,
                       matlab_range)
from .pss import PSS_FD
from .sss import SSS_FD
from .xcorr import round_i

log = logging.getLogger(__name__)


def _dft_segments_idx(capbuf: torch.Tensor, ci: torch.Tensor,
                      idx: torch.Tensor, foc_freq, fs_mix,
                      n_sc: int = 62) -> torch.Tensor:
    """Batched extract_psss (reference searcher.cpp:516-530): for window
    starts idx [B, R, 128] take the samples of capture row ci[b] of the
    stack capbuf [C, n_cap], apply the per-peak mixer
    exp(j*2*pi*foc_freq[b]*t/fs_mix[b]) (phase 0 at each segment start),
    rotate out the 2-sample timing margin, unitary 128-pt DFT, and return
    the n_sc center subcarriers -> [B, R, n_sc]."""
    segs = capbuf[ci[:, None, None], idx]
    ramp = fshift_ramp(128, foc_freq, fs_mix, capbuf.dtype, capbuf.device)
    segs = segs * ramp[:, None, :]
    segs = torch.roll(segs, -2, dims=-1)
    dft_out = dft(segs)
    return extract_center_subcarriers(dft_out, n_sc)


def _capture(capbuf, device=None) -> torch.Tensor:
    """A capture (or a [C, n_cap] stack) as a tensor: a tensor stays on
    its device unless ``device`` names another; a host array goes to
    ``device`` (None = the card) in the device's working type."""
    if isinstance(capbuf, torch.Tensor) and device is None:
        return capbuf
    return to_capture(capbuf, resolve_device(device))


def extract_dft_segments(capbuf, locs, foc_freq: float, fs_mix: float,
                         n_sc: int = 62, device=None) -> torch.Tensor:
    """The reference's extract_psss (searcher.cpp:516-530) at every
    integer window start of ``locs``: capbuf[l:l+128] through the mixer
    exp(j*2*pi*foc_freq*t/fs_mix) (phase 0 at each window start), the
    2-sample timing margin rotated out, a unitary 128-pt DFT, the n_sc
    center subcarriers -> [len(locs), n_sc] on the capture's device."""
    cap = _capture(capbuf, device)
    dev = cap.device
    idx = np.asarray(locs, dtype=np.int64)[:, None] + np.arange(128)
    return _dft_segments_idx(
        cap[None], torch.zeros(1, dtype=torch.int64, device=dev),
        torch.from_numpy(idx[None]).to(dev), tensor([foc_freq], dev),
        tensor([fs_mix], dev), n_sc)[0]


def _smooth13(h_raw: torch.Tensor) -> torch.Tensor:
    """13-tap boxcar over subcarriers with shrinking edges:
    h_sm[..., t] = mean(h_raw[..., max(0,t-6):min(61,t+6)+1])
    (reference searcher.cpp:584-588), accumulated left to right as the
    reference's sequential window mean."""
    n = h_raw.shape[-1]
    t = np.arange(n)
    lt = np.maximum(0, t - 6)
    rt = np.minimum(n - 1, t + 6)
    acc = torch.zeros_like(h_raw)
    for i in range(13):
        idx = lt + i
        valid = torch.from_numpy(idx <= rt).to(h_raw.device)
        idxc = torch.from_numpy(np.minimum(idx, n - 1)).to(h_raw.device)
        acc = acc + torch.where(valid, h_raw[..., idxc],
                                torch.zeros((), dtype=h_raw.dtype,
                                            device=h_raw.device))
    cnt = torch.from_numpy((rt - lt + 1).astype(np.float64)).to(
        device=h_raw.device, dtype=h_raw.real.dtype)
    return acc / cnt


def _pad_locs(n_cap: int, locs: np.ndarray):
    """Pad a half-frame location list to a capacity that depends only on
    the capture length (with margin for +-2000 ppm of crystal error).
    Returns (locs_padded [cap], mask [cap]); padded entries point at
    sample 200 and carry weight 0 downstream."""
    cap_n = int(n_cap / (9600 * 0.998)) + 2
    n = len(locs)
    if n > cap_n:  # pathological ppm beyond the design margin
        cap_n = n
    out = np.full(cap_n, 200, dtype=np.int64)
    out[:n] = np.asarray(locs, dtype=np.int64)
    mask = np.zeros(cap_n, dtype=bool)
    mask[:n] = True
    return out, mask


def _extend_pad(locs: np.ndarray, mask: np.ndarray, rows: int):
    """Grow a padded (locs, mask) pair to `rows` entries (same padding
    convention as _pad_locs) so every peak of a batch shares one shape."""
    if len(locs) >= rows:
        return locs, mask
    out_l = np.full(rows, 200, dtype=locs.dtype)
    out_l[: len(locs)] = locs
    out_m = np.zeros(rows, dtype=bool)
    out_m[: len(mask)] = mask
    return out_l, out_m


def _getce_prepare(cell: Cell, n_cap: int, fc_requested: float,
                   fc_programmed: float, fs_programmed: float,
                   compat: str = "production"):
    """Host half of sss_detect_getce_sss: the padded PSS DFT location
    list, its validity mask, and the per-peak mixer scalars (float64)."""
    peak_loc = float(cell.ind)
    peak_freq = cell.freq
    k_factor = (fc_requested - peak_freq) / fc_programmed
    fs_mix = FS_LTE / 16 if compat == "golden" \
        else fs_programmed * k_factor

    # No room to the left for the SSS? skip right by 5 subframes.
    if peak_loc + 9 < 162:
        peak_loc += 9600 * k_factor
    # golden: the MATLAB 1-based bound, one sample tighter than the C++
    # translation (searcher.cpp:562)
    stop = n_cap - 125 - 9 - (1 if compat == "golden" else 0)
    pss_loc_set = matlab_range(peak_loc, k_factor * 9600, float(stop))
    pss_locs = round_i(pss_loc_set)
    pss_dft_locs = pss_locs + 9 - 2
    locs, mask = _pad_locs(n_cap, pss_dft_locs)
    return locs, mask, peak_freq, fs_mix


def _getce_impl(capbuf, ci, idx_pss, idx_ext, idx_nrm, mask, freq, fs_mix,
                pss_fd_conj):
    """PSS channel estimates, 13-tap smoothing, noise power, SSS
    extraction at both CP offsets, and the inverse-noise MMSE combine into
    h1 (even half-frames) / h2 (odd) (reference searcher.cpp:600-631).
    idx_*: [B, R, 128]; mask [B, R]; freq/fs_mix [B]; pss_fd_conj
    [B, 62].  Rows where mask is False contribute exact zeros."""
    h_raw = _dft_segments_idx(capbuf, ci, idx_pss, -freq, fs_mix) \
        * pss_fd_conj[:, None, :]
    h_sm = _smooth13(h_raw)
    resid = h_sm - h_raw
    pss_np = torch.mean(resid.real ** 2 + resid.imag ** 2, dim=-1)
    sss_ext_raw = _dft_segments_idx(capbuf, ci, idx_ext, -freq, fs_mix)
    sss_nrm_raw = _dft_segments_idx(capbuf, ci, idx_nrm, -freq, fs_mix)
    zero = torch.zeros((), dtype=pss_np.dtype, device=pss_np.device)

    def combine(h, npv, m, nrm_raw, ext_raw):
        np_inv = torch.where(m, 1.0 / npv, zero)[..., None]   # [B, n, 1]
        h2 = h.real ** 2 + h.imag ** 2
        np_est = 1.0 / (1.0 + torch.sum(h2 * np_inv, dim=1))  # [B, 62]
        w = torch.conj(h) * np_inv
        nrm = np_est * torch.sum(w * nrm_raw, dim=1)
        ext = np_est * torch.sum(w * ext_raw, dim=1)
        return np_est, nrm, ext

    h1_np, h1_nrm, h1_ext = combine(
        h_sm[:, 0::2], pss_np[:, 0::2], mask[:, 0::2],
        sss_nrm_raw[:, 0::2], sss_ext_raw[:, 0::2])
    h2_np, h2_nrm, h2_ext = combine(
        h_sm[:, 1::2], pss_np[:, 1::2], mask[:, 1::2],
        sss_nrm_raw[:, 1::2], sss_ext_raw[:, 1::2])
    return h1_np, h2_np, h1_nrm, h2_nrm, h1_ext, h2_ext


@lru_cache(maxsize=1)
def _ml_tables() -> Tuple[np.ndarray, np.ndarray]:
    """SSS candidate tables for the ML stage, indexed by n_id_2:
    try12/try21 [3, 168, 124] float64 (slot-0|slot-10 and swapped)."""
    t = SSS_FD().astype(np.float64)                 # [168, 3, 2, 62]
    h1 = t[:, :, 0]
    h2 = t[:, :, 1]
    try12 = np.concatenate([h1, h2], axis=-1).transpose(1, 0, 2).copy()
    try21 = np.concatenate([h2, h1], axis=-1).transpose(1, 0, 2).copy()
    return try12, try21


def _ml_impl(h1_np, h2_np, h1_nrm, h2_nrm, h1_ext, h2_ext, try12, try21):
    """Log-likelihood of all 168 N_id_1 x {h12,h21} x {normal,ext}
    hypotheses (reference searcher.cpp:636-693).  try12/try21: [B, 168,
    124] real candidate tables of each peak's n_id_2.
    Returns (log_lik_nrm [B,168,2], log_lik_ext [B,168,2])."""
    np12 = torch.cat([h1_np, h2_np], dim=-1)          # [B, 124]
    est_nrm = torch.cat([h1_nrm, h2_nrm], dim=-1)
    est_ext = torch.cat([h1_ext, h2_ext], dim=-1)

    def loglik(est, trys):
        # phase-align the (real) candidate to the estimate, then Gaussian LL
        corr = torch.sum(torch.conj(est)[:, None, :] * trys, dim=-1)
        ang = torch.atan2(corr.imag, corr.real)
        rot = torch.complex(torch.cos(ang), -torch.sin(ang))[..., None]
        diff = trys * rot - est[:, None, :]
        return -torch.sum((diff.real ** 2 + diff.imag ** 2)
                          / np12[:, None, :], dim=-1)

    lln = torch.stack([loglik(est_nrm, try12), loglik(est_nrm, try21)],
                      dim=-1)
    lle = torch.stack([loglik(est_ext, try12), loglik(est_ext, try21)],
                      dim=-1)
    return lln, lle


class _Roms:
    """Device copies of the PSS/SSS tables the detect and FOE stages read."""

    def __init__(self, device: torch.device):
        try12, try21 = _ml_tables()
        self.pss_conj = tensor(np.conj(PSS_FD()), device)     # [3, 62]
        self.try12 = tensor(try12, device)                    # [3, 168, 124]
        self.try21 = tensor(try21, device)
        self.sss = tensor(SSS_FD().astype(np.float64), device)  # [168,3,2,62]


def _detect_impl(capbuf, ci, locs, mask, freq, fs_mix, n_id_2,
                 roms: _Roms):
    """Channel/SSS estimation plus the 168 x 2 x 2 ML table for a batch of
    peaks.  locs [B, R] are the PSS DFT window starts; the three
    [B, R, 128] gather maps (PSS window, extended-CP SSS at -160,
    normal-CP SSS at -137) are expanded on the device."""
    base = torch.arange(128, device=locs.device)
    lc = locs[..., None]
    ests = _getce_impl(capbuf, ci, lc + base, lc - (128 + 32) + base,
                       lc - (128 + 9) + base, mask, freq, fs_mix,
                       roms.pss_conj[n_id_2])
    lln, lle = _ml_impl(*ests, roms.try12[n_id_2], roms.try21[n_id_2])
    return ests + (lln, lle)


def _decide_sss(cell: Cell, lln: np.ndarray, lle: np.ndarray,
                thresh2_n_sigma: float, fc_requested: float,
                fc_programmed: float, fs_programmed: float,
                compat: str = "production") -> Cell:
    """Host decision half of sss_detect: CP type + frame timing from the
    log-likelihood tables, second-threshold acceptance (reference
    searcher.cpp:695-761).  Float64 host scalars."""
    if lln.max() > lle.max():
        log_lik, cp_type = lln, CpType.NORMAL
    else:
        log_lik, cp_type = lle, CpType.EXTENDED

    k_factor = (fc_requested - cell.freq) / fc_programmed
    # Sample-scale factor: 1 at the nominal rate; rescales LTE-timescale
    # constants to the dongle timescale (searcher.cpp:735).
    s = 16 / FS_LTE * fs_programmed * k_factor
    frame_start = cell.ind + (128 + 9 - 960 - 2) * s
    if log_lik[:, 0].max() > log_lik[:, 1].max():
        ll = log_lik[:, 0]
    else:
        ll = log_lik[:, 1]
        # golden/MATLAB: one half frame is 9600*k samples; the modern C++
        # applies the timescale factor twice (9600*k*s, searcher.cpp:741)
        frame_start += 9600 * k_factor * (1.0 if compat == "golden" else s)
    if compat == "golden":
        wrap_len = 2 * 9600.0            # MATLAB wrap(x, 0.5, 2*9600+0.5)
    else:
        wrap_len = (2 * 9600.0 - 0.5) * s + 0.5
    frame_start = (frame_start + 0.5) % wrap_len - 0.5

    n_id_1_est = int(np.argmax(ll))
    lik_final = ll[n_id_1_est]

    L = np.concatenate([lln.ravel(), lle.ravel()])
    lik_mean = L.mean()
    lik_var = L.var(ddof=1)

    if lik_final >= lik_mean + np.sqrt(lik_var) * thresh2_n_sigma:
        return cell.evolve(n_id_1=n_id_1_est, cp_type=cp_type,
                           frame_start=float(frame_start))
    return cell


def _foe_prepare(cell: Cell, n_cap: int, fc_requested: float,
                 fc_programmed: float, fs_programmed: float,
                 compat: str = "production"):
    """Host half of pss_sss_foe: SSS DFT locations, slot-number sequence,
    PSS-SSS distance, and the mixer/output-rate scalars."""
    k_factor = (fc_requested - cell.freq) / fc_programmed
    s = 16 / FS_LTE * fs_programmed * k_factor
    golden = compat == "golden"
    fs_mix = FS_LTE / 16 if golden else fs_programmed * k_factor
    fs_out = fs_mix
    ks = k_factor if golden else s

    if cell.cp_type is CpType.NORMAL:
        pss_sss_dist = int(round_i((128 + 9) * ks))
        first_sss_dft = cell.frame_start + (960 - 128 - 9 - 128) * ks
    elif cell.cp_type is CpType.EXTENDED:
        # the modern C++ uses raw k here even though elsewhere it uses s
        # (searcher.cpp:783); identical at the nominal rate.
        pss_sss_dist = int(round_i((128 + 32) * k_factor))
        first_sss_dft = cell.frame_start + (960 - 128 - 32 - 128) * ks
    else:
        raise ValueError("cp_type must be decided before pss_sss_foe")

    first_sss_dft = (first_sss_dft + 0.5) % (9600 * 2) - 0.5
    if first_sss_dft - 9600 * k_factor > -0.5:
        first_sss_dft -= 9600 * k_factor
        sn0 = 10
    else:
        sn0 = 0

    stop = n_cap - 127 - pss_sss_dist - 100 - (1 if golden else 0)
    sss_dft_loc_set = matlab_range(first_sss_dft, 9600 * ks, float(stop))
    sss_locs = round_i(sss_dft_loc_set)
    n_sss = len(sss_locs)
    # sn alternates starting at sn0 for k=0 (reference searcher.cpp:789-814)
    sn_seq = np.array([(sn0 + 10 * k) % 20 for k in range(n_sss)]) // 10

    # Compensate the per-segment phase-restart between SSS and PSS windows
    # (both variants use the nominal rate here, searcher.cpp:832).
    phase = np.pi * -cell.freq / (FS_LTE / 16 / 2) * -pss_sss_dist
    seg_phase = complex(np.cos(phase), np.sin(phase))
    locs, mask = _pad_locs(n_cap, sss_locs)
    sn_pad = np.zeros(len(locs), dtype=np.int64)
    sn_pad[:n_sss] = sn_seq
    return (locs, mask, sn_pad, pss_sss_dist, seg_phase, cell.freq, fs_mix,
            fs_out)


def _foe_impl(capbuf, ci, locs, mask, pss_sss_dist, freq, fs_mix,
              seg_phase, sn_pad, n_id_1, n_id_2, roms: _Roms):
    """Device half of pss_sss_foe for a batch of peaks: PSS channel
    estimates + smoothing, SSS extraction/derotation, and the weighted
    conj(SSS)*H_pss accumulation (reference searcher.cpp:816-848).
    locs/mask/sn_pad [B, R]; the other per-peak inputs [B].  Returns
    M [B]."""
    base = torch.arange(128, device=locs.device)
    idx_pss = locs[..., None] + pss_sss_dist[:, None, None] + base
    idx_sss = locs[..., None] + base
    pss_fd_conj = roms.pss_conj[n_id_2]                       # [B, 62]
    sss_expect = roms.sss[n_id_1[:, None], n_id_2[:, None], sn_pad]
    h_raw = _dft_segments_idx(capbuf, ci, idx_pss, -freq, fs_mix) \
        * pss_fd_conj[:, None, :]
    h_sm = _smooth13(h_raw)
    resid = h_sm - h_raw
    pss_np = torch.mean(resid.real ** 2 + resid.imag ** 2, dim=-1)
    sss_raw = _dft_segments_idx(capbuf, ci, idx_sss, -freq, fs_mix)
    sss_raw = sss_raw * seg_phase[:, None, None] * sss_expect
    h2 = h_sm.real ** 2 + h_sm.imag ** 2
    w = h2 / (2 * h2 * pss_np[..., None] + (pss_np ** 2)[..., None])
    w = torch.where(mask[..., None], w, torch.zeros((), dtype=w.dtype,
                                                    device=w.device))
    return torch.sum(torch.conj(sss_raw) * h_raw * w, dim=(1, 2))


def _detect_inputs(cells_fc, n_cap: int, fs_programmed: float,
                   compat: str, dev: torch.device):
    """The host plan of a detect batch: every peak's padded PSS DFT
    locations re-padded to the widest peak (a pathological-ppm peak can
    exceed the capture-length capacity), as device tensors (locs, mask,
    freq, fs_mix, n_id_2).  cells_fc: (cell, fc_requested, fc_programmed)
    triples."""
    preps = [_getce_prepare(c, n_cap, fcr, fcp, fs_programmed, compat)
             for c, fcr, fcp in cells_fc]
    rows = max(len(p[0]) for p in preps)
    padded = [_extend_pad(locs, mask, rows) for locs, mask, _f, _m in preps]
    return (tensor(np.stack([pl for pl, _ in padded]), dev),
            tensor(np.stack([pm for _, pm in padded]), dev),
            tensor([p[2] for p in preps], dev),
            tensor([p[3] for p in preps], dev),
            tensor([c.n_id_2 for c, _r, _p in cells_fc], dev))


def _detect_run(cells_fc, cap_stack: torch.Tensor, carrier_idx,
                fs_programmed: float, compat: str):
    """_detect_impl over a peak batch of the stack cap_stack [C, n_cap]:
    the six SSS estimates [B, 62] and (lln, lle) [B, 168, 2] as tensors."""
    dev = cap_stack.device
    return _detect_impl(
        cap_stack, tensor(carrier_idx, dev),
        *_detect_inputs(cells_fc, int(cap_stack.shape[-1]), fs_programmed,
                        compat, dev), _Roms(dev))


def _decide_batch(cells_fc, out, thresh2_n_sigma: float,
                  fs_programmed: float, compat: str) -> List[Cell]:
    lln_b = out[6].cpu().numpy().astype(np.float64)
    lle_b = out[7].cpu().numpy().astype(np.float64)
    return [_decide_sss(c, lln_b[i], lle_b[i], thresh2_n_sigma, fcr, fcp,
                        fs_programmed, compat)
            for i, (c, fcr, fcp) in enumerate(cells_fc)]


def sss_detect(cell: Cell, capbuf: torch.Tensor, thresh2_n_sigma: float,
               fc_requested: float, fc_programmed: float,
               fs_programmed: float, return_extras: bool = False,
               compat: str = "production"):
    """SSS detection of one peak of the capture capbuf [n_cap] (reference
    searcher.cpp:696-761): the updated Cell (n_id_1, cp_type and
    frame_start set on acceptance), plus with ``return_extras`` a dict of
    the SSS channel estimates and log-likelihood tables as numpy."""
    cells_fc = [(cell, fc_requested, fc_programmed)]
    out = _detect_run(cells_fc, capbuf[None], [0], fs_programmed, compat)
    cell_out = _decide_batch(cells_fc, out, thresh2_n_sigma, fs_programmed,
                             compat)[0]
    if not return_extras:
        return cell_out
    out = [o[0].cpu().numpy() for o in out]
    names = ("sss_h1_np_est", "sss_h2_np_est", "sss_h1_nrm_est",
             "sss_h2_nrm_est", "sss_h1_ext_est", "sss_h2_ext_est")
    extras = dict(zip(names, out[:6]))
    extras.update(log_lik_nrm=np.asarray(out[6], np.float64),
                  log_lik_ext=np.asarray(out[7], np.float64))
    return cell_out, extras


def sss_detect_getce_sss(cell: Cell, capbuf, fc_requested: float,
                         fc_programmed: float, fs_programmed: float,
                         compat: str = "production", device=None):
    """The SSS channel estimates of one peak for both CP hypotheses
    (the reference's sss_detect_getce_sss): (h1_np,
    h2_np, h1_nrm, h2_nrm, h1_ext, h2_ext), each [62] on the capture's
    device -- the inverse-noise MMSE combines of the even (h1) and odd
    (h2) half-frames, their noise estimates first."""
    out = _detect_run([(cell, fc_requested, fc_programmed)],
                      _capture(capbuf, device)[None], [0], fs_programmed,
                      compat)
    return tuple(o[0] for o in out[:6])


def sss_detect_ml(cell: Cell, h1_np, h2_np, h1_nrm, h2_nrm, h1_ext, h2_ext):
    """The ML stage of one peak (reference sss_detect_ml,
    searcher.cpp:636-693) over the estimates of sss_detect_getce_sss:
    the log-likelihoods (log_lik_nrm, log_lik_ext) [168, 2] of every
    N_id_1 x {slot 0|10, swapped} for each CP, on the estimates'
    device."""
    dev = h1_np.device
    try12, try21 = _ml_tables()
    lln, lle = _ml_impl(
        *(e[None] for e in (h1_np, h2_np, h1_nrm, h2_nrm, h1_ext, h2_ext)),
        tensor(try12[cell.n_id_2], dev)[None],
        tensor(try21[cell.n_id_2], dev)[None])
    return lln[0], lle[0]


def sss_detect_batch(cells: Sequence[Cell], capbuf, thresh2_n_sigma: float,
                     fc_requested: float, fc_programmed: float,
                     fs_programmed: float, compat: str = "production",
                     device=None) -> List[Cell]:
    """sss_detect over a whole peak list of one capture in one device
    pass; each peak is decided on the host in float64 as sss_detect
    decides it, so rejected peaks come back with n_id_1 = -1."""
    if not cells:
        return []
    cells_fc = [(c, fc_requested, fc_programmed) for c in cells]
    out = _detect_run(cells_fc, _capture(capbuf, device)[None],
                      [0] * len(cells), fs_programmed, compat)
    return _decide_batch(cells_fc, out, thresh2_n_sigma, fs_programmed,
                         compat)


def sss_detect_batch_multi(cells: Sequence[Cell], capbufs,
                           carrier_idx: Sequence[int],
                           thresh2_n_sigma: float, fs_programmed: float,
                           compat: str = "production",
                           device=None) -> List[Cell]:
    """sss_detect over the peaks of a band scan in one device pass: peak
    i reads row carrier_idx[i] of the capture stack capbufs [C, n_cap]
    and carries its own fc_requested / fc_programmed (filled by the peak
    search), so carriers tuned differently mix in one batch."""
    if not cells:
        return []
    cells_fc = [(c, c.fc_requested, c.fc_programmed) for c in cells]
    out = _detect_run(cells_fc, _capture(capbufs, device), carrier_idx,
                      fs_programmed, compat)
    return _decide_batch(cells_fc, out, thresh2_n_sigma, fs_programmed,
                         compat)


def _foe_run(cells_fc, cap_stack: torch.Tensor, carrier_idx,
             fs_programmed: float, compat: str) -> List[Cell]:
    """_foe_impl over a batch of SSS-accepted peaks of the stack
    cap_stack [C, n_cap], each plan re-padded to the widest peak; the
    cells with freq_fine set."""
    dev = cap_stack.device
    n_cap = int(cap_stack.shape[-1])
    preps = [_foe_prepare(c, n_cap, fcr, fcp, fs_programmed, compat)
             for c, fcr, fcp in cells_fc]
    rows = max(len(p[0]) for p in preps)
    padded = [_extend_pad(p[0], p[1], rows) for p in preps]
    sn = np.zeros((len(preps), rows), dtype=np.int64)
    for i, p in enumerate(preps):
        sn[i, :len(p[2])] = p[2]
    M = _foe_impl(
        cap_stack, tensor(carrier_idx, dev),
        tensor(np.stack([pl for pl, _ in padded]), dev),
        tensor(np.stack([pm for _, pm in padded]), dev),
        tensor([p[3] for p in preps], dev),
        tensor([p[5] for p in preps], dev),
        tensor([p[6] for p in preps], dev),
        tensor(np.array([p[4] for p in preps]), dev),
        tensor(sn, dev),
        tensor([c.n_id_1 for c, _r, _p in cells_fc], dev),
        tensor([c.n_id_2 for c, _r, _p in cells_fc], dev),
        _Roms(dev)).cpu().numpy()
    out = []
    for (c, _r, _p), p, m in zip(cells_fc, preps, M):
        pss_sss_dist, fs_out = p[3], p[7]
        freq_fine = c.freq + np.angle(complex(m)) / (2 * np.pi) \
            * fs_out / pss_sss_dist
        out.append(c.evolve(freq_fine=float(freq_fine)))
    return out


def pss_sss_foe(cell: Cell, capbuf: torch.Tensor, fc_requested: float,
                fc_programmed: float, fs_programmed: float,
                compat: str = "production") -> Cell:
    """Fine frequency-offset estimation from the PSS/SSS phase difference
    for one SSS-accepted peak (reference searcher.cpp:767-850)."""
    return _foe_run([(cell, fc_requested, fc_programmed)], capbuf[None],
                    [0], fs_programmed, compat)[0]


def pss_sss_foe_batch(cells: Sequence[Cell], capbuf, fc_requested: float,
                      fc_programmed: float, fs_programmed: float,
                      compat: str = "production",
                      device=None) -> List[Cell]:
    """pss_sss_foe over a list of SSS-accepted peaks of one capture in
    one device pass."""
    if not cells:
        return []
    return _foe_run([(c, fc_requested, fc_programmed) for c in cells],
                    _capture(capbuf, device)[None], [0] * len(cells),
                    fs_programmed, compat)


def pss_sss_foe_batch_multi(cells: Sequence[Cell], capbufs,
                            carrier_idx: Sequence[int],
                            fs_programmed: float,
                            compat: str = "production",
                            device=None) -> List[Cell]:
    """pss_sss_foe over the SSS-accepted peaks of a band scan in one
    device pass (the capbufs / carrier_idx convention of
    sss_detect_batch_multi)."""
    if not cells:
        return []
    return _foe_run([(c, c.fc_requested, c.fc_programmed) for c in cells],
                    _capture(capbufs, device), carrier_idx, fs_programmed,
                    compat)


# ---------------------------------------------------------------------------
# Fused SSS detection + fine FOE: one device pass for both stages.  The
# device re-derives the decision half of _decide_sss AND the _foe_prepare
# plan (CP/order/n_id_1 selection, frame timing, SSS DFT location grid,
# slot-number sequence) in its working precision so the FOE runs in the
# same pass.  The host still makes the authoritative decision in float64
# from the returned log-likelihood tables; the device's FOE result is
# used when its decision and timing plan agree with the host's, with a
# per-peak fallback to the staged pss_sss_foe otherwise (f32 ties and
# .5-boundary rounds on the card).
# ---------------------------------------------------------------------------


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def _detect_foe_impl(capbuf, ci, locs, mask, freq, fs_mix, n_id_2, ind,
                     k_factor, s_scale, roms: _Roms, golden: bool = False):
    """Fused sss_detect + pss_sss_foe for a batch of peaks.  Per-peak
    inputs [B]: ind (coarse peak location), k_factor, s_scale (the
    searcher.cpp:735 timescale factor); ``golden`` takes every golden
    difference of _decide_sss and _foe_prepare.  Returns (lln, lle, M,
    n_id_1, use_norm, late, dist, the SSS window starts [B, R] the FOE
    used, -1 past the last)."""
    n_cap = capbuf.shape[-1]
    ests = _detect_impl(capbuf, ci, locs, mask, freq, fs_mix, n_id_2, roms)
    lln, lle = ests[6], ests[7]                                 # [B, 168, 2]

    # --- _decide_sss core (searcher.cpp:695-761) ---------------------------
    use_norm = torch.amax(lln, dim=(1, 2)) > torch.amax(lle, dim=(1, 2))
    ll = torch.where(use_norm[:, None, None], lln, lle)
    late = torch.amax(ll[:, :, 0], dim=1) <= torch.amax(ll[:, :, 1], dim=1)
    ll_col = torch.where(late[:, None], ll[:, :, 1], ll[:, :, 0])
    n_id_1 = torch.argmax(ll_col, dim=1)

    zero = torch.zeros((), dtype=k_factor.dtype, device=k_factor.device)
    half_step = 9600.0 * k_factor * (1.0 if golden else s_scale)
    frame_start = ind + (128 + 9 - 960 - 2) * s_scale \
        + torch.where(late, half_step, zero)
    wrap_len = 2 * 9600.0 if golden else (2 * 9600.0 - 0.5) * s_scale + 0.5
    frame_start = torch.remainder(frame_start + 0.5, wrap_len) - 0.5

    # --- _foe_prepare (searcher.cpp:767-814) -------------------------------
    ks = k_factor if golden else s_scale
    dist_n = _round_half_away((128 + 9) * ks)
    dist_e = _round_half_away((128 + 32) * k_factor)   # raw k: :783
    dist = torch.where(use_norm, dist_n, dist_e)
    first = frame_start + torch.where(
        use_norm, (960 - 128 - 9 - 128) * ks, (960 - 128 - 32 - 128) * ks)
    first = torch.remainder(first + 0.5, 9600.0 * 2) - 0.5
    shift_back = first - 9600.0 * k_factor > -0.5
    first = torch.where(shift_back, first - 9600.0 * k_factor, first)
    sn0_half = shift_back.to(torch.int64)                 # sn0 // 10

    stride = 9600.0 * ks
    stop = n_cap - 127 - dist - 100 - (1 if golden else 0)
    j = torch.arange(locs.shape[1], device=locs.device)
    loc_set = first[:, None] + j * stride[:, None]
    foe_mask = loc_set <= stop[:, None]                   # matlab_range
    foe_locs = torch.where(foe_mask, _round_half_away(loc_set),
                           torch.full((), 200.0, dtype=loc_set.dtype,
                                      device=loc_set.device)).to(locs.dtype)
    sn = (sn0_half[:, None] + j) % 2

    phase = math.pi * -freq / (FS_LTE / 16 / 2) * -dist
    seg_phase = torch.complex(torch.cos(phase), torch.sin(phase)) \
        .to(capbuf.dtype)
    dist_i = dist.to(locs.dtype)
    M = _foe_impl(capbuf, ci, foe_locs, foe_mask, dist_i, freq, fs_mix,
                  seg_phase, sn, n_id_1, n_id_2, roms)
    return (lln, lle, M, n_id_1, use_norm, late, dist_i,
            torch.where(foe_mask, foe_locs, -1))


def _sss_foe_scalars(cell: Cell, fc_requested: float, fc_programmed: float,
                     fs_programmed: float, compat: str = "production"):
    k_factor = (fc_requested - cell.freq) / fc_programmed
    s = 16 / FS_LTE * fs_programmed * k_factor
    fs_out = FS_LTE / 16 if compat == "golden" \
        else fs_programmed * k_factor
    return k_factor, s, fs_out


def sss_foe_batch_fused(cells: Sequence[Cell], capbuf_stack: torch.Tensor,
                        carrier_idx: Sequence[int], thresh2_n_sigma: float,
                        fs_programmed: float, compat: str = "production",
                        skip_ids: frozenset = frozenset()) -> List[Cell]:
    """SSS detection AND fine FOE for a whole peak list in one device
    pass, each peak reading row carrier_idx[i] of the capture stack
    capbuf_stack [C, n_cap] (a single capture passes capbuf[None] and
    zeros).  Peaks the SSS gate rejects come back with n_id_1 = -1;
    accepted peaks carry freq_fine, except those whose cell ID is in
    ``skip_ids``, which come back accepted without it.  Each Cell carries
    its own fc_requested / fc_programmed (filled by the peak search)."""
    if not cells:
        return []
    dev = capbuf_stack.device
    n_cap = int(capbuf_stack.shape[-1])
    cells_fc = [(c, c.fc_requested, c.fc_programmed) for c in cells]
    sc = [_sss_foe_scalars(c, c.fc_requested, c.fc_programmed,
                           fs_programmed, compat) for c in cells]
    out = _detect_foe_impl(
        capbuf_stack, tensor(carrier_idx, dev),
        *_detect_inputs(cells_fc, n_cap, fs_programmed, compat, dev),
        tensor([float(c.ind) for c in cells], dev),
        tensor([x[0] for x in sc], dev), tensor([x[1] for x in sc], dev),
        _Roms(dev), golden=compat == "golden")
    lln_b, lle_b, M_b, nid1_d, usenorm_d, late_d, dist_d, locs_d = [
        o.cpu().numpy() for o in out]

    result: List[Cell] = []
    for i, c in enumerate(cells):
        fcr, fcp = c.fc_requested, c.fc_programmed
        lln = np.asarray(lln_b[i], np.float64)
        lle = np.asarray(lle_b[i], np.float64)
        cell = _decide_sss(c, lln, lle, thresh2_n_sigma, fcr, fcp,
                           fs_programmed, compat)
        if cell.n_id_1 < 0 or cell.n_id_cell() in skip_ids:
            result.append(cell)
            continue
        # the host's own decision and float64 timing plan must match what
        # the device FOE'd against before the device M is trusted: the
        # SSS window starts too, since one window a sample off moves
        # freq_fine by tens of Hz on a weak peak
        host_norm = cell.cp_type is CpType.NORMAL
        ll_host = lln if host_norm else lle
        host_late = bool(ll_host[:, 0].max() <= ll_host[:, 1].max())
        h_locs, h_mask, _sn, h_dist, _ph, _fq, _fm, _fo = _foe_prepare(
            cell, n_cap, fcr, fcp, fs_programmed, compat)
        if (int(nid1_d[i]) == cell.n_id_1
                and bool(usenorm_d[i]) == host_norm
                and bool(late_d[i]) == host_late
                and int(dist_d[i]) == h_dist
                and np.array_equal(locs_d[i][locs_d[i] >= 0],
                                   h_locs[h_mask])):
            fs_out = sc[i][2]
            freq_fine = cell.freq + np.angle(complex(M_b[i])) \
                / (2 * np.pi) * fs_out / h_dist
            result.append(cell.evolve(freq_fine=float(freq_fine)))
        else:
            # the f32 device plan rounded differently: this peak's FOE
            # runs again staged, from the host's float64 plan
            log.warning("SSS/FOE: device plan disagrees with the float64 "
                        "host plan for cell %d at %d; staged FOE re-run",
                        cell.n_id_cell(), cell.ind)
            result.append(pss_sss_foe(cell, capbuf_stack[carrier_idx[i]],
                                      fcr, fcp, fs_programmed, compat))
    return result
