"""Batched band scan on one device.

The reference scans each 100 kHz carrier serially in the CellSearch main
loop (reference src/CellSearch.cpp:469-471), an embarrassingly parallel
outer loop.  Here the carriers of a band become a leading batch axis:
for each chunk of carriers the front end (correlation, k_factor fold,
delay-spread combining, hypothesis collapse, sp_est), the chi-squared
threshold and greedy peak search, the SSS + fine FOE stage and the
fused decode each run once over every carrier (or every peak) of the
chunk, and only peak records and decode results come back to the host.

Front-end routes, chosen per chunk from what the host can see (as the
TPU package's ``parallel/carriers.py::_plan_scan_bands`` chooses):

- the fused v4 kernels (``ops/corr_fold_cuda.py``: correlation and fold
  in one launch for the whole chunk) when the middle carrier's fold-start
  table fits the v4 gate and every carrier's exact starts lie within one
  sample of it -- all carriers then share the middle carrier's templates
  and starts;
- otherwise the v2 kernels (``ops/corr_cuda.py``) carrier by carrier,
  with the middle carrier's templates and each carrier's exact fold;
- the exact correlation with each carrier's own templates and starts
  when the kernels are not in use (the CPU default).

int8 operands when every capture sits on the 8-bit ADC grid, bf16
otherwise.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cell import Cell
from ..constants import HALF_FRAME_LEN, PSS_TD_LEN
from ..device import resolve_device, tensor, to_capture
from ..models.decode import decode_back_half_batch_multi
from ..models.peaks import (PEAK_CAP, cells_from_peak_records, peak_search,
                            peak_search_device)
from ..models.search import (SearchConfig, compute_z_th1, decode_back_half,
                             refine_peaks)
from ..models.sss_detect import sss_foe_batch_fused
from ..models.xcorr import (KernelOperands, _corr_stage, _fold_stage,
                            _post_fold_stage, combine_start_indices,
                            pss_templates, use_kernel_corr)
from ..ops import corr_cuda
from ..ops.corr_fold_cuda import corr_fold_bf16, corr_fold_int8, v4_kv_for
from ..utils.debug import debug_export, get_dump, stage

log = logging.getLogger(__name__)


def plan_carrier_inputs(capbufs: Sequence[np.ndarray],
                        fc_list: Sequence[float],
                        f_search_set: np.ndarray,
                        fc_programmed_list: Sequence[float],
                        fs_programmed: float):
    """Stack per-carrier captures with their template and fold plans.

    Templates and fold start indices differ per carrier because k_factor
    depends on fc (searcher.cpp:145-151, 296-298).  Returns (capbufs
    [C, n_cap], templates [C, 3, n_f, 137] complex128, start_idx
    [C, n_f, n_comb] int64, n_comb_xc); the device converts to its own
    working types."""
    n_cap = len(capbufs[0])
    if any(len(c) != n_cap for c in capbufs):
        raise ValueError("all captures must have equal length")
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_comb_xc = (n_lags - 100) // HALF_FRAME_LEN
    cap = np.stack([np.asarray(c) for c in capbufs])
    tmpl = np.stack([pss_templates(f_search_set, fc, fcp, fs_programmed)
                     for fc, fcp in zip(fc_list, fc_programmed_list)])
    starts = np.stack([combine_start_indices(f_search_set, fc, fcp,
                                             fs_programmed, n_comb_xc)
                       for fc, fcp in zip(fc_list, fc_programmed_list)])
    return cap, tmpl, starts, n_comb_xc


def v4_band_kv(starts) -> int:
    """The v4 gate for a whole chunk: the TPU kernel's row-window width
    (256, or 384 for long captures) when the middle carrier's fold-start
    table fits a v4 window AND every carrier's exact starts lie within 1
    sample of it; 0 for the v2 route.  Edge carriers drift from the
    middle table by ~9600*m*df/fc samples per period, so a chunk spanning
    tens of MHz would push late periods past the +-ds_comb_arm = 2
    combining arm."""
    starts = np.asarray(starts)
    smid = starts[starts.shape[0] // 2]
    kv = v4_kv_for(smid)
    if kv is None:
        return 0
    dev = np.max(np.abs(starts.astype(np.int64)
                        - smid[None].astype(np.int64)))
    return kv if int(dev) <= 1 else 0


@dataclass
class BandRoute:
    """How a chunk's front end runs.  kern None: the exact correlation.
    With kern and mid_starts (the middle carrier's int32 fold-start
    table on the device): the fused v4 kernels.  With kern alone: the v2
    kernels and each carrier's exact fold."""
    kern: Optional[KernelOperands]
    mid_starts: Optional[torch.Tensor] = None


def _plan_scan_bands(tmpl: np.ndarray, starts: np.ndarray,
                     capbufs: Sequence[np.ndarray], cfg: SearchConfig,
                     device: torch.device) -> BandRoute:
    """The chunk's route and its shared operands: one set of template
    planes (the middle carrier's: adjacent carriers' templates differ
    only through k_factor, ~4e-5 relative phase across 10 MHz, two orders
    below the bf16 quantization) serves every carrier; int8 when every
    capture is on the ADC grid (checked on the host copies)."""
    if not use_kernel_corr(cfg.corr_backend, device):
        return BandRoute(None)
    mid = tmpl.shape[0] // 2
    tmid = tmpl[mid].reshape(-1, PSS_TD_LEN)
    if all(corr_cuda.is_adc_grid(c) for c in capbufs):
        taps, scale = corr_cuda.template_planes_int8(tmid, device)
        kern = KernelOperands("int8", taps, float(scale))
    else:
        kern = KernelOperands(
            "bf16", corr_cuda.template_planes_bf16(tmid, device), None)
    if v4_band_kv(starts):
        return BandRoute(kern, torch.from_numpy(
            starts[mid].astype(np.int32)).to(device))
    return BandRoute(kern)


def _front_batch(cap_t: torch.Tensor, tmpl: np.ndarray, starts: np.ndarray,
                 route: BandRoute, ds_comb_arm: int):
    """Lean front end of a chunk: cap_t [C, n_cap] on the device ->
    (slab [C, 3, 2*arm+1, 9600], pow_c [C, 3, 9600], frq_c [C, 3, 9600],
    sp_inc [C, 9600])."""
    dev = cap_t.device
    n_c = cap_t.shape[0]
    n_f, n_comb = starts.shape[1:]
    kern = route.kern
    if route.mid_starts is not None:
        if kern.precision == "int8":
            raw = corr_fold_int8(corr_cuda.capture_planes_int8(cap_t),
                                 kern.taps, route.mid_starts)
        else:
            raw = corr_fold_bf16(corr_cuda.capture_planes_bf16(cap_t),
                                 kern.taps, route.mid_starts)
        # f32 scale as the TPU route forms it: 1/n_comb, times the int8
        # power scale, applied to the raw sums
        scale = np.float32(1.0 / n_comb)
        if kern.power_scale is not None:
            scale = scale * np.float32(kern.power_scale)
        xc_single = (raw * torch.tensor(scale, device=dev)).reshape(
            n_c, 3, n_f, HALF_FRAME_LEN)
    else:
        rdt = cap_t.real.dtype
        # the exact route's own templates per carrier; the v2 kernels read
        # the shared planes kern.taps
        tmpl_t = tensor(tmpl, dev) if kern is None else None
        singles = []
        for c in range(n_c):
            xc2, _xc, pw_scale = _corr_stage(
                cap_t[c], None if tmpl_t is None else tmpl_t[c], False, kern)
            singles.append(_fold_stage(
                xc2, torch.from_numpy(starts[c]).to(dev), rdt, pw_scale))
        xc_single = torch.stack(singles)
    (_s, _i, pow_c, frq_c, _sp, sp_inc, slab) = _post_fold_stage(
        xc_single, cap_t, ds_comb_arm, True)
    return slab, pow_c, frq_c, sp_inc


def scan_band(captures: Sequence[Tuple[np.ndarray, float, float]],
              f_search_set: np.ndarray, fs_programmed: float,
              config: Optional[SearchConfig] = None,
              max_carriers_per_program: int = 64,
              device=None, timings: Optional[Dict[str, float]] = None
              ) -> List[List[Cell]]:
    """Scan many carriers at once on one device (None = the card).

    captures: sequence of (capbuf, fc_requested, fc_programmed).
    Returns one decoded-cell list per carrier, in carrier order (feed to
    models.search.dedup).  The peak search follows the device, as in
    cell_search: on CUDA the threshold and greedy peak search run on the
    device and only the peak records come back (a chunk where a carrier
    fills its PEAK_CAP records takes the unbounded host search); on the
    CPU the collapsed maps come back and the host search runs.

    The band runs in chunks of ``max_carriers_per_program`` carriers:
    the bound is set by the v2 route's ~28 MB-per-carrier power map (the
    fused v4 route never materializes it); chunking keeps memory bounded
    and each chunk shares its middle carrier's templates.

    timings: if a dict is given, each stage's wall seconds, summed over
    the chunks, are added to it under cell_search's names (staging, then
    xcorr_pss, the front end; peak_search, on the device or the host;
    sss_foe_fused, decode_fused; the stages of models/search.py's
    refine_peaks and decode_back_half where the config takes them)."""
    cfg = config or SearchConfig()
    dev = resolve_device(device)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    limit = max(1, max_carriers_per_program)
    out: List[List[Cell]] = []
    for i in range(0, len(captures), limit):
        out.extend(_scan_chunk(captures[i: i + limit], f_search_set,
                               fs_programmed, cfg, dev, timings))
    return out


def _scan_chunk(captures, f_search_set: np.ndarray, fs_programmed: float,
                cfg: SearchConfig, dev: torch.device,
                timings: Optional[Dict[str, float]]) -> List[List[Cell]]:
    with stage("staging", dev, timings):
        capbufs = [np.asarray(c[0]) for c in captures]
        fc_list = [float(c[1]) for c in captures]
        fcp_list = [float(c[2]) for c in captures]
        cap, tmpl, starts, n_comb_xc = plan_carrier_inputs(
            capbufs, fc_list, f_search_set, fcp_list, fs_programmed)
        route = _plan_scan_bands(tmpl, starts, capbufs, cfg, dev)
        cap_t = to_capture(cap, dev)
    with stage("xcorr_pss", dev, timings):
        slabs, pow_c, frq_c, sp_inc = _front_batch(cap_t, tmpl, starts,
                                                   route, cfg.ds_comb_arm)
    if dev.type == "cuda":
        with stage("peak_search", dev, timings):
            # the chi-squared threshold scale: compute_z_th1 with a unit
            # sp_incoherent (one definition of the detection constant)
            z_scale = float(compute_z_th1(np.float64(1.0), n_comb_xc,
                                          cfg.ds_comb_arm,
                                          cfg.thresh1_n_nines))
            recs, ns = peak_search_device(pow_c, frq_c, slabs,
                                          sp_inc * z_scale, cfg.ds_comb_arm)
            # records and counts come back in one copy
            n_c = len(capbufs)
            vec = torch.cat([recs.reshape(n_c, -1),
                             ns.to(recs.dtype)[:, None]], dim=1).cpu().numpy()
        recs_h = vec[:, :-1].reshape(tuple(recs.shape))
        ns_h = np.rint(vec[:, -1]).astype(np.int64)
        if int(ns_h.max()) < PEAK_CAP:
            all_peaks: List[Cell] = []
            carrier_of: List[int] = []
            dump = get_dump() is not None
            for i in range(n_c):
                cells_i = cells_from_peak_records(
                    recs_h[i], int(ns_h[i]), f_search_set, fc_list[i],
                    fcp_list[i])
                if dump:
                    sp_i = sp_inc[i].cpu().numpy()
                    _export_carrier(pow_c[i], frq_c[i], sp_i,
                                    compute_z_th1(sp_i, n_comb_xc,
                                                  cfg.ds_comb_arm,
                                                  cfg.thresh1_n_nines),
                                    cells_i)
                all_peaks.extend(cells_i)
                carrier_of.extend([i] * len(cells_i))
            return _refine_from_peaks(all_peaks, carrier_of, cap_t, fc_list,
                                      fcp_list, fs_programmed, cfg, timings)
        log.warning("band scan: a carrier filled its %d peak records; "
                    "host peak search for this chunk of %d carriers",
                    PEAK_CAP, n_c)
    return refine_band(pow_c, frq_c, sp_inc, slabs, cap_t, fc_list,
                       fcp_list, f_search_set, fs_programmed, n_comb_xc,
                       cfg, timings)


def refine_band(pow_c: torch.Tensor, frq_c: torch.Tensor,
                sp_inc: torch.Tensor, slabs: torch.Tensor,
                cap_t: torch.Tensor, fc_list: Sequence[float],
                fcp_list: Sequence[float], f_search_set: np.ndarray,
                fs_programmed: float, n_comb_xc: int, cfg: SearchConfig,
                timings: Optional[Dict[str, float]] = None
                ) -> List[List[Cell]]:
    """Host back half of a band scan: per-carrier host peak search on the
    front end's [C, ...] maps, then the batched SSS/FOE/decode stages
    over all peaks of all carriers."""
    with stage("peak_search", cap_t.device, timings):
        pow_c = pow_c.cpu().numpy()
        frq_c = frq_c.cpu().numpy()
        sp_inc = sp_inc.cpu().numpy()
        slabs = slabs.cpu().numpy()
        all_peaks: List[Cell] = []
        carrier_of: List[int] = []
        for i in range(len(fc_list)):
            z_th1 = compute_z_th1(sp_inc[i], n_comb_xc, cfg.ds_comb_arm,
                                  cfg.thresh1_n_nines)
            peaks = peak_search(pow_c[i], frq_c[i], z_th1, f_search_set,
                                fc_list[i], fcp_list[i], None,
                                cfg.ds_comb_arm, refine_slab=slabs[i])
            _export_carrier(pow_c[i], frq_c[i], sp_inc[i], z_th1, peaks)
            all_peaks.extend(peaks)
            carrier_of.extend([i] * len(peaks))
    return _refine_from_peaks(all_peaks, carrier_of, cap_t, fc_list,
                              fcp_list, fs_programmed, cfg, timings)


def _export_carrier(pow_i, frq_i, sp_i, z_th1, peaks: List[Cell]) -> None:
    """One carrier's intermediates for offline diffing (the reference's
    ITPP_DEBUG_EXPORT convention, macros.h:55-72), in the TPU package's
    names and order; no-op unless a dump is active."""
    debug_export("xc_incoherent_collapsed_pow", pow_i)
    debug_export("xc_incoherent_collapsed_frq", frq_i)
    debug_export("sp_incoherent", sp_i)
    debug_export("Z_th1", z_th1)
    if peaks:
        debug_export("peak_ind", np.array([p.ind for p in peaks]))
        debug_export("peak_n_id_2", np.array([p.n_id_2 for p in peaks]))


def _refine_from_peaks(all_peaks: List[Cell], carrier_of: List[int],
                       cap_t: torch.Tensor, fc_list: Sequence[float],
                       fcp_list: Sequence[float], fs_programmed: float,
                       cfg: SearchConfig,
                       timings: Optional[Dict[str, float]] = None
                       ) -> List[List[Cell]]:
    """Back half over a band's peak list, each peak reading its carrier's
    row of the capture stack cap_t [C, n_cap].  batch_peaks: the SSS +
    fine-FOE stage of every carrier's peaks in one device pass, then the
    fused decode in one pass per CP type with the hex interpolator, or
    the staged decode peak by peak with the others.  Otherwise each
    carrier's peaks go through refine_peaks' peak-at-a-time order."""
    results: List[List[Cell]] = [[] for _ in range(cap_t.shape[0])]
    if not all_peaks:
        return results
    if not cfg.batch_peaks:
        for i in range(len(results)):
            peaks_i = [p for p, c in zip(all_peaks, carrier_of) if c == i]
            if peaks_i:
                results[i] = refine_peaks(peaks_i, cap_t[i], fc_list[i],
                                          fcp_list[i], fs_programmed, cfg,
                                          timings)
        return results
    dev = cap_t.device
    with stage("sss_foe_fused", dev, timings):
        cells = sss_foe_batch_fused(all_peaks, cap_t, carrier_of,
                                    cfg.thresh2_n_sigma, fs_programmed,
                                    compat=cfg.compat, skip_ids=cfg.skip_ids)
    kept = [(c, ci) for c, ci in zip(cells, carrier_of)
            if c.n_id_1 >= 0 and c.n_id_cell() not in cfg.skip_ids]
    if cfg.decode and kept and cfg.interp == "hex":
        with stage("decode_fused", dev, timings):
            decoded = decode_back_half_batch_multi(
                [c for c, _ in kept], cap_t, [ci for _, ci in kept],
                fs_programmed)
        kept = [(c, ci) for c, (_, ci) in zip(decoded, kept)
                if c.n_rb_dl >= 0]
    elif cfg.decode:
        kept = [(c2, ci) for c, ci in kept
                if (c2 := decode_back_half(
                    c, cap_t[ci], fc_list[ci], fcp_list[ci], fs_programmed,
                    cfg, timings)) is not None]
    for c, ci in kept:
        results[ci].append(c)
    return results
