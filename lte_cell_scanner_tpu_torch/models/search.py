"""Top-level cell search: the per-carrier pipeline and deduplication.

Behavioral contract: the CellSearch main loop
(reference src/CellSearch.cpp:437-618): xcorr_pss -> chi-squared
threshold -> peak_search -> per peak {sss_detect -> pss_sss_foe ->
extract_tfg -> tfoec -> decode_mib} -> dedup.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cell import Cell
from ..constants import (DS_COMB_ARM, FS_LTE, THRESH1_N_NINES,
                         THRESH2_N_SIGMA)
from ..device import resolve_device, to_capture
from ..ops.dsp import chi2cdf_inv, matlab_range
from ..utils.debug import debug_export, get_dump, stage
from .decode import (decode_back_half_batch, decode_back_half_fused,
                     decode_mib)
from .peaks import PEAK_CAP, cells_from_peak_records, peak_search
from .rs import RsDl
from .sss_detect import pss_sss_foe, sss_detect, sss_foe_batch_fused
from .tfg import extract_tfg, tfoec
from .xcorr import use_kernel_corr, xcorr_pss, xcorr_pss_peaks

log = logging.getLogger(__name__)


def compute_z_th1(sp_incoherent: np.ndarray, n_comb_xc: int,
                  ds_comb_arm: int = DS_COMB_ARM,
                  thresh1_n_nines: int = THRESH1_N_NINES) -> np.ndarray:
    """Per-lag PSS detection threshold from the chi-squared false-alarm
    design point (reference CellSearch.cpp:500-503)."""
    R_th1 = chi2cdf_inv(1 - 10.0 ** (-thresh1_n_nines),
                        2 * n_comb_xc * (2 * ds_comb_arm + 1))
    rx_cutoff = (6 * 12 * 15e3 / 2 + 4 * 15e3) / (FS_LTE / 16 / 2)
    return (R_th1 * sp_incoherent / rx_cutoff / 137 / 2 / n_comb_xc
            / (2 * ds_comb_arm + 1))


def default_f_search_set(freq_start: float, ppm: float = 120.0) -> np.ndarray:
    """5 kHz frequency-offset raster covering +-ppm crystal error
    (reference CellSearch.cpp:463-464)."""
    n_extra = int(np.floor((freq_start * ppm / 1e6 + 2.5e3) / 5e3))
    return matlab_range(-n_extra * 5000.0, 5000.0, n_extra * 5000.0)


@dataclass
class SearchConfig:
    ds_comb_arm: int = DS_COMB_ARM
    thresh1_n_nines: int = THRESH1_N_NINES
    thresh2_n_sigma: float = THRESH2_N_SIGMA
    compat: str = "production"   # or "golden" (see models/sss_detect.py)
    interp: str = "hex"          # or "2stage", "freq_time" (chan_est.py)
    decode: bool = True          # run the tfg/tfoec/MIB back half
    # cell IDs to drop right after SSS detection, before the fine FOE
    # and decode -- the reference searcher thread's already-tracked
    # check sits exactly there (searcher_thread.cpp:157-177)
    skip_ids: frozenset = frozenset()
    # SSS/FOE and decode of all peaks in batched passes (False = the
    # reference's peak-at-a-time order; same math)
    batch_peaks: bool = True
    # correlation backend: "auto" = the CUDA kernels for CUDA tensors
    # (int8 on ADC-grid captures, bf16 otherwise) and the exact
    # correlation elsewhere; "kernel"/"exact" force either
    corr_backend: str = "auto"

    def __post_init__(self):
        if self.compat not in ("production", "golden"):
            raise ValueError(f"unknown compat {self.compat!r}")
        if self.interp not in ("hex", "2stage", "freq_time"):
            raise ValueError(f"unknown interpolator {self.interp!r}")


def refine_peaks(peaks: List[Cell], cap_t: torch.Tensor,
                 fc_requested: float, fc_programmed: float,
                 fs_programmed: float, cfg: SearchConfig,
                 timings: Optional[Dict[str, float]] = None) -> List[Cell]:
    """Back half of the pipeline for the peaks of one capture cap_t
    [n_cap] on the device (reference CellSearch.cpp:514-570).

    batch_peaks: SSS detection + fine FOE of all peaks in one device pass
    (the host re-decides in float64), then with the hex interpolator
    tfg / tfoec / CE / blind MIB in one pass per CP type; the other
    interpolators decode peak by peak through the staged
    extract_tfg -> tfoec -> decode_mib.  Otherwise every stage runs peak
    by peak, in the reference's order."""
    dev = cap_t.device
    if cfg.batch_peaks:
        with stage("sss_foe_fused", dev, timings):
            cells = sss_foe_batch_fused(peaks, cap_t[None], [0] * len(peaks),
                                        cfg.thresh2_n_sigma, fs_programmed,
                                        compat=cfg.compat,
                                        skip_ids=cfg.skip_ids)
        cells = [c for c in cells
                 if c.n_id_1 >= 0 and c.n_id_cell() not in cfg.skip_ids]
        if not cfg.decode or not cells:
            return cells
        if cfg.interp == "hex":
            with stage("decode_fused", dev, timings):
                decoded = decode_back_half_batch(cells, cap_t, fc_requested,
                                                 fc_programmed, fs_programmed)
            return [c for c in decoded if c.n_rb_dl >= 0]
        return [c2 for c in cells
                if (c2 := decode_back_half(c, cap_t, fc_requested,
                                           fc_programmed, fs_programmed, cfg,
                                           timings)) is not None]

    detected: List[Cell] = []
    for cell in peaks:
        with stage("sss_detect", dev, timings):
            cell = sss_detect(cell, cap_t, cfg.thresh2_n_sigma, fc_requested,
                              fc_programmed, fs_programmed,
                              compat=cfg.compat)
        if cell.n_id_1 < 0 or cell.n_id_cell() in cfg.skip_ids:
            continue
        with stage("pss_sss_foe", dev, timings):
            cell = pss_sss_foe(cell, cap_t, fc_requested, fc_programmed,
                               fs_programmed, compat=cfg.compat)
        if not cfg.decode:
            detected.append(cell)
            continue
        cell = decode_back_half(cell, cap_t, fc_requested, fc_programmed,
                                fs_programmed, cfg, timings)
        if cell is not None:
            detected.append(cell)
    return detected


def decode_back_half(cell: Cell, cap_t: torch.Tensor, fc_requested: float,
                     fc_programmed: float, fs_programmed: float,
                     cfg: SearchConfig,
                     timings: Optional[Dict[str, float]] = None
                     ) -> Optional[Cell]:
    """OFDM demod -> superfine FOE/TOE -> channel est -> blind MIB decode
    of one SSS-accepted peak; None when the MIB never decodes (reference
    CellSearch.cpp:542-570).  The hex interpolator runs the fused decode
    on a batch of one; the others the staged flow."""
    dev = cap_t.device
    if cfg.interp == "hex":
        with stage("decode_fused", dev, timings):
            cell = decode_back_half_fused(cell, cap_t, fc_requested,
                                          fc_programmed, fs_programmed)
        return cell if cell.n_rb_dl >= 0 else None
    with stage("extract_tfg", dev, timings):
        tfg, tfg_timestamp = extract_tfg(cell, cap_t, fc_requested,
                                         fc_programmed, fs_programmed)
    rs_dl = RsDl(cell.n_id_cell(), 6, cell.cp_type)
    with stage("tfoec", dev, timings):
        cell, tfg_comp, _ = tfoec(cell, tfg, tfg_timestamp, fc_requested,
                                  fc_programmed, rs_dl)
    with stage("decode_mib", dev, timings):
        cell = decode_mib(cell, tfg_comp, rs_dl, interp=cfg.interp)
    return cell if cell.n_rb_dl >= 0 else None


def cell_search(capbuf, f_search_set, fc_requested: float,
                fc_programmed: float, fs_programmed: float,
                config: Optional[SearchConfig] = None, device=None,
                timings: Optional[Dict[str, float]] = None,
                mesh=None) -> List[Cell]:
    """Search one carrier: detect, refine, and (optionally) decode cells.

    mesh: a (t x f) grid of devices (``parallel/sharded.py::make_mesh``;
    then no ``device``): the front end runs over the grid
    (``cell_search_sharded``).
    device: where the search runs (None = the card).  On CUDA the
    threshold and greedy peak search run on the device after the front
    end and only the peak records come back; on the CPU, and whenever a
    debug dump is active (utils/debug.py), the front end's maps come back,
    the host peak search runs and the maps are exported to the dump.
    timings: if a dict is given, each stage's wall seconds are added to
    it under its profile name (xcorr_pss, the front end; peak_search, on
    the device or the host; sss_foe_fused, decode_fused; the other stages
    of refine_peaks where the config takes them); ``--profile``
    (utils/debug.py::enable_profiling) records the same stages."""
    if mesh is not None:
        if device is not None:
            raise ValueError("cell_search: give a device or a mesh, not "
                             "both")
        return cell_search_sharded(capbuf, f_search_set, fc_requested,
                                   fc_programmed, fs_programmed, mesh,
                                   config, timings)
    cfg = config or SearchConfig()
    dev = resolve_device(device)
    capbuf = np.asarray(capbuf)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    # one device copy of the capture serves the whole chain
    cap_t = to_capture(capbuf, dev)

    if dev.type == "cuda" and get_dump() is None:
        recs, n, _nc = xcorr_pss_peaks(
            capbuf, f_search_set, cfg.ds_comb_arm, fc_requested,
            fc_programmed, fs_programmed, cfg.thresh1_n_nines,
            corr_backend=cfg.corr_backend, device=dev, cap_t=cap_t,
            timings=timings)
        if n < PEAK_CAP:
            peaks = cells_from_peak_records(recs, n, f_search_set,
                                            fc_requested, fc_programmed)
            return refine_peaks(peaks, cap_t, fc_requested, fc_programmed,
                                fs_programmed, cfg, timings)
        # saturated record buffer (>= PEAK_CAP extractions): the host
        # peak search is unbounded -- fall through to it rather than
        # truncating a dense capture's peak list
        log.warning("cell search: %d peak records filled; host peak "
                    "search", PEAK_CAP)

    with stage("xcorr_pss", dev, timings):
        res = xcorr_pss(capbuf, f_search_set, cfg.ds_comb_arm,
                        fc_requested, fc_programmed, fs_programmed,
                        lean=True, corr_backend=cfg.corr_backend,
                        device=dev, cap_t=cap_t)
    return _host_peaks_then_refine(
        res.xc_incoherent_collapsed_pow, res.xc_incoherent_collapsed_frq,
        res.sp_incoherent, res.xc_incoherent_single, res.n_comb_xc,
        f_search_set, fc_requested, fc_programmed, fs_programmed, cap_t,
        cfg, dev, timings, refine_slab=res.refine_slab)


def _host_peaks_then_refine(pow_map, frq_map, sp_incoherent, single,
                            n_comb_xc, f_search_set, fc_requested,
                            fc_programmed, fs_programmed, cap_t, cfg, dev,
                            timings, refine_slab=None) -> List[Cell]:
    """The rest of a search after a front end whose maps are on the
    host: Z_th1, the host peak search, the debug exports, then the back
    half (refine_peaks) on ``cap_t``'s device."""
    Z_th1 = compute_z_th1(sp_incoherent, n_comb_xc, cfg.ds_comb_arm,
                          cfg.thresh1_n_nines)
    with stage("peak_search", dev, timings):
        peaks = peak_search(pow_map, frq_map, Z_th1, f_search_set,
                            fc_requested, fc_programmed, single,
                            cfg.ds_comb_arm, refine_slab=refine_slab)
    # intermediate-array tracing for offline diffing (the reference's
    # ITPP_DEBUG_EXPORT convention, macros.h:55-72); no-op unless a dump
    # is active
    debug_export("xc_incoherent_collapsed_pow", pow_map)
    debug_export("xc_incoherent_collapsed_frq", frq_map)
    debug_export("sp_incoherent", sp_incoherent)
    debug_export("Z_th1", Z_th1)
    if peaks:
        debug_export("peak_ind", np.array([p.ind for p in peaks]))
        debug_export("peak_n_id_2", np.array([p.n_id_2 for p in peaks]))
    return refine_peaks(peaks, cap_t, fc_requested, fc_programmed,
                        fs_programmed, cfg, timings)


def cell_search_sharded(capbuf, f_search_set, fc_requested: float,
                        fc_programmed: float, fs_programmed: float,
                        mesh, config: Optional[SearchConfig] = None,
                        timings: Optional[Dict[str, float]] = None
                        ) -> List[Cell]:
    """cell_search with the front end over a (t x f) grid of devices
    (``parallel/sharded.py``): time blocks with overlap-save halos,
    template columns collapsed on the grid's first device, and the
    sp_incoherent and pre-delay-spread fold that Z_th1 and the
    refinement need from the same pass.  The host peak search, the debug
    exports and the back half (on the grid's first device) follow as in
    cell_search (``_host_peaks_then_refine``).  The correlation backend is chosen for the first device:
    the bf16 map kernel per device on CUDA (for ADC-grid captures too, as
    the TPU package's sharded front end takes bf16 bands), the exact
    correlation on the CPU.

    The tracker's searcher takes this path with a search grid, and so
    does a single-carrier search over several cards."""
    from ..parallel.sharded import (plan_sharded_bands, plan_sharded_inputs,
                                    sharded_xcorr)

    cfg = config or SearchConfig()
    capbuf = np.asarray(capbuf)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    dev = mesh.first
    n_comb_sp = (len(capbuf) - 136 - 137) // 9600
    with stage("xcorr_pss", dev, timings):
        padded, tmpl, starts, n_comb_xc, n_lags = plan_sharded_inputs(
            capbuf, f_search_set, fc_requested, fc_programmed,
            fs_programmed, mesh, dtype=np.complex128)
        bands = plan_sharded_bands(tmpl, mesh) \
            if use_kernel_corr(cfg.corr_backend, dev) else ()
        outs = sharded_xcorr(mesh, padded, tmpl, starts, cfg.ds_comb_arm,
                             n_comb_xc, n_lags, n_comb_sp, bands)
        pow_g, frq_g, sp_inc, single = (x.cpu().numpy() for x in outs)
    return _host_peaks_then_refine(
        pow_g, frq_g, sp_inc, single, n_comb_xc, f_search_set, fc_requested,
        fc_programmed, fs_programmed, to_capture(capbuf, dev), cfg, dev,
        timings)


def _true_freq(c: Cell) -> float:
    """Best available carrier-frequency estimate: superfine when the
    decode back half ran, else fine, else the coarse hypothesis."""
    for v in (c.freq_superfine, c.freq_fine, c.freq):
        if np.isfinite(v):
            return c.fc_requested + v
    return c.fc_requested


def dedup(cell_lists: List[List[Cell]]) -> List[Cell]:
    """Merge per-carrier results: same cell ID within 1 MHz keeps the
    strongest detection (reference CellSearch.cpp:285-319)."""
    final: List[Cell] = []
    for cells in cell_lists:
        for c in cells:
            matched = False
            for i, f in enumerate(final):
                if (c.n_id_cell() == f.n_id_cell()
                        and abs(_true_freq(c) - _true_freq(f)) < 1e6):
                    matched = True
                    if c.pss_pow > f.pss_pow:
                        final[i] = c
                    break
            if not matched:
                final.append(c)
    return final
