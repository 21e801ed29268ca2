"""Top-level cell search: the per-carrier pipeline and deduplication.

Behavioral contract: the CellSearch main loop
(reference src/CellSearch.cpp:437-618): xcorr_pss -> chi-squared
threshold -> peak_search -> per peak {sss_detect -> pss_sss_foe ->
extract_tfg -> tfoec -> decode_mib} -> dedup.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cell import Cell
from ..constants import (DS_COMB_ARM, FS_LTE, THRESH1_N_NINES,
                         THRESH2_N_SIGMA)
from ..device import resolve_device, to_capture
from ..ops.dsp import chi2cdf_inv, matlab_range
from .decode import decode_back_half_batch
from .peaks import PEAK_CAP, cells_from_peak_records, peak_search
from .sss_detect import sss_foe_batch_fused
from .xcorr import xcorr_pss, xcorr_pss_peaks

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
    decode: bool = True          # run the tfg/tfoec/MIB back half
    # correlation backend: "auto" = the CUDA kernels for CUDA tensors
    # (int8 on ADC-grid captures, bf16 otherwise) and the exact
    # correlation elsewhere; "kernel"/"exact" force either
    corr_backend: str = "auto"


@contextmanager
def _stage(timings: Optional[Dict[str, float]], name: str,
           device: torch.device):
    """Add the stage's wall seconds to timings[name] (device work
    included: the card is synchronised at both ends); no-op when
    timings is None."""
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def refine_peaks(peaks: List[Cell], cap_t: torch.Tensor,
                 fc_requested: float, fc_programmed: float,
                 fs_programmed: float, cfg: SearchConfig,
                 timings: Optional[Dict[str, float]] = None) -> List[Cell]:
    """Back half of the pipeline for all peaks at once: SSS detection +
    fine FOE in one device pass (the host re-decides in float64), then
    tfg / tfoec / hex channel estimation / blind MIB in one pass per CP
    type (reference CellSearch.cpp:514-570)."""
    dev = cap_t.device
    with _stage(timings, "sss_foe", dev):
        cells = sss_foe_batch_fused(peaks, cap_t[None], [0] * len(peaks),
                                    cfg.thresh2_n_sigma, fs_programmed)
    cells = [c for c in cells if c.n_id_1 >= 0]
    if not cfg.decode or not cells:
        return cells
    with _stage(timings, "decode", dev):
        decoded = decode_back_half_batch(cells, cap_t, fc_requested,
                                         fc_programmed, fs_programmed)
    return [c for c in decoded if c.n_rb_dl >= 0]


def cell_search(capbuf, f_search_set, fc_requested: float,
                fc_programmed: float, fs_programmed: float,
                config: Optional[SearchConfig] = None, device=None,
                timings: Optional[Dict[str, float]] = None) -> List[Cell]:
    """Search one carrier: detect, refine, and (optionally) decode cells.

    device: where the search runs (None = the card).  On CUDA the
    threshold and greedy peak search run on the device after the front
    end and only the peak records come back; on the CPU the front end's
    maps come back and the host peak search runs.  timings: if a dict is
    given, each stage's wall seconds are added to it (front_end,
    peak_search, sss_foe, decode)."""
    cfg = config or SearchConfig()
    dev = resolve_device(device)
    capbuf = np.asarray(capbuf)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    # one device copy of the capture serves the whole chain
    cap_t = to_capture(capbuf, dev)

    if dev.type == "cuda":
        with _stage(timings, "front_end", dev):
            recs, n, _nc = xcorr_pss_peaks(
                capbuf, f_search_set, cfg.ds_comb_arm, fc_requested,
                fc_programmed, fs_programmed, cfg.thresh1_n_nines,
                corr_backend=cfg.corr_backend, device=dev, cap_t=cap_t)
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

    with _stage(timings, "front_end", dev):
        res = xcorr_pss(capbuf, f_search_set, cfg.ds_comb_arm,
                        fc_requested, fc_programmed, fs_programmed,
                        lean=True, corr_backend=cfg.corr_backend,
                        device=dev, cap_t=cap_t)
    with _stage(timings, "peak_search", dev):
        Z_th1 = compute_z_th1(res.sp_incoherent, res.n_comb_xc,
                              cfg.ds_comb_arm, cfg.thresh1_n_nines)
        peaks = peak_search(res.xc_incoherent_collapsed_pow,
                            res.xc_incoherent_collapsed_frq,
                            Z_th1, f_search_set, fc_requested,
                            fc_programmed, res.xc_incoherent_single,
                            cfg.ds_comb_arm, refine_slab=res.refine_slab)
    return refine_peaks(peaks, cap_t, fc_requested, fc_programmed,
                        fs_programmed, cfg, timings)


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
