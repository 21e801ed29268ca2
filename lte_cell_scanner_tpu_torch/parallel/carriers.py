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

Over several devices (``make_carrier_mesh``, the TPU package's 1-D "c"
mesh): each chunk holds ``max_carriers_per_program`` carriers per
device, padded to a multiple of the device count by repeating its last
capture; each device takes a contiguous block of the chunk and runs the
front end, the peak search and the back half on it, with the route and
the middle carrier's operands planned once for the whole chunk.  A list
may repeat a device, so the layout runs on one card as well.  Across
processes, ``parallel/multihost.py`` runs the same chunk on each rank.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cell import Cell
from ..constants import HALF_FRAME_LEN, PSS_TD_LEN
from ..device import (pick_devices, resolve_device, tensor, to_capture,
                      visible_devices)
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


def make_carrier_mesh(n_devices: Optional[int] = None, devices=None
                      ) -> List[torch.device]:
    """The carrier axis's layout: a list of devices (None = every visible
    card), of which the first ``n_devices`` are taken (None = all).  A
    list may repeat a device.  Raises when fewer are given or visible."""
    devs = visible_devices() if devices is None \
        else [torch.device(d) for d in devices]
    return pick_devices(len(devs) if n_devices is None else n_devices, devs,
                        "carrier mesh")


def plan_carrier_inputs(capbufs: Sequence[np.ndarray],
                        fc_list: Sequence[float],
                        f_search_set: np.ndarray,
                        fc_programmed_list: Sequence[float],
                        fs_programmed: float, n_devices: int = 1):
    """Stack per-carrier captures with their template and fold plans,
    padded so the carrier count divides ``n_devices`` by repeating the
    last capture.

    Templates and fold start indices differ per carrier because k_factor
    depends on fc (searcher.cpp:145-151, 296-298).  Returns (capbufs
    [C, n_cap], templates [C, 3, n_f, 137] complex128, start_idx
    [C, n_f, n_comb] int64, n_comb_xc, c_real), C the padded count and
    c_real the carriers given; the device converts to its own working
    types."""
    c_real = len(capbufs)
    n_cap = len(capbufs[0])
    if any(len(c) != n_cap for c in capbufs):
        raise ValueError("all captures must have equal length")
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_comb_xc = (n_lags - 100) // HALF_FRAME_LEN
    rows = [min(i, c_real - 1) for i in range(c_real - c_real % -n_devices)]
    cap = np.stack([np.asarray(capbufs[j]) for j in rows])
    tmpl = np.stack([pss_templates(f_search_set, fc, fcp, fs_programmed)
                     for fc, fcp in zip(fc_list, fc_programmed_list)])
    starts = np.stack([combine_start_indices(f_search_set, fc, fcp,
                                             fs_programmed, n_comb_xc)
                       for fc, fcp in zip(fc_list, fc_programmed_list)])
    return cap, tmpl[rows], starts[rows], n_comb_xc, c_real


def v4_band_kv(starts, margin: int = 0) -> int:
    """The v4 gate for a whole chunk: the TPU kernel's row-window width
    (256, or 384 for long captures) when the middle carrier's fold-start
    table fits a v4 window shrunk by ``margin`` AND every carrier's exact
    starts lie within 1 sample of it; 0 for the v2 route.  Edge carriers
    drift from the middle table by ~9600*m*df/fc samples per period, so a
    chunk spanning tens of MHz would push late periods past the
    +-ds_comb_arm = 2 combining arm.  The multi-process band gates at
    margin 1 (parallel/multihost.py)."""
    starts = np.asarray(starts)
    smid = starts[starts.shape[0] // 2]
    kv = v4_kv_for(smid, margin=margin)
    if kv is None:
        return 0
    dev = np.max(np.abs(starts.astype(np.int64)
                        - smid[None].astype(np.int64)))
    return kv if int(dev) <= 1 else 0


def v4_band_applicable(starts, margin: int = 0) -> bool:
    """Whether the chunk of fold-start tables ``starts`` takes the fused
    v4 kernels (v4_band_kv's gate)."""
    return v4_band_kv(starts, margin) != 0


@dataclass
class BandRoute:
    """How a chunk's front end runs.  kern None: the exact correlation.
    With kern and mid_starts (the middle carrier's int32 fold-start
    table on the device): the fused v4 kernels.  With kern alone: the v2
    kernels and each carrier's exact fold."""
    kern: Optional[KernelOperands]
    mid_starts: Optional[torch.Tensor] = None

    def to(self, device: torch.device) -> "BandRoute":
        """The same route with its operands on ``device``."""
        if self.kern is None or self.kern.taps.device == device:
            return self
        return BandRoute(
            dataclasses.replace(self.kern, taps=self.kern.taps.to(device)),
            None if self.mid_starts is None else self.mid_starts.to(device))


def _plan_scan_bands(tmpl: np.ndarray, starts: np.ndarray,
                     capbufs: Sequence[np.ndarray], cfg: SearchConfig,
                     device: torch.device, force_int8: Optional[bool] = None,
                     force_v4: Optional[int] = None) -> BandRoute:
    """The chunk's route and its shared operands: one set of template
    planes (the middle carrier's: adjacent carriers' templates differ
    only through k_factor, ~4e-5 relative phase across 10 MHz, two orders
    below the bf16 quantization) serves every carrier; int8 when every
    capture is on the ADC grid (checked on the host copies).

    force_int8 / force_v4 impose the route instead of deriving it from
    the chunk (the multi-process band passes the verdict gathered from
    every rank): force_v4 0 is the v2 route, a kv width the fused v4
    route."""
    if not use_kernel_corr(cfg.corr_backend, device):
        return BandRoute(None)
    mid = tmpl.shape[0] // 2
    tmid = tmpl[mid].reshape(-1, PSS_TD_LEN)
    use_int8 = all(corr_cuda.is_adc_grid(c) for c in capbufs) \
        if force_int8 is None else bool(force_int8)
    if use_int8:
        taps, scale = corr_cuda.template_planes_int8(tmid, device)
        kern = KernelOperands("int8", taps, float(scale))
    else:
        kern = KernelOperands(
            "bf16", corr_cuda.template_planes_bf16(tmid, device), None)
    if v4_band_kv(starts) if force_v4 is None else force_v4:
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
              device=None, timings: Optional[Dict[str, float]] = None,
              mesh: Optional[Sequence[torch.device]] = None
              ) -> List[List[Cell]]:
    """Scan many carriers at once on one device (None = the card), or
    over the devices of ``mesh`` (``make_carrier_mesh``; then no
    ``device``).

    captures: sequence of (capbuf, fc_requested, fc_programmed).
    Returns one decoded-cell list per carrier, in carrier order (feed to
    models.search.dedup).  The peak search follows the device, as in
    cell_search: on CUDA the threshold and greedy peak search run on the
    device and only the peak records come back (a block where a carrier
    fills its PEAK_CAP records takes the unbounded host search); on the
    CPU the collapsed maps come back and the host search runs.

    The band runs in chunks of ``max_carriers_per_program`` carriers per
    device: the bound is set by the v2 route's ~28 MB-per-carrier power
    map (the fused v4 route never materializes it); chunking keeps memory
    bounded and each chunk shares its middle carrier's templates.  Over a
    mesh each device takes a contiguous block of every chunk.

    timings: if a dict is given, each stage's wall seconds, summed over
    the chunks, are added to it under cell_search's names (staging, then
    xcorr_pss, the front end; peak_search, on the device or the host;
    sss_foe_fused, decode_fused; the stages of models/search.py's
    refine_peaks and decode_back_half where the config takes them)."""
    cfg = config or SearchConfig()
    if mesh is not None and device is not None:
        raise ValueError("scan_band: give a device or a mesh, not both")
    devices = [resolve_device(device)] if mesh is None \
        else make_carrier_mesh(devices=mesh)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    limit = max(1, max_carriers_per_program) * len(devices)
    out: List[List[Cell]] = []
    for i in range(0, len(captures), limit):
        with stage("staging", devices[0], timings):
            chunk = _stage_chunk(captures[i: i + limit], f_search_set,
                                 fs_programmed, len(devices))
            route = _plan_scan_bands(chunk.tmpl, chunk.starts,
                                     chunk.capbufs, cfg, devices[0])
        out.extend(_scan_staged(chunk, route, f_search_set, fs_programmed,
                                cfg, devices, timings))
    return out


@dataclass
class _Chunk:
    """One chunk of a band, staged on the host: the captures as given
    and the padded plans of ``plan_carrier_inputs``."""
    capbufs: List[np.ndarray]
    fc_list: List[float]
    fcp_list: List[float]
    cap: np.ndarray
    tmpl: np.ndarray
    starts: np.ndarray
    n_comb_xc: int
    c_real: int


def _stage_chunk(captures, f_search_set: np.ndarray, fs_programmed: float,
                 n_devices: int) -> _Chunk:
    capbufs = [np.asarray(c[0]) for c in captures]
    fc_list = [float(c[1]) for c in captures]
    fcp_list = [float(c[2]) for c in captures]
    return _Chunk(capbufs, fc_list, fcp_list, *plan_carrier_inputs(
        capbufs, fc_list, f_search_set, fcp_list, fs_programmed, n_devices))


def _scan_staged(chunk: _Chunk, route: BandRoute, f_search_set: np.ndarray,
                 fs_programmed: float, cfg: SearchConfig,
                 devices: Sequence[torch.device],
                 timings: Optional[Dict[str, float]],
                 n_real: Optional[int] = None) -> List[List[Cell]]:
    """A staged chunk over ``devices``: device b takes the b-th
    contiguous block of the padded stack; every block's front end is
    issued before any block's results come back, then each block's peak
    search and back half run on its device.  Returns the cell lists of
    the first ``n_real`` carriers (default: the chunk's own), in carrier
    order."""
    n_real = chunk.c_real if n_real is None else n_real
    per = chunk.cap.shape[0] // len(devices)
    out: List[List[Cell]] = []
    for lo, cap_t, front in _front_blocks(chunk, route, cfg.ds_comb_arm,
                                          devices, timings):
        n_b = min(max(n_real - lo, 0), per)
        if n_b == 0:
            continue
        slabs, pow_c, frq_c, sp_inc = (x[:n_b] for x in front)
        out.extend(_back_block(
            slabs, pow_c, frq_c, sp_inc, cap_t[:n_b],
            chunk.fc_list[lo: lo + n_b], chunk.fcp_list[lo: lo + n_b],
            f_search_set, fs_programmed, chunk.n_comb_xc, cfg, timings))
    return out


def _front_blocks(chunk: _Chunk, route: BandRoute, ds_comb_arm: int,
                  devices: Sequence[torch.device],
                  timings: Optional[Dict[str, float]] = None):
    """The front end of each device's block of the padded stack, all
    issued before any result is read: [(first carrier, cap_t [per,
    n_cap], (slab, pow_c, frq_c, sp_inc))] on the block's device."""
    per = chunk.cap.shape[0] // len(devices)
    blocks = []
    with stage("staging", devices[0], timings):
        routes = {}
        for b, dev in enumerate(devices):
            rows = slice(b * per, (b + 1) * per)
            if dev not in routes:
                routes[dev] = route.to(dev)
            blocks.append((b * per, dev, rows,
                           to_capture(chunk.cap[rows], dev)))
    with stage("xcorr_pss", devices[0], timings):
        return [(lo, cap_t, _front_batch(cap_t, chunk.tmpl[rows],
                                         chunk.starts[rows], routes[dev],
                                         ds_comb_arm))
                for lo, dev, rows, cap_t in blocks]


def _back_block(slabs: torch.Tensor, pow_c: torch.Tensor,
                frq_c: torch.Tensor, sp_inc: torch.Tensor,
                cap_t: torch.Tensor, fc_list: List[float],
                fcp_list: List[float], f_search_set: np.ndarray,
                fs_programmed: float, n_comb_xc: int, cfg: SearchConfig,
                timings: Optional[Dict[str, float]]) -> List[List[Cell]]:
    """Peak search and back half of one device's block of carriers."""
    dev = cap_t.device
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
            n_c = len(fc_list)
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
                    "host peak search for this block of %d carriers",
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
