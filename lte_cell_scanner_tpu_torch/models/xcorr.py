"""xcorr_pss: PSS correlation, incoherent combining, and peak collapse.

Behavioral contract: reference xcorr_pss and its subfunctions
(reference src/searcher.cpp:113-419).

- xc_correlate: the exact correlation (``ops/corr.py``) or the CUDA
  correlation-power kernels (``ops/corr_cuda.py``: int8 for captures on
  the 8-bit ADC grid, bf16 otherwise; the v1 and v3 A/B routes through
  ``xcorr_core`` with ``v1_operands``/``v3_operands``).
- xc_combine: the k_factor-scaled half-frame fold (searcher.cpp:263-308)
  as gathers at host-precomputed integer start indices.
- sp_est: the 274-sample running power as a cumulative-sum difference.
- xc_delay_spread / xc_peak_freq: rolls and reductions.

Array layout: lag axis last ([3, n_f, lag]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..constants import HALF_FRAME_LEN, PSS_TD_LEN
from ..device import resolve_device, tensor, to_capture
from ..ops import corr_cuda
from ..ops.corr import correlate
from .pss import PSS_TD


def round_i(x):
    """C/Matlab round: half away from zero (itpp::round_i)."""
    return np.where(np.asarray(x) >= 0, np.floor(np.asarray(x) + 0.5),
                    np.ceil(np.asarray(x) - 0.5)).astype(np.int64)


def pss_templates(f_search_set: np.ndarray, fc_requested: float,
                  fc_programmed: float, fs_programmed: float,
                  dtype=np.complex128) -> np.ndarray:
    """Frequency-shifted conjugated PSS matched filters, [3, n_f, 137].

    template[t, f, m] = conj(pss_td[t][m] * e^{j 2 pi f_off m / (fs k)}) / 137
    with k = (fc_requested - f_off) / fc_programmed  (searcher.cpp:145-151).
    Host-precomputed in float64, cast to the compute dtype.
    """
    pss = PSS_TD()
    m = np.arange(PSS_TD_LEN)
    f_off = np.asarray(f_search_set, dtype=np.float64)
    k_factor = (fc_requested - f_off) / fc_programmed
    phase = 2.0 * np.pi * f_off[:, None] * m[None, :] \
        / (fs_programmed * k_factor[:, None])
    shifted = pss[:, None, :] * np.exp(1j * phase)[None]
    return (np.conj(shifted) / PSS_TD_LEN).astype(dtype)


def combine_start_indices(f_search_set: np.ndarray, fc_requested: float,
                          fc_programmed: float, fs_programmed: float,
                          n_comb_xc: int) -> np.ndarray:
    """[n_f, n_comb] integer start offsets of each 5 ms period in the fold.

    actual_start_index = round_i(m * .005 * k_factor * fs_programmed)
    (searcher.cpp:296-298).
    """
    f_off = np.asarray(f_search_set, dtype=np.float64)
    k_factor = (fc_requested - f_off) / fc_programmed
    m = np.arange(n_comb_xc, dtype=np.float64)
    return round_i(m[None, :] * 0.005 * k_factor[:, None] * fs_programmed)


# (route, precision) -> the map's storage types that TPU route has: v2
# (corr_pow_core_v2 with post="xla"; the production route takes its bf16
# map, the int8 UNSCALED map, and the f32 map of f32 bands), v1 the
# banded A/B route (f32 map), v3 v2's in-kernel-transpose variant (bf16
# operands)
_ROUTES = {("v2", "bf16"): (torch.bfloat16, torch.float32),
           ("v2", "int8"): (torch.bfloat16,), ("v2", "f32"): (torch.float32,),
           ("v1", "bf16"): (torch.float32,), ("v1", "f32"): (torch.float32,),
           ("v3", "bf16"): (torch.float32, torch.bfloat16)}


@dataclass
class KernelOperands:
    """Quantized operands of one CUDA correlation route.  Every map of
    bf16 or int8 operands (bf16 or f32) runs on the tensor-core kernels,
    whose packed taps (``corr_cuda.pack_map_taps``) are made here once, so
    that each capture only builds its words; f32 operands keep their
    planes."""
    precision: str                  # "bf16", "int8" or "f32"
    taps: torch.Tensor              # [2, T, 137] template planes
    power_scale: Optional[float]    # int8 only: restores capture units
    out_dtype: torch.dtype = torch.bfloat16   # the power map's type
    route: str = "v2"               # the TPU route: "v1", "v2" or "v3"
    packed: Optional[torch.Tensor] = field(init=False, default=None,
                                           repr=False)

    def __post_init__(self):
        if self.out_dtype not in _ROUTES.get((self.route, self.precision),
                                             ()):
            raise ValueError(f"no {self.route} route with {self.precision} "
                             f"operands and a {self.out_dtype} map")
        if self.precision != "f32":
            self.packed = corr_cuda.pack_map_taps(self.taps)


def v1_operands(tmpl_flat, precision: str, device) -> KernelOperands:
    """Operands of the v1 A/B route (the TPU package's banded kernel with
    a float band pair): f32 or bf16 template planes, f32 map."""
    planes = {"f32": corr_cuda.template_planes_f32,
              "bf16": corr_cuda.template_planes_bf16}[precision]
    return KernelOperands(precision, planes(tmpl_flat, device), None,
                          torch.float32, "v1")


def v3_operands(tmpl_flat, device, out_dtype: torch.dtype = torch.float32
                ) -> KernelOperands:
    """Operands of the v3 route (bf16 bands, ``post="kernel"``): bf16
    template planes, a map of ``out_dtype``."""
    return KernelOperands("bf16",
                          corr_cuda.template_planes_bf16(tmpl_flat, device),
                          None, out_dtype, "v3")


def use_kernel_corr(corr_backend: str, device: torch.device) -> bool:
    """Resolve the correlation backend: "auto" is the CUDA kernel for
    CUDA tensors and the exact correlation elsewhere; "kernel" and
    "exact" force either."""
    if corr_backend == "kernel":
        return True
    if corr_backend == "auto":
        return device.type == "cuda"
    if corr_backend == "exact":
        return False
    raise ValueError(f"unknown corr_backend {corr_backend!r}")


def _corr_stage(capbuf: torch.Tensor, templates: Optional[torch.Tensor],
                keep_xc: bool, kern: Optional[KernelOperands]):
    """Correlation-power part of the front end -> (xc2 [3, n_f, n_lags],
    xc or None, power scale or None).  With kernel operands the map comes
    back in kern.out_dtype (the fold accumulates it in the working float
    type); the int8 map is UNSCALED and the scale is applied after the
    fold.  The kernels read kern.taps; templates [3, n_f, 137] serve the
    exact route only (None on the kernel route)."""
    n_lags = capbuf.shape[0] - (PSS_TD_LEN - 1)
    if kern is not None:
        n_f = kern.taps.shape[1] // 3
        if keep_xc:
            raise ValueError("the correlation kernels cannot return the "
                             "complex correlation (keep_xc=True)")
        if kern.precision == "int8":
            xc2 = corr_cuda.corr_pow_int8(
                corr_cuda.capture_planes_int8(capbuf), kern.taps, n_lags,
                kern.packed)
        elif kern.precision == "f32":
            xc2 = corr_cuda.corr_pow_f32(
                corr_cuda.capture_planes_f32(capbuf), kern.taps, n_lags)
        else:
            xc2 = corr_cuda.corr_pow_bf16(
                corr_cuda.capture_planes_bf16(capbuf), kern.taps, n_lags,
                kern.out_dtype, kern.packed)
        return xc2.reshape(3, n_f, n_lags), None, kern.power_scale
    n_f = templates.shape[1]
    xc = correlate(capbuf, templates.reshape(3 * n_f, PSS_TD_LEN))
    xc = xc.reshape(3, n_f, n_lags)
    return xc.real ** 2 + xc.imag ** 2, xc, None


def _fold_stage(xc2: torch.Tensor, start_idx: torch.Tensor,
                rdt: torch.dtype, pw_scale: Optional[float] = None
                ) -> torch.Tensor:
    """The k_factor half-frame fold of one carrier's materialized power
    map at its exact start indices -> xc_single [3, n_f, 9600] in rdt.
    pw_scale (int8 route) multiplies the FOLDED map, restoring
    capture-unit powers."""
    n_f, n_comb_xc = start_idx.shape
    base = torch.arange(HALF_FRAME_LEN, device=xc2.device)
    acc = torch.zeros((3, n_f, HALF_FRAME_LEN), dtype=rdt,
                      device=xc2.device)
    for m in range(n_comb_xc):
        idx = (start_idx[:, m, None] + base).expand(3, n_f, HALF_FRAME_LEN)
        acc = acc + torch.gather(xc2, 2, idx)
    xc_single = acc / n_comb_xc
    if pw_scale is not None:
        xc_single = xc_single * torch.tensor(np.float32(pw_scale), dtype=rdt,
                                             device=xc2.device)
    return xc_single


def _ds_collapse(xc_single: torch.Tensor, ds_comb_arm: int):
    """Delay-spread combining (cyclic +-arm moving average) and the
    hypothesis collapse (first max wins): xc_single [C, 3, n_f, 9600] ->
    (xc_inc, pow [C, 3, 9600], frq [C, 3, 9600])."""
    xc_inc = xc_single
    for t in range(1, ds_comb_arm + 1):
        xc_inc = xc_inc + torch.roll(xc_single, t, dims=-1) \
            + torch.roll(xc_single, -t, dims=-1)
    xc_inc = xc_inc / (2 * ds_comb_arm + 1)
    frq_collapsed = torch.argmax(xc_inc, dim=2)             # [C, 3, 9600]
    pow_collapsed = torch.gather(xc_inc, 2,
                                 frq_collapsed[:, :, None, :])[:, :, 0]
    return xc_inc, pow_collapsed, frq_collapsed


def _sp_est(capbuf: torch.Tensor, lean: bool):
    """sp_est: the 274-sample mean power, folded, shifted by 137, for
    capbuf [C, n_cap] -> (sp [C, n_sp] or None when lean, sp_inc [C,
    9600])."""
    rdt = capbuf.real.dtype
    dev = capbuf.device
    n_c = capbuf.shape[0]
    n_cap = capbuf.shape[1]
    n_comb_sp = (n_cap - 136 - 137) // HALF_FRAME_LEN
    n_sp = n_comb_sp * HALF_FRAME_LEN
    p = capbuf.real ** 2 + capbuf.imag ** 2
    zero = torch.zeros((n_c, 1), dtype=rdt, device=dev)
    if lean:
        # fold-then-window: mean_m window_274(p)[k + m*9600] equals
        # window_274(sum_m p[m*9600:...])[k] / n_comb
        q = torch.zeros((n_c, HALF_FRAME_LEN + 273), dtype=rdt, device=dev)
        for m in range(n_comb_sp):
            q = q + p[:, m * HALF_FRAME_LEN: m * HALF_FRAME_LEN
                      + HALF_FRAME_LEN + 273]
        cq = torch.cat([zero, torch.cumsum(q, 1)], dim=1)
        sp_incoherent = (cq[:, 274: 274 + HALF_FRAME_LEN]
                         - cq[:, :HALF_FRAME_LEN]) / (274.0 * n_comb_sp)
        sp = None
    else:
        cs = torch.cat([zero, torch.cumsum(p, 1)], dim=1)
        sp = (cs[:, 274: 274 + n_sp] - cs[:, :n_sp]) / 274.0
        sp_incoherent = torch.mean(
            sp.reshape(n_c, n_comb_sp, HALF_FRAME_LEN), dim=1)
    return sp, torch.roll(sp_incoherent, 137, dims=-1)


def _refine_slab(xc_single: torch.Tensor, frq_collapsed: torch.Tensor,
                 ds_comb_arm: int) -> torch.Tensor:
    """The lean refinement slab [C, 3, 2*arm+1, 9600]:
    slab[c, t, d, l] = xc_single[c, t, frq[c, t, l], (l - arm + d) % 9600]."""
    rows = [torch.gather(torch.roll(xc_single, ds_comb_arm - d, dims=-1),
                         2, frq_collapsed[:, :, None, :])[:, :, 0]
            for d in range(2 * ds_comb_arm + 1)]
    return torch.stack(rows, dim=2)


def _post_fold_stage(xc_single: torch.Tensor, capbuf: torch.Tensor,
                     ds_comb_arm: int, lean: bool):
    """Delay-spread combining, hypothesis collapse, sp_est, and the lean
    refinement slab for C carriers: xc_single [C, 3, n_f, 9600], capbuf
    [C, n_cap] (a single carrier passes C = 1).  Returns (xc_single,
    xc_inc, pow [C, 3, 9600], frq, sp [C, n_sp], sp_inc [C, 9600], slab
    [C, 3, 2*arm+1, 9600]) with None in the slots lean mode drops."""
    xc_inc, pow_collapsed, frq_collapsed = _ds_collapse(xc_single,
                                                        ds_comb_arm)
    sp, sp_incoherent = _sp_est(capbuf, lean)
    refine_slab = _refine_slab(xc_single, frq_collapsed, ds_comb_arm) \
        if lean else None
    return (None if lean else xc_single, None if lean else xc_inc,
            pow_collapsed, frq_collapsed, sp, sp_incoherent, refine_slab)


def xcorr_core(cap_t: torch.Tensor, templates: Optional[torch.Tensor],
               start_idx: torch.Tensor, ds_comb_arm: int,
               keep_xc: bool = True, lean: bool = False,
               kern: Optional[KernelOperands] = None):
    """Device portion of xcorr_pss, the counterpart of the TPU package's
    ``_xcorr_core``: correlation (the exact route, or the CUDA route of
    ``kern``: v2, v1 or v3 operands), fold, delay spread, collapse,
    sp_est and, when lean, the refinement slab, for one capture cap_t
    [n_cap] on the device.  templates [3, n_f, 137] serve the exact route
    (None on a kernel route); start_idx [n_f, n_comb].

    Returns (xc_single [3, n_f, 9600], xc_inc [3, n_f, 9600], pow [3,
    9600], frq [3, 9600], sp [n_sp], sp_inc [9600], xc [3, n_f, n_lags],
    slab [3, 2*arm+1, 9600]) as device tensors, with None where the TPU
    package's has it: xc unless keep_xc; xc_single, xc_inc and sp when
    lean; slab unless lean."""
    xc2, xc, pw_scale = _corr_stage(cap_t, templates, keep_xc, kern)
    xc_single = _fold_stage(xc2, start_idx, cap_t.real.dtype, pw_scale)
    outs = _post_fold_stage(xc_single[None], cap_t[None], ds_comb_arm, lean)
    (xc_single, xc_inc, pow_c, frq_c, sp, sp_inc, slab) = [
        None if o is None else o[0] for o in outs]
    return (xc_single, xc_inc, pow_c, frq_c, sp, sp_inc,
            xc if keep_xc else None, slab)


@dataclass
class XcorrResult:
    xc_incoherent_single: np.ndarray   # [3, n_f, 9600] (None when lean)
    xc_incoherent: np.ndarray          # [3, n_f, 9600]
    xc_incoherent_collapsed_pow: np.ndarray  # [3, 9600]
    xc_incoherent_collapsed_frq: np.ndarray  # [3, 9600] (index into f_search_set)
    sp: np.ndarray
    sp_incoherent: np.ndarray          # [9600]
    n_comb_xc: int
    n_comb_sp: int
    refine_slab: np.ndarray = None     # [3, 2*arm+1, 9600] (lean only)
    xc: np.ndarray = None              # [3, n_f, n_lags] (keep_xc only)


def _front_staging(capbuf, f_search_set, fc_requested: float,
                   fc_programmed: float, fs_programmed: float,
                   corr_backend: str, device: torch.device,
                   cap_t: Optional[torch.Tensor], want_kernel: bool):
    """Host staging of the single-carrier front end: the device capture,
    templates, fold-start table and, when the kernel route is taken, its
    quantized operands -- int8 for captures on the 8-bit ADC grid (checked
    on the host copy), bf16 otherwise.
    Returns (cap_t, templates, start_idx, kernel operands or None,
    n_comb_xc)."""
    if cap_t is None:
        cap_t = to_capture(capbuf, device)
    n_lags = cap_t.shape[0] - (PSS_TD_LEN - 1)
    n_comb_xc = (n_lags - 100) // HALF_FRAME_LEN
    tmpl_host = pss_templates(f_search_set, fc_requested, fc_programmed,
                              fs_programmed)
    templates = tensor(tmpl_host, device)
    start_idx = torch.from_numpy(combine_start_indices(
        f_search_set, fc_requested, fc_programmed, fs_programmed,
        n_comb_xc)).to(device)

    kern = None
    if want_kernel and use_kernel_corr(corr_backend, device):
        tmpl_flat = tmpl_host.reshape(-1, PSS_TD_LEN)
        if corr_cuda.is_adc_grid(capbuf):
            taps, scale = corr_cuda.template_planes_int8(tmpl_flat, device)
            kern = KernelOperands("int8", taps, float(scale))
        else:
            kern = KernelOperands(
                "bf16", corr_cuda.template_planes_bf16(tmpl_flat, device),
                None)
    return cap_t, templates, start_idx, kern, n_comb_xc


def xcorr_pss_peaks(capbuf, f_search_set, ds_comb_arm: int,
                    fc_requested: float, fc_programmed: float,
                    fs_programmed: float, thresh1_n_nines: int,
                    corr_backend: str = "auto", device=None,
                    cap_t: Optional[torch.Tensor] = None,
                    timings: Optional[Dict[str, float]] = None
                    ) -> Tuple[np.ndarray, int, int]:
    """Single-carrier front end with the peak search run on the device:
    returns (recs [cap, 4], n, n_comb_xc) -- feed to
    models.peaks.cells_from_peak_records.  Only the peak records leave
    the device.  Timed as two stages, xcorr_pss (the front end) and
    peak_search (the device peak search and the records' copy back), the
    names the host route of models/search.py::cell_search uses."""
    from ..utils.debug import stage
    from .peaks import peak_search_device
    from .search import compute_z_th1

    device = resolve_device(device)
    with stage("xcorr_pss", device, timings):
        cap_t, templates, start_idx, kern, n_comb_xc = _front_staging(
            capbuf, f_search_set, fc_requested, fc_programmed,
            fs_programmed, corr_backend, device, cap_t, want_kernel=True)
        xc2, _xc, pw_scale = _corr_stage(cap_t, templates, False, kern)
        xc_single = _fold_stage(xc2, start_idx, cap_t.real.dtype, pw_scale)
        (_s, _i, pow_c, frq_c, _sp, sp_inc, slab) = _post_fold_stage(
            xc_single[None], cap_t[None], ds_comb_arm, True)
    with stage("peak_search", device, timings):
        # the chi-squared threshold scale: compute_z_th1 with a unit
        # sp_incoherent (one definition of the detection constant)
        z_scale = float(compute_z_th1(np.float64(1.0), n_comb_xc,
                                      ds_comb_arm, thresh1_n_nines))
        recs, n = peak_search_device(pow_c, frq_c, slab, sp_inc * z_scale,
                                     ds_comb_arm)
        recs_h, n_h = recs[0].cpu().numpy(), int(n[0].item())
    return recs_h, n_h, n_comb_xc


def xcorr_pss(capbuf, f_search_set, ds_comb_arm: int, fc_requested: float,
              fc_programmed: float, fs_programmed: float,
              keep_xc: bool = False, lean: bool = False,
              corr_backend: str = "auto", device=None,
              cap_t: Optional[torch.Tensor] = None) -> XcorrResult:
    """Full xcorr_pss stage (reference searcher.cpp:389-419), results on
    the host.

    lean=True (the scan path) drops the xc_incoherent_single,
    xc_incoherent and sp outputs and returns the refinement slab instead.
    keep_xc=True also returns the complex correlation (exact route only).
    corr_backend: "auto", "kernel" or "exact" (see use_kernel_corr).
    cap_t: a device copy of capbuf already made by the caller."""
    device = resolve_device(device)
    cap_t, templates, start_idx, kern, n_comb_xc = _front_staging(
        capbuf, f_search_set, fc_requested, fc_programmed, fs_programmed,
        corr_backend, device, cap_t, want_kernel=not keep_xc)
    (xc_single, xc_inc, pow_c, frq_c, sp, sp_inc, xc, slab) = [
        None if o is None else o.cpu().numpy() for o in xcorr_core(
            cap_t, templates, start_idx, ds_comb_arm, keep_xc, lean, kern)]
    n_comb_sp = (cap_t.shape[0] - 136 - 137) // HALF_FRAME_LEN
    return XcorrResult(
        xc_incoherent_single=xc_single,
        xc_incoherent=xc_inc,
        xc_incoherent_collapsed_pow=pow_c,
        xc_incoherent_collapsed_frq=frq_c,
        sp=sp,
        sp_incoherent=sp_inc,
        n_comb_xc=n_comb_xc,
        n_comb_sp=n_comb_sp,
        refine_slab=slab,
        xc=xc,
    )
