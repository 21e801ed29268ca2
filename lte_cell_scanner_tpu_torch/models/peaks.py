"""Greedy PSS peak extraction with interference cancellation.

Behavioral contract: the MATLAB reference semantics
(reference Matlab/peak_search.m:28-75):

- repeatedly take the global max over [3 x 9600] collapsed powers until it
  falls below the chi-squared threshold Z_th1 at that lag;
- refine the reported lag to the strongest single lag within +-ds_comb_arm
  of the (delay-spread-combined) peak (C++ refinement,
  src/searcher.cpp:457-465);
- cancel: (a) the same PSS within +-274 lags, (b) *other* PSS rows within
  +-274 lags when 8 dB below the peak (MATLAB peak_search.m:64-67),
  (c) everything 12 dB below the peak anywhere (CRS self-correlation
  ghosts).

``peak_search`` is the host loop; ``peak_search_device`` runs the same
greedy loop on the device tensors with no host synchronisation inside.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..cell import Cell

_SAME_PSS_CANCEL = 274  # 2 x 137 samples
PEAK_CAP = 40


def peak_search(xc_incoherent_collapsed_pow: np.ndarray,
                xc_incoherent_collapsed_frq: np.ndarray,
                Z_th1: np.ndarray,
                f_search_set: np.ndarray,
                fc_requested: float,
                fc_programmed: float,
                xc_incoherent_single: np.ndarray,
                ds_comb_arm: int,
                refine_slab: np.ndarray = None) -> List[Cell]:
    """Extract PSS candidate cells on the host.

    xc_incoherent_single has layout [3, n_f, 9600].  refine_slab
    [3, 2*arm+1, 9600] (xcorr lean mode) may stand in for it: slab[t, d, l]
    pre-gathers xc_single[t, frq[t, l], (l - arm + d) % 9600], the only
    values the refinement reads.
    """
    work = np.array(xc_incoherent_collapsed_pow, dtype=np.float64, copy=True)
    frq = xc_incoherent_collapsed_frq
    cells: List[Cell] = []

    while True:
        peak_n_id_2, peak_ind = np.unravel_index(np.argmax(work), work.shape)
        peak_pow = work[peak_n_id_2, peak_ind]
        if peak_pow < Z_th1[peak_ind]:
            break

        # Refine to the best single lag within +-ds_comb_arm (strict >,
        # first wins on ties -- matches the C++ scan order).
        foi = frq[peak_n_id_2, peak_ind]
        best_pow = -np.inf
        best_ind = -1
        for d, t in enumerate(range(peak_ind - ds_comb_arm,
                                    peak_ind + ds_comb_arm + 1)):
            t_wrap = t % 9600
            v = refine_slab[peak_n_id_2, d, peak_ind] \
                if refine_slab is not None \
                else xc_incoherent_single[peak_n_id_2, foi, t_wrap]
            if v > best_pow:
                best_pow = v
                best_ind = t_wrap

        cells.append(Cell(
            fc_requested=fc_requested,
            fc_programmed=fc_programmed,
            pss_pow=float(peak_pow),
            ind=int(best_ind),
            freq=float(f_search_set[foi]),
            n_id_2=int(peak_n_id_2),
        ))

        window = np.mod(np.arange(peak_ind - _SAME_PSS_CANCEL,
                                  peak_ind + _SAME_PSS_CANCEL + 1), 9600)
        # (a) no same-PSS peaks within the window
        work[peak_n_id_2, window] = 0.0
        # (b) other-PSS peaks in the window survive only if within 8 dB
        thresh8 = peak_pow * 10.0 ** (-8.0 / 10.0)
        for n in range(3):
            if n == peak_n_id_2:
                continue
            sel = window[work[n, window] < thresh8]
            work[n, sel] = 0.0
        # (c) CRS ghost floor: cancel everything 12 dB down
        work[work < peak_pow * 10.0 ** (-12.0 / 10.0)] = 0.0

    return cells


def peak_search_device(pow_c: torch.Tensor, frq_c: torch.Tensor,
                       slab: torch.Tensor, z_th1: torch.Tensor,
                       ds_comb_arm: int, cap: int = PEAK_CAP):
    """The greedy loop on device tensors for C carriers at once: pow_c /
    frq_c [C, 3, 9600], slab [C, 3, 2*arm+1, 9600], z_th1 [C, 9600] (a
    single carrier passes C = 1).  Returns (recs [C, cap, 4], n [C]) with
    rec = (pss_pow, refined_ind, frq_index, n_id_2); rows >= n[c] are
    padding.

    Runs ``cap`` masked iterations in all, whatever C (a carrier's loop
    stops contributing once its peak falls below threshold), so nothing
    waits for the host.  Ties resolve to the first maximum, as in the
    host scan order.  The 12 dB floor makes real captures end in <= ~25
    iterations; peaks beyond the cap would anyway be within 12 dB of the
    weakest accepted one, and a caller that sees n == cap reruns the
    unbounded host loop."""
    n_c, _, half = pow_c.shape
    dev = pow_c.device
    rdt = pow_c.dtype
    ci = torch.arange(n_c, device=dev)
    lags = torch.arange(half, device=dev)
    rows = torch.arange(3, device=dev)[None, :, None]
    slots = torch.arange(cap, device=dev)[None, :, None]
    th8 = 10.0 ** (-0.8)
    th12 = 10.0 ** (-1.2)
    zero = torch.zeros((), dtype=rdt, device=dev)

    work = pow_c.clone()
    recs = torch.zeros((n_c, cap, 4), dtype=rdt, device=dev)
    k = torch.zeros(n_c, dtype=torch.int64, device=dev)
    active = torch.ones(n_c, dtype=torch.bool, device=dev)
    for _ in range(cap):
        i = torch.argmax(work.reshape(n_c, -1), dim=1)
        t = torch.div(i, half, rounding_mode="floor")
        lag = i - t * half
        p = work[ci, t, lag]
        ok = active & (p >= z_th1[ci, lag])

        d = torch.argmax(slab[ci, t, :, lag], dim=1)
        best_ind = (lag - ds_comb_arm + d) % half
        rec = torch.stack([p, best_ind.to(rdt), frq_c[ci, t, lag].to(rdt),
                           t.to(rdt)], dim=1)
        hit = (slots == k[:, None, None]) & ok[:, None, None]
        recs = torch.where(hit, rec[:, None, :], recs)

        dist = torch.abs(((lags - lag[:, None] + half // 2) % half)
                         - half // 2)
        win = (dist <= _SAME_PSS_CANCEL)[:, None, :]
        same = rows == t[:, None, None]
        pk = p[:, None, None]
        cancel = (same & win) | (~same & win & (work < pk * th8)) \
            | (work < pk * th12)
        work = torch.where(ok[:, None, None] & cancel, zero, work)
        k = k + ok.to(k.dtype)
        active = ok & (k < cap)
    return recs, k


def cells_from_peak_records(recs: np.ndarray, n: int,
                            f_search_set: np.ndarray, fc_requested: float,
                            fc_programmed: float) -> List[Cell]:
    """Host materialization of peak_search_device's records."""
    cells: List[Cell] = []
    for j in range(int(n)):
        p, ind, foi, t = recs[j]
        cells.append(Cell(
            fc_requested=fc_requested, fc_programmed=fc_programmed,
            pss_pow=float(p), ind=int(round(float(ind))),
            freq=float(f_search_set[int(round(float(foi)))]),
            n_id_2=int(round(float(t)))))
    return cells
