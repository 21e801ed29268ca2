"""Channel estimation over the time/frequency grid, per antenna port.

Behavioral contract: reference chan_est + the three interchangeable
interpolators ce_interp_freq_time / ce_interp_2stage / ce_interp_hex
(reference src/searcher.cpp:1087-1477).

The raw CE extraction and the 7-point hexagonal filtering are shifted-add
tensor ops.  The triangle interpolation over the hex RS lattice is
geometry-only: the plane through three vertices evaluated at an RE is a
fixed linear (barycentric) combination of the vertex values, and the
edge-extension vertices are fixed linear combinations of two real RS
samples.  So the interpolator is a precomputed sparse linear map (<= 6
taps per RE), built once per grid geometry on the host by walking the
reference's triangle strip, then applied as one gather + weighted sum.
The 2-stage and frequency-then-time interpolators are batched linear
interpolations (ops/dsp.py::interp1) over all rows, then all columns.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..cell import Cell
from ..device import tensor
from ..ops.dsp import interp1
from .rs import RsDl


def _rs_sets(n_symb_dl: int, n_ofdm: int, port: int) -> np.ndarray:
    """OFDM symbols bearing CRS for this port (reference searcher.cpp:1383-92)."""
    if port <= 1:
        a = np.arange(0, n_ofdm, n_symb_dl)
        b = np.arange(n_symb_dl - 3, n_ofdm, n_symb_dl)
        return np.sort(np.concatenate([a, b]))
    return np.arange(1, n_ofdm, n_symb_dl)


def _raw_ce_plan(rs_dl: RsDl, n_ofdm: int, port: int):
    """Host gather plan for the raw CE extraction: (rows [n_rs], cols
    [n_rs,12], rs_vals [n_rs,12] complex, rs_set, shifts)."""
    n_symb_dl = rs_dl.n_symb_dl
    rs_set = _rs_sets(n_symb_dl, n_ofdm, port)
    n_rs = len(rs_set)
    shifts = np.empty(n_rs, dtype=np.int64)
    rs_vals = np.empty((n_rs, 12), dtype=np.complex128)
    slot_num = 0
    for t in range(n_rs):
        sym_num = int(rs_set[t] % n_symb_dl)
        shifts[t] = rs_dl.get_shift(slot_num % 20, sym_num, port)
        rs_vals[t] = rs_dl.get_rs(slot_num, sym_num)
        if (t % 2 == 1) or (port >= 2):
            slot_num = (slot_num + 1) % 20
    rows = np.asarray(rs_set, dtype=np.int64)
    cols = shifts[:, None] + 6 * np.arange(12)[None, :]
    return rows, cols, rs_vals, rs_set, shifts


def _hex_window_weights(n_rs: int, shift0: int, shift1: int):
    """Per-OUTPUT-row adjacent-window membership (wl, wr): whether the
    window applied to rows t-1 and t+1 includes subcarrier offset k-1 /
    k+1.  Reference searcher.cpp:1444-1453: the full 3-wide window when
    the two combs coincide; otherwise the bracketing pair, chosen by the
    OUTPUT row's current_row_leftmost (initialized shift(0)<shift(1),
    flipped per row).  The center tap k is always included."""
    if shift0 == shift1:
        wl = np.ones(n_rs)
        wr = np.ones(n_rs)
    else:
        leftmost = (np.arange(n_rs) % 2 == 0) == (shift0 < shift1)
        wl = leftmost.astype(np.float64)        # leftmost row -> {k-1, k}
        wr = 1.0 - wl                           # else          -> {k, k+1}
    return wl, wr


def _shift_cols(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[..., k + d] with zeros past the edge (d = -1 or +1)."""
    z = torch.zeros_like(x[..., :1])
    if d < 0:
        return torch.cat([z, x[..., :-1]], dim=-1)
    return torch.cat([x[..., 1:], z], dim=-1)


def _shift_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[..., t + d, :] with zeros past the edge (d = -1 or +1)."""
    z = torch.zeros_like(x[..., :1, :])
    if d < 0:
        return torch.cat([z, x[..., :-1, :]], dim=-2)
    return torch.cat([x[..., 1:, :], z], dim=-2)


def _hex_filter_weighted(ce_raw: torch.Tensor, wl: torch.Tensor,
                         wr: torch.Tensor) -> torch.Tensor:
    """7-point hex-lattice averaging (reference searcher.cpp:1421-1467) of
    ce_raw [..., n_rs, 12]; wl/wr [..., n_rs] give each OUTPUT row's
    adjacent-row window (see _hex_window_weights).  Same-row neighbors are
    always k-1,k,k+1; the window applied to the adjacent rows is selected
    by the output row, exactly as the reference's per-t `ind` is reused
    for both t-1 and t+1 (searcher.cpp:1444-1462)."""
    rdt = ce_raw.real.dtype
    wl = wl[..., None].to(rdt)
    wr = wr[..., None].to(rdt)
    ones = torch.ones(ce_raw.shape, dtype=rdt, device=ce_raw.device)
    zl = _shift_cols(ones, -1)
    zr = _shift_cols(ones, 1)

    same = _shift_cols(ce_raw, -1) + ce_raw + _shift_cols(ce_raw, 1)
    same_n = zl + 1.0 + zr

    def windowed(rows):
        return wl * _shift_cols(rows, -1) + rows + wr * _shift_cols(rows, 1)

    # tap counts of the adjacent window per output row (edge-clipped),
    # zeroed where the adjacent row does not exist
    adj_n = wl * zl + 1.0 + wr * zr
    has_prev = _shift_rows(ones[..., :1], -1)
    has_nxt = _shift_rows(ones[..., :1], 1)

    total = same + windowed(_shift_rows(ce_raw, -1)) \
        + windowed(_shift_rows(ce_raw, 1))
    n_total = same_n + adj_n * has_prev + adj_n * has_nxt
    return total / n_total


@lru_cache(maxsize=32)
def _hex_interp_plan(n_ofdm: int, n_symb_dl: int, shift0: int, shift1: int,
                     port_class: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse plan for ce_interp_hex: (indices [n_ofdm*72, 6],
    weights [n_ofdm*72, 6]) into the flattened ce_filt [n_rs*12].

    Walks the reference triangle-strip algorithm (searcher.cpp:1223-1362)
    over geometry only, accumulating barycentric weights; edge-extension
    vertices (searcher.cpp:1200-1213) are expanded into their two source
    samples.
    """
    rs_set = _rs_sets(n_symb_dl, n_ofdm, 2 if port_class else 0)
    n_rs = len(rs_set)

    idx_out = np.zeros((n_ofdm, 72, 6), dtype=np.int64)
    w_out = np.zeros((n_ofdm, 72, 6), dtype=np.float64)

    def row_vertices(t: int):
        """x positions + taps of row t, extended to cover sc 0 and 71.

        Returns (xs, taps) where taps[i] = list of (flat ce_filt index,
        weight) pairs defining vertex i's value.
        """
        sh = shift0 if t % 2 == 0 else shift1
        xs = list(range(sh, 72, 6))
        taps = [[(t * 12 + i, 1.0)] for i in range(len(xs))]
        if xs[0] != 0:
            # val0 - x0*(val1-val0)/(x1-x0)
            x0, x1 = xs[0], xs[1]
            a = -x0 / (x1 - x0)
            taps.insert(0, [(t * 12 + 0, 1.0 - a), (t * 12 + 1, a)])
            xs.insert(0, 0)
        if xs[-1] != 71:
            n = len([x for x in range(sh, 72, 6)])
            x_last, x_prev = xs[-1], xs[-2]
            a = (71 - x_last) / (x_last - x_prev)
            taps.append([(t * 12 + n - 1, 1.0 + a), (t * 12 + n - 2, -a)])
            xs.append(71)
        return np.array(xs, dtype=np.float64), taps

    def set_re(sym: int, sc: int, combo):
        # combo: list of (flat index, weight); merge duplicates, keep <= 6
        acc = {}
        for i, w in combo:
            acc[i] = acc.get(i, 0.0) + w
        items = sorted(acc.items())
        if len(items) > 6:
            raise AssertionError("hex plan needs more than 6 taps")
        for j, (i, w) in enumerate(items):
            idx_out[sym, sc, j] = i
            w_out[sym, sc, j] = w

    for t in range(n_rs - 1):
        top_x, top_taps = row_vertices(t)
        bot_x, bot_taps = row_vertices(t + 1)
        y_top = float(rs_set[t])
        y_bot = float(rs_set[t + 1])

        if t == 0:
            # first RS row: 1-D linear interp along frequency
            for sc in range(72):
                j = int(np.searchsorted(top_x, sc, side="right")) - 1
                j = min(max(j, 0), len(top_x) - 2)
                x0, x1 = top_x[j], top_x[j + 1]
                a = (sc - x0) / (x1 - x0)
                combo = [(i, w * (1 - a)) for i, w in top_taps[j]] + \
                        [(i, w * a) for i, w in top_taps[j + 1]]
                set_re(rs_set[0], sc, combo)

        # initial triangle (searcher.cpp:1258-1282)
        if top_x[1] < bot_x[1]:
            tri = [(top_x[0], y_top, top_taps[0]),
                   (bot_x[0], y_bot, bot_taps[0]),
                   (top_x[1], y_top, top_taps[1])]
            top_used, bot_used = 1, 0
        else:
            tri = [(bot_x[0], y_bot, bot_taps[0]),
                   (top_x[0], y_top, top_taps[0]),
                   (bot_x[1], y_bot, bot_taps[1])]
            top_used, bot_used = 0, 1

        spacing = int(rs_set[t + 1] - rs_set[t])
        x_offset = np.zeros(spacing + 1, dtype=np.int64)
        while True:
            (x1v, y1v, tp1), (x2v, y2v, tp2), (x3v, y3v, tp3) = tri
            M = np.array([[x1v, y1v, 1.0], [x2v, y2v, 1.0], [x3v, y3v, 1.0]])
            Minv = np.linalg.inv(M)
            # rightmost edge: through vertices 1 and 2 (0-based: tri[1],tri[2])
            a_l = (x2v - x3v) / (y2v - y3v)
            b_l = (y2v * x3v - y3v * x2v) / (y2v - y3v)
            for r in range(1, spacing + 1):
                y = rs_set[t] + r
                while x_offset[r] <= a_l * y + b_l:
                    x = float(x_offset[r])
                    lam = np.array([x, float(y), 1.0]) @ Minv
                    combo = [(i, w * lam[0]) for i, w in tp1] \
                        + [(i, w * lam[1]) for i, w in tp2] \
                        + [(i, w * lam[2]) for i, w in tp3]
                    set_re(int(y), int(x), combo)
                    x_offset[r] += 1
            if x_offset[1] == 72 and x_offset[-1] == 72:
                break
            if y3v == y_top:
                bot_used += 1
                new = (bot_x[bot_used], y_bot, bot_taps[bot_used])
            else:
                top_used += 1
                new = (top_x[top_used], y_top, top_taps[top_used])
            tri = [tri[1], tri[2], new]

    # rows before first / after last RS row copy the nearest RS row
    for sym in range(int(rs_set[0])):
        idx_out[sym] = idx_out[rs_set[0]]
        w_out[sym] = w_out[rs_set[0]]
    for sym in range(int(rs_set[-1]) + 1, n_ofdm):
        idx_out[sym] = idx_out[rs_set[-1]]
        w_out[sym] = w_out[rs_set[-1]]

    return idx_out.reshape(-1, 6), w_out.reshape(-1, 6)


@lru_cache(maxsize=16)
def hex_plan_compact(key):
    """The interpolation plan of a _hex_device_args_split key as (idx
    int32 [n_ofdm*72, 6], w float32): the weights are applied in float32
    precision on every device (the reference implementation's wire
    format, kept so both agree on the CPU)."""
    idx, w = _hex_interp_plan(*key)
    return (np.ascontiguousarray(idx.reshape(-1, 6).astype(np.int32)),
            np.ascontiguousarray(w.reshape(-1, 6).astype(np.float32)))


def _hex_device_args_split(rs_dl: RsDl, n_ofdm: int, port: int):
    """(small per-cell args (rows, cols, rs_conj, wl, wr), plan_key).

    The 6-tap interpolation plan depends ONLY on plan_key = (n_ofdm,
    n_symb_dl, shift0, shift1, port_class): both ports of a class share
    it, and so does every cell with the same v-shift (n_id_cell mod 6)."""
    n_symb_dl = rs_dl.n_symb_dl
    rows, cols, rs_vals, rs_set, shifts = _raw_ce_plan(rs_dl, n_ofdm, port)
    wl, wr = _hex_window_weights(len(rs_set), int(shifts[0]),
                                 int(shifts[1]))
    key = (n_ofdm, n_symb_dl, int(shifts[0]), int(shifts[1]),
           1 if port >= 2 else 0)
    return (rows, cols, np.conj(rs_vals), wl, wr), key


def _chan_est_hex_impl(tfg, rows, cols, rs_conj, wl, wr, idx, w):
    """Hex-interpolator chain for B peaks x P ports: raw-CE gather ->
    7-point hex filter -> noise estimate -> sparse triangle-plane
    interpolation.  tfg [B, n_ofdm, 72]; rows/wl/wr [B, P, n_rs]; cols and
    rs_conj [B, P, n_rs, 12]; idx/w [B, P, n_ofdm*72, 6].
    Returns (ce [B, P, n_ofdm, 72], np [B, P])."""
    bsz, n_p = rows.shape[:2]
    b = torch.arange(bsz, device=tfg.device)[:, None, None, None]
    raw = tfg[b, rows[..., None], cols] * rs_conj
    ce_filt = _hex_filter_weighted(raw, wl, wr)
    resid = ce_filt - raw
    np_est = torch.mean(resid.real ** 2 + resid.imag ** 2, dim=(-2, -1))
    return _hex_gather_sum(ce_filt, idx, w), np_est


def _hex_gather_sum(ce_filt, idx, w):
    """The triangle-plane interpolation as a sparse gather-sum: ce_filt
    [B, P, n_rs, 12] through the plan idx/w [B, P, n_ofdm*72, 6] of
    _hex_interp_plan -> [B, P, n_ofdm, 72]."""
    bsz, n_p = idx.shape[:2]
    flat = ce_filt.reshape(bsz, n_p, -1)
    vals = torch.gather(flat, 2, idx.reshape(bsz, n_p, -1)) \
        .reshape(idx.shape) * w.to(ce_filt.real.dtype)
    n_ofdm = idx.shape[2] // 72
    return vals.sum(dim=-1).reshape(bsz, n_p, n_ofdm, 72)


def _extract_raw_ce(rs_dl: RsDl, tfg: torch.Tensor, port: int):
    """ce_raw [n_rs, 12] of one port from tfg [n_ofdm, 72], with the CRS
    symbol rows and their comb shifts."""
    rows, cols, rs_vals, rs_set, shifts = _raw_ce_plan(
        rs_dl, int(tfg.shape[0]), port)
    dev = tfg.device
    raw = tfg[torch.from_numpy(rows).to(dev)[:, None],
              torch.from_numpy(cols).to(dev)]
    raw = raw * torch.conj(torch.from_numpy(rs_vals).to(dev, tfg.dtype))
    return raw, rs_set, shifts


def _hex_filter(ce_raw: torch.Tensor, shift0: int,
                shift1: int) -> torch.Tensor:
    """7-point hex-lattice averaging of one port's ce_raw [n_rs, 12]
    (reference searcher.cpp:1421-1467)."""
    wl, wr = _hex_window_weights(int(ce_raw.shape[-2]), shift0, shift1)
    dev = ce_raw.device
    return _hex_filter_weighted(ce_raw, torch.from_numpy(wl).to(dev),
                                torch.from_numpy(wr).to(dev))


def _time_interp(frq: torch.Tensor, rs_set: np.ndarray,
                 n_ofdm: int) -> torch.Tensor:
    """Stage 2 of both separable interpolators: every subcarrier of the
    RS rows' frequency interpolation frq [n_rs, 72] linearly in time
    over all n_ofdm symbols -> [n_ofdm, 72]."""
    rdt = frq.real.dtype
    rs_x = torch.from_numpy(rs_set.astype(np.float64)).to(frq.device, rdt)
    t_all = torch.arange(n_ofdm, dtype=rdt, device=frq.device)
    return interp1(rs_x, frq.transpose(0, 1), t_all).transpose(0, 1)


def ce_interp_hex(ce_filt: torch.Tensor, rs_set: np.ndarray,
                  shifts: np.ndarray, n_ofdm: int, n_symb_dl: int,
                  port: int) -> torch.Tensor:
    """Triangle-plane interpolation of one port's filtered CE ce_filt
    [n_rs, 12] over the hex RS lattice to the full grid [n_ofdm, 72]
    (reference searcher.cpp:1200-1362), as the sparse gather-sum of
    _hex_interp_plan (the plan depends on the geometry only: rs_set
    follows from n_symb_dl and port)."""
    idx, w = _hex_interp_plan(n_ofdm, n_symb_dl, int(shifts[0]),
                              int(shifts[1]), 1 if port >= 2 else 0)
    dev = ce_filt.device
    return _hex_gather_sum(ce_filt[None, None],
                           torch.from_numpy(idx).to(dev)[None, None],
                           torch.from_numpy(w).to(dev)[None, None])[0, 0]


def ce_interp_2stage(ce_filt: torch.Tensor, rs_set: np.ndarray,
                     shifts: np.ndarray, n_ofdm: int) -> torch.Tensor:
    """Uniform-grid 2-stage interpolation (reference searcher.cpp:1125-1196).

    Stage 1 synthesizes the missing staggered lattice points by 4-neighbor
    averaging, giving a uniform grid with 3-subcarrier spacing (24 points
    per RS row); stage 2 is separable linear interpolation in frequency
    then time."""
    n_rs = ce_filt.shape[0]
    dev = ce_filt.device
    rdt = ce_filt.real.dtype
    shift0, shift1 = int(shifts[0]), int(shifts[1])

    # column k of the uniform grid: the RS comb value half = k >> 1, or
    # (at the synthesized points) the mean of its up/down neighbours at
    # half and its left/right ones at (k -+ 1) >> 1, edges dropped
    k = np.arange(24)
    half = k >> 1
    left = (k - 1) >> 1
    right = (k + 1) >> 1
    has_l = left >= 0
    has_r = right < 12
    row_leftmost = (np.arange(n_rs) % 2 == 0) == (shift0 < shift1)
    is_synth = (k[None, :] % 2) == row_leftmost[:, None].astype(int)
    vert_n = np.concatenate([[0.0], np.ones(n_rs - 1)]) \
        + np.concatenate([np.ones(n_rs - 1), [0.0]])
    count = vert_n[:, None] + has_l[None, :] + has_r[None, :]

    def cols(idx):
        return torch.from_numpy(np.clip(idx, 0, 11)).to(dev)

    zero = torch.zeros((), dtype=ce_filt.dtype, device=dev)
    total = _shift_rows(ce_filt, -1)[:, cols(half)] \
        + _shift_rows(ce_filt, 1)[:, cols(half)]
    total = total + torch.where(torch.from_numpy(has_l).to(dev),
                                ce_filt[:, cols(left)], zero)
    total = total + torch.where(torch.from_numpy(has_r).to(dev),
                                ce_filt[:, cols(right)], zero)
    avg = total / torch.from_numpy(count).to(dev, rdt)
    grid = torch.where(torch.from_numpy(is_synth).to(dev), avg,
                       ce_filt[:, cols(half)])                  # [n_rs, 24]

    exp_x = torch.from_numpy(np.arange(min(shift0, shift1), 72, 3,
                                       dtype=np.float64)[:24]).to(dev, rdt)
    frq = interp1(exp_x, grid, torch.arange(72, dtype=rdt, device=dev))
    return _time_interp(frq, rs_set, n_ofdm)


def ce_interp_freq_time(ce_filt: torch.Tensor, rs_set: np.ndarray,
                        shifts: np.ndarray, n_ofdm: int) -> torch.Tensor:
    """1-D frequency interpolation of every RS row over its own comb,
    then 1-D time interpolation (reference searcher.cpp:1089-1119)."""
    n_rs = ce_filt.shape[0]
    dev = ce_filt.device
    rdt = ce_filt.real.dtype
    combs = np.stack([np.arange(shifts[t % 2], 72, 6, dtype=np.float64)
                      for t in range(n_rs)])                    # [n_rs, 12]
    frq = interp1(torch.from_numpy(combs).to(dev, rdt), ce_filt,
                  torch.arange(72, dtype=rdt, device=dev))
    return _time_interp(frq, rs_set, n_ofdm)


def chan_est(cell: Cell, rs_dl: RsDl, tfg: torch.Tensor, port: int,
             interp: str = "hex"):
    """Port CE of one peak's grid tfg [n_ofdm, 72]: raw extraction, hex
    filtering, noise estimate, interpolation with ``interp`` ("hex",
    "2stage" or "freq_time").  Returns (ce_tfg [n_ofdm, 72], np) as
    tensors on tfg's device -- reference chan_est
    (searcher.cpp:1369-1477).  ``cell`` is the peak the grid belongs to;
    rs_dl holds its reference signals."""
    n_ofdm = int(tfg.shape[0])
    dev = tfg.device
    if interp == "hex":
        small, key = _hex_device_args_split(rs_dl, n_ofdm, port)
        args = [tensor(a, dev)[None, None]
                for a in small + _hex_interp_plan(*key)]
        ce, np_est = _chan_est_hex_impl(tfg[None], *args)
        return ce[0, 0], np_est[0, 0]
    ce_raw, rs_set, shifts = _extract_raw_ce(rs_dl, tfg, port)
    ce_filt = _hex_filter(ce_raw, int(shifts[0]), int(shifts[1]))
    resid = ce_filt - ce_raw
    np_est = torch.mean(resid.real ** 2 + resid.imag ** 2)
    if interp == "freq_time":
        ce_tfg = ce_interp_freq_time(ce_filt, rs_set, shifts, n_ofdm)
    elif interp == "2stage":
        ce_tfg = ce_interp_2stage(ce_filt, rs_set, shifts, n_ofdm)
    else:
        raise ValueError(f"unknown interpolator {interp!r}")
    return ce_tfg, np_est
