"""The plain reference: what a tracker of the stream must report and
compute, worked out from the generator's truth, and the comparison that
decides ``correct``.

It imports nothing of the program and takes nothing the program made:
the program's answers are read only to be judged.  Judged, over the
measured window and at its close:

- the tracked set at the close: the cells on air, each once, with its
  CP, ports, n_rb and PHICH, holding MIB sync and not dropped; its frame
  timing (samples mod 19200) within ``timing_tol_samples`` of the true
  frame boundary; the offset register within ``freq_tol_ppm`` of the
  true offset;
- the window's own work: each cell's 40 ms MIB re-decodes in the window,
  every one passed and carrying the transmitted MIB (bandwidth, PHICH,
  the SFN of the 40 ms period that just ended), as many as the window's
  stream holds (one per 76800 samples); no second of symbols or of raw
  stream dropped;
- the tick's device program on ticks drawn from the seed: its outputs
  (each cell's CRS channel-estimate rows, sync and PBCH symbol rows and
  final phase) against the same demodulation worked out here in float64
  numpy from the tick's inputs.  This follows the program step by step:
  the tick's inputs (the symbols' start samples, frequency offsets,
  lateness and slot labels) are the program's own state, which the
  tracked set's frame timing, offset register and MIB decodes check at
  the close.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .frozen.dl_sig import mib_bits
from .frozen.lte import rs_dl_shift, rs_dl_symbols

FRAME_LEN = 19200
MIB_PERIOD = 4 * FRAME_LEN
FS_LTE = 30.72e6
# a normal-CP frame's PBCH (slot 1, symbols 0-3) ends 1509 samples in
PBCH_END = 960 + 138 + 3 * 137
_CN = np.concatenate([np.arange(-36, 0), np.arange(1, 37)])

# Limits of the numbers that no guarantee states; PERF.md gives the
# readings each was set between.
MIB_GAP_LIMIT = 3
TICK_GAP_LIMIT = 1e-9


@dataclass
class Verdict:
    """Mismatches, the numbers compared and notes on what failed."""
    mismatches: int = 0
    answers: int = 0
    checks: Dict[str, List[float]] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    def miss(self, note: str, n: int = 1) -> None:
        self.mismatches += n
        if len(self.notes) < 12:
            self.notes.append(note)

    @property
    def correct(self) -> bool:
        return self.mismatches == 0 and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())

    @property
    def failed(self) -> int:
        return int(not self.correct)


def mib_frame(t, fed: int) -> Optional[int]:
    """The frame (counted from ``t.frame0``) that ends the 40 ms period
    a re-decode at stream position ``fed`` read: the frame with SFN % 4
    == 3 whose PBCH ended at or before ``fed`` and less than two frames
    before it (a tick reads a block of well under a frame); None where
    there is none."""
    q = (fed - PBCH_END - t.frame0) // FRAME_LEN
    for f in (q, q - 1):
        if t.sfn(f) % 4 == 3:
            return f
    return None


def judge_mib(t, decodes: Sequence[tuple], v: Verdict) -> int:
    """One cell's re-decodes in the window, each (stream position,
    passed, the 24 decoded MIB bits); returns how many passed carrying
    the transmitted MIB."""
    good = 0
    for fed, passed, bits in decodes:
        f = mib_frame(t, fed)
        if not passed:
            v.miss(f"cell {t.n_id_cell}: MIB re-decode at {fed} failed")
            continue
        want = None if f is None else mib_bits(t.n_rb_dl, t.sfn(f))
        if want is None or bits is None or not np.array_equal(bits, want):
            v.miss(f"cell {t.n_id_cell}: MIB at {fed} is not the "
                   f"transmitted one")
            continue
        good += 1
    return good


def judge_tracker(close: dict, window: dict, truth, f_off: float,
                  fc: float, guarantees: Dict) -> Verdict:
    """The tracker's state at the window's close (``close``: the tracked
    cells and the offset register) and the window's own work
    (``window``: stream samples fed, re-decodes per cell, seconds
    dropped, the sampled ticks) against the stream's truth."""
    v = Verdict(answers=1)
    ids = {t.n_id_cell for t in truth}
    seen: Dict[int, dict] = {}
    for c in close["tracked"]:
        if c["n_id_cell"] not in ids or c["n_id_cell"] in seen:
            v.miss(f"tracked cell {c['n_id_cell']} not on air or twice")
        seen.setdefault(c["n_id_cell"], c)
    tgap_max = 0.0
    for t in truth:
        c = seen.get(t.n_id_cell)
        if c is None:
            v.miss(f"cell {t.n_id_cell} not tracked")
            tgap_max = math.inf
            continue
        want = {"cp": "normal" if t.normal_cp else "extended",
                "n_ports": t.n_ports, "n_rb_dl": t.n_rb_dl,
                "phich": tuple(t.phich), "mib_synced": True,
                "kill_me": False}
        for key, val in want.items():
            if c[key] != val:
                v.miss(f"cell {t.n_id_cell}: {key} {c[key]} != {val}")
        d = (c["frame_timing"] - t.frame0) % FRAME_LEN
        tgap = min(d, FRAME_LEN - d)
        tgap_max = max(tgap_max, tgap if math.isfinite(tgap) else math.inf)
    fgap = abs(close["frequency_offset"] - f_off) / fc * 1e6

    n_mib = window["samples"] / MIB_PERIOD
    mib_gap = 0.0
    for t in truth:
        good = judge_mib(t, window["decodes"].get(t.n_id_cell, []), v)
        mib_gap = max(mib_gap, abs(good - n_mib))
    for key in ("cell_seconds_dropped", "raw_seconds_dropped"):
        if window[key]:
            v.miss(f"{key}: {window[key]} in the window", window[key])

    tick_gap = max([gap_of_tick(r) for r in window["ticks"]],
                   default=math.inf)
    v.checks = {
        "mismatches": [v.mismatches, 0],
        "mib_gap": [mib_gap, MIB_GAP_LIMIT],
        "timing_gap_samples": [tgap_max, guarantees["timing_tol_samples"]],
        "freq_gap_ppm": [fgap if math.isfinite(fgap) else math.inf,
                         guarantees["freq_tol_ppm"]],
        "tick_gap": [tick_gap, TICK_GAP_LIMIT]}
    return v


def _wrap(x):
    return (x + math.pi) % (2 * math.pi) - math.pi


def tick_reference(rec: dict):
    """One tick's outputs worked out in float64 from its inputs: per
    cell (the CRS rows of each port, the special rows, the final
    phase), with the rows' positions found from the slot labels."""
    fln = rec["fln"]
    if rec["planes"] is not None:
        ext = rec["planes"][:, 0] + 1j * rec["planes"][:, 1]
        wins = ext[rec["starts"][:, :, None] + np.arange(128)]
    else:
        wins = rec["data"][..., 0] + 1j * rec["data"][..., 1]
    n = np.arange(128)
    out = []
    for b, (cid, n_ports, normal_cp, slots, syms) in enumerate(rec["cells"]):
        fo, late, nse = fln[b, 0], fln[b, 1], fln[b, 2]
        valid = nse > 0
        win = wins[b]                                           # [S, 128]
        k = (rec["fc_requested"] - fo) / rec["fc_programmed"]
        mix = np.exp(-2j * np.pi * fo[:, None] * n
                     / (rec["fs_programmed"] * k)[:, None])
        x = np.fft.fft(np.roll(win * mix, -2, axis=-1), axis=-1) \
            / math.sqrt(128.0)
        x = np.concatenate([x[:, -36:], x[:, 1:37]], axis=-1)
        incr = np.where(valid, 2 * np.pi * nse * (16.0 / FS_LTE) * (-fo),
                        0.0)
        phase = rec["init_phase"][b] + np.cumsum(incr)
        x = x * np.exp(1j * (phase[:, None]
                             - 2 * np.pi * late[:, None] / 128.0 * _CN))
        n_symb = 7 if normal_cp else 6
        ce = []
        for p in range(n_ports):
            rows = []
            for i, (sl, sy) in enumerate(zip(slots, syms)):
                sh = rs_dl_shift(int(sl), int(sy), p, n_symb, cid)
                if sh >= 0:
                    rs = rs_dl_symbols(int(sl), int(sy), cid, 6, normal_cp)
                    rows.append(x[i, sh::6] * np.conj(rs))
            ce.append(np.array(rows).reshape(-1, 12))
        sync = ((slots == 0) | (slots == 10)) \
            & ((syms == n_symb - 2) | (syms == n_symb - 1))
        pbch = (slots == 1) & (syms <= 3)
        spec = x[np.nonzero(sync | pbch)[0]]
        out.append((ce, spec, _wrap(phase[-1])))
    return out


def unpack(packed: np.ndarray, shape):
    """The program's packed tick output as (ce [B, P, NR, 12], special
    rows [B, NQ, 72], final phases [B])."""
    B, P, NR, NQ = shape
    n_ce, n_sp = B * P * NR * 12, B * NQ * 72
    ce = packed[:n_ce] + 1j * packed[n_ce: 2 * n_ce]
    sp = packed[2 * n_ce: 2 * n_ce + n_sp] \
        + 1j * packed[2 * n_ce + n_sp: 2 * (n_ce + n_sp)]
    return (ce.reshape(B, P, NR, 12), sp.reshape(B, NQ, 72),
            packed[2 * (n_ce + n_sp):])


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return math.inf
    if want.size == 0:
        return 0.0
    scale = math.sqrt(float(np.mean(np.abs(want) ** 2))) or 1.0
    return float(np.max(np.abs(got - want))) / scale


def gap_of_tick(rec: dict) -> float:
    """The widest gap of one tick's outputs from the reference's: the
    rows' largest error over their RMS, or the final phase's error in
    radians; infinite where a row is missing or extra."""
    ce_p, sp_p, final_p = unpack(rec["out"], rec["shape"])
    gap = 0.0
    for b, (ce_r, sp_r, final_r) in enumerate(tick_reference(rec)):
        for p, rows in enumerate(ce_r):
            if len(rows) != rec["n_rs"][b][p]:
                return math.inf
            gap = max(gap, _rel(ce_p[b, p, : len(rows)], rows))
        if len(sp_r) != rec["n_spec"][b]:
            return math.inf
        gap = max(gap, _rel(sp_p[b, : len(sp_r)], sp_r),
                  abs(_wrap(final_p[b] - final_r)))
    return gap
