"""Status dashboard (the reference ncurses display thread, re-designed).

Behavioral contract: reference src/display_thread.cpp:374-900 -- a
1 Hz status view of every tracked cell: frame timing, health, per-port CRS
SP/NP/SNR (instant + exponentially averaged), sync-channel SNR from
PSS/SSS, the global frequency offset, searcher cycle time and drop
counters, plus ASCII plots of channel magnitude/phase and the freq/time
channel autocorrelations (coherence bandwidth/time readouts).

Rendered as plain text (terminal or log sink); an interactive curses
wrapper can layer on top of render().
"""

from __future__ import annotations

from typing import List

import numpy as np

from .state import GlobalState, TrackedCell


def _db10(x) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(10.0 * np.log10(x))


def _ascii_plot(values: np.ndarray, height: int = 8, width: int = 60,
                label: str = "") -> str:
    """Minimal ASCII trace plot (reference plot_trace,
    display_thread.cpp:245-370)."""
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if len(v) == 0:
        return f"{label}: (no data)"
    if len(v) > width:
        idx = np.linspace(0, len(v) - 1, width).astype(int)
        v = v[idx]
    lo, hi = float(v.min()), float(v.max())
    span = hi - lo if hi > lo else 1.0
    rows = []
    scaled = ((v - lo) / span * (height - 1)).round().astype(int)
    for r in range(height - 1, -1, -1):
        rows.append("".join("*" if s == r else " " for s in scaled))
    header = f"{label}  [min {lo:.3g}, max {hi:.3g}]"
    return "\n".join([header] + rows)


def render(state: GlobalState, cells: List[TrackedCell],
           plots: bool = False) -> str:
    """Render the full dashboard as a string."""
    lines = []
    usb = (f" / usb {state.usb_seconds_dropped:.2f}s"
           if state.usb_seconds_dropped else "")
    lines.append(f"Dongle FO: {state.frequency_offset:9.1f} Hz   "
                 f"searcher cycle: {state.searcher_cycle_time:6.2f} s   "
                 f"dropped: raw {state.raw_seconds_dropped}s / "
                 f"cell {state.cell_seconds_dropped}s{usb}")
    lines.append(f"Tracking {len(cells)} cell(s)")
    for c in cells:
        lines.append(
            f"  Cell {c.n_id_cell:3d}  ports {c.n_ports}  "
            f"CP {'N' if c.n_symb_dl() == 7 else 'E'}  nRB {c.n_rb_dl:3d}  "
            f"frame timing {c.frame_timing:10.3f}  "
            f"health {c.health_pct():5.1f}%  "
            f"buffer {c.fifo_depth}/{c.fifo_peak_size}")
        # numeric coherence bandwidth: first RS-lag (90 kHz spacing)
        # where |ac_fd| falls to 0.5 (reference display_thread.cpp:166-177)
        cb = next((k for k in range(1, 12) if abs(c.ac_fd[k]) <= 0.5), -1)
        cb_txt = ">990 kHz" if cb < 0 else f"{cb * 90:4d} kHz"
        lines.append(f"    coherence bw {cb_txt}")
        if c.mib_redecodes:
            lines.append(f"    MIB passes/re-decodes "
                         f"{c.mib_passes}/{c.mib_redecodes}")
        if plots and np.isfinite(c.sync_np_blank_av):
            lines.append(f"    UOS pwr {_db10(c.sync_np_blank_av):6.1f} dB")
        if np.isfinite(c.sync_sp_av) and np.isfinite(c.sync_np_av) \
                and c.sync_np_av > 0:
            snr = _db10(c.sync_sp_av / c.sync_np_av)
            lines.append(f"    sync: SP {_db10(c.sync_sp_av):6.1f} dB  "
                         f"NP {_db10(c.sync_np_av):6.1f} dB  "
                         f"SNR {snr:5.1f} dB")
        if c.crs_sp_raw_av is not None and c.crs_np_av is not None:
            for p in range(len(c.crs_sp_raw_av)):
                sp = c.crs_sp_raw_av[p]
                npp = c.crs_np_av[p]
                snr = _db10(sp / npp) if npp > 0 and sp > 0 else float("nan")
                line = (f"    port {p}: SP {_db10(sp):6.1f} dB  "
                        f"NP {_db10(npp):6.1f} dB  SNR {snr:5.1f} dB")
                if plots and c.crs_sp_raw is not None \
                        and c.crs_np is not None:
                    # expert mode adds the instant values next to the
                    # exponential averages (reference avg_values toggle,
                    # display_thread.cpp:151-166)
                    line += (f"   inst {_db10(c.crs_sp_raw[p]):6.1f}/"
                             f"{_db10(c.crs_np[p]):6.1f} dB")
                lines.append(line)
        if plots:
            if c.ce is not None:
                lines.append(_ascii_plot(np.abs(c.ce[0]),
                                         label="    |CE| port 0"))
            lines.append(_ascii_plot(np.abs(c.ac_fd),
                                     label="    |ac_fd| (coherence bw)"))
            lines.append(_ascii_plot(np.abs(c.ac_td),
                                     label="    |ac_td| (coherence time)"))
    return "\n".join(lines)
