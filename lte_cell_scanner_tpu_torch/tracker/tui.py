"""Interactive curses dashboard for the tracker.

Behavioral contract: the reference display thread's ncurses UI
(reference src/display_thread.cpp:374-900): ~1 Hz in-place
refresh with keyboard control (:763-830) --
  q quit | r auto-refresh toggle | -/+ refresh slower/faster
  f fifo-status toggle | a avg/instant toggle | ESC back
  k/up, j/down cell select | l/right/enter detail view & next detail
  left previous detail / back to the standard view
and a per-cell DETAIL mode cycling through channel-magnitude,
channel-phase, frequency-autocorrelation (coherence bandwidth) and
time-autocorrelation (coherence time) plots (:597-757).

Key dispatch is a pure function over an immutable TuiState so the
control surface is unit-testable without a terminal; the curses loop
(run_tui) is a thin shell around it and falls back cleanly when stdout
is not a tty (cli.py picks the plain-print path instead).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np

from .display import _ascii_plot, render
from .state import GlobalState, TrackedCell

N_DETAILS = 4
_DETAIL_NAMES = ("channel magnitude", "channel phase",
                 "freq autocorrelation (coherence bw)",
                 "time autocorrelation (coherence time)")

# keys handled without curses imported (curses.KEY_* resolved at runtime)
_KEY_UP = 259
_KEY_DOWN = 258
_KEY_LEFT = 260
_KEY_RIGHT = 261


@dataclass(frozen=True)
class TuiState:
    auto_refresh: bool = True
    refresh_delay_sec: float = 1.0
    fifo_status: bool = False
    avg_values: bool = True
    mode: str = "std"            # "std" | "detail"
    detail_type: int = 0
    highlight: int = 0           # index into the tracked-cell list


def handle_key(state: TuiState, ch: int, n_cells: int
               ) -> Tuple[TuiState, bool]:
    """One keystroke -> (new state, quit?).  Mirrors
    display_thread.cpp:763-830; ch < 0 (no key) is a no-op."""
    if ch < 0:
        return state, False
    c = chr(ch).lower() if 0 <= ch < 256 else ""
    if c == "q":
        return state, True
    if c == "r":
        return replace(state, auto_refresh=not state.auto_refresh), False
    if c in ("-", "_"):
        return replace(state, refresh_delay_sec=min(
            15.0, state.refresh_delay_sec * 1.5)), False
    if c in ("+", "="):
        return replace(state, refresh_delay_sec=max(
            0.001, state.refresh_delay_sec / 1.5)), False
    if c == "f":
        return replace(state, fifo_status=not state.fifo_status), False
    if c == "a":
        return replace(state, avg_values=not state.avg_values), False
    if ch == 27:  # ESC
        return replace(state, mode="std"), False
    if c == "k" or ch == _KEY_UP:
        return replace(state, highlight=max(0, state.highlight - 1)), False
    if c == "j" or ch == _KEY_DOWN:
        hi = min(max(0, n_cells - 1), state.highlight + 1)
        return replace(state, highlight=hi), False
    if c == "l" or ch in (_KEY_RIGHT, 10, 13):
        if state.mode == "std":
            return replace(state, mode="detail", detail_type=0), False
        return replace(state, detail_type=min(state.detail_type + 1,
                                              N_DETAILS - 1)), False
    if ch == _KEY_LEFT:
        if state.mode == "detail":
            if state.detail_type == 0:
                return replace(state, mode="std"), False
            return replace(state, detail_type=state.detail_type - 1), False
    return state, False


def _detail_plot(cell: TrackedCell, detail_type: int) -> str:
    if detail_type == 0 and cell.ce is not None:
        return _ascii_plot(np.abs(cell.ce[0]), label="|CE| port 0")
    if detail_type == 1 and cell.ce is not None:
        return _ascii_plot(np.angle(cell.ce[0]), label="arg(CE) port 0")
    if detail_type == 2:
        return _ascii_plot(np.abs(cell.ac_fd), label="|ac_fd|")
    if detail_type == 3:
        return _ascii_plot(np.abs(cell.ac_td), label="|ac_td|")
    return "(no data yet)"


def render_screen(tui: TuiState, state: GlobalState,
                  cells: List[TrackedCell]) -> str:
    """Full screen contents for the current mode (plain string; the
    curses shell just paints it)."""
    lines = [f"LTE-Tracker GPU -- q quit  r refresh({'auto' if tui.auto_refresh else 'manual'})  "
             f"-/+ rate({tui.refresh_delay_sec:.2g}s)  f fifo  a avg  "
             f"j/k select  l/left detail"]
    if tui.mode == "detail" and cells:
        c = cells[min(tui.highlight, len(cells) - 1)]
        lines.append(f"Cell {c.n_id_cell}  detail "
                     f"{tui.detail_type + 1}/{N_DETAILS}: "
                     f"{_DETAIL_NAMES[tui.detail_type]}")
        lines.append(_detail_plot(c, tui.detail_type))
        return "\n".join(lines)

    body = render(state, cells, plots=False).splitlines()
    # mark the highlighted cell row
    out = []
    cell_row = -1
    for ln in body:
        if ln.startswith("  Cell "):
            cell_row += 1
            marker = ">" if cell_row == tui.highlight else " "
            ln = marker + ln[1:]
            if tui.fifo_status and cell_row < len(cells):
                c = cells[cell_row]
                ln += f"  [fifo {c.fifo_depth}/{c.fifo_peak_size}]"
        out.append(ln)
    lines += out
    if not tui.avg_values:
        lines.append("(instantaneous values mode)")
    return "\n".join(lines)


def tui_loop(scr, process_until_next_frame, state: GlobalState,
             get_cells, duration: Optional[float] = None) -> None:
    """The shell's event loop against an injected screen object (any
    object with nodelay/erase/addstr/refresh/getch/getmaxyx --
    a curses window in production, a fake in the headless CI test).
    Factored out of run_tui so the erase/paint/getch-dispatch/quit path
    itself executes under test (reference display loop
    reference src/display_thread.cpp:763-830)."""
    import curses
    import time

    scr.nodelay(True)
    tui = TuiState()
    t_start = time.time()
    running = True
    while running:
        if not process_until_next_frame(tui.refresh_delay_sec):
            break
        if duration and time.time() - t_start >= duration:
            break
        cells = get_cells()
        if tui.auto_refresh:
            scr.erase()
            text = render_screen(tui, state, cells)
            maxy, maxx = scr.getmaxyx()
            for y, ln in enumerate(text.splitlines()[:maxy - 1]):
                try:
                    scr.addstr(y, 0, ln[:maxx - 1])
                except curses.error:
                    pass
            scr.refresh()
        while True:
            ch = scr.getch()
            if ch < 0:
                break
            tui, quit_ = handle_key(tui, ch, len(cells))
            if quit_:
                running = False
                break


def run_tui(process_until_next_frame, state: GlobalState,
            get_cells, duration: Optional[float] = None) -> None:
    """Curses shell: repeatedly advance the tracker loop by ~one refresh
    interval, repaint, and dispatch keys.

    process_until_next_frame(seconds) -> False when the stream ended.
    """
    import curses

    def loop(scr):
        curses.use_default_colors()
        tui_loop(scr, process_until_next_frame, state, get_cells,
                 duration)

    curses.wrapper(loop)
