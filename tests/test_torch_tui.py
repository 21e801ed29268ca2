"""The port's dashboard, TUI and ``cli.py track`` against the TPU
package's, on the CPU.

- ``handle_key`` over every key code in every mode gives the TPU
  package's state and quit flag;
- ``render`` (plain and expert) and ``render_screen`` (standard and
  detail views) print the same text for the same tracked cells, apart
  from the title's device word (GPU for TPU);
- ``tui_loop`` runs headless against a fake screen, as tests/test_tui.py
  does;
- ``track --sim --duration 0.5 --no-tui --device cpu`` prints the TPU
  CLI's output on every line but the "Dongle FO:" lines, which carry the
  searcher's cycle time in wall seconds, and the port's "MIB
  passes/re-decodes" lines, which the TPU package lacks; and the
  argument checks.
"""

import dataclasses

import numpy as np
import pytest

from lte_cell_scanner_tpu import cli as jcli
from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.tracker import display as jdisplay
from lte_cell_scanner_tpu.tracker import tui as jtui
from lte_cell_scanner_tpu.tracker.state import GlobalState as JGlobalState
from lte_cell_scanner_tpu.tracker.state import TrackedCell as JTrackedCell
from lte_cell_scanner_tpu_torch import cli
from lte_cell_scanner_tpu_torch.interop import (global_state_from_fields,
                                                tracked_cell_from_fields)
from lte_cell_scanner_tpu_torch.tracker import display as tdisplay
from lte_cell_scanner_tpu_torch.tracker import tui as ttui

FC = 739e6


def _states():
    """A TPU-package global state and three tracked cells with measured
    fields, and the port's copies."""
    rng = np.random.default_rng(6)
    gs = JGlobalState(fc_requested=FC, fc_programmed=FC, fs_programmed=1.92e6,
                      frequency_offset=123.4, cell_seconds_dropped=2,
                      usb_seconds_dropped=0.5, searcher_cycle_time=0.25)
    cells = []
    for n_id, ports, cp in ((277, 2, "normal"), (271, 1, "extended"),
                            (301, 4, "normal")):
        c = JTrackedCell(n_id_cell=n_id, n_id_1=n_id // 3, n_id_2=n_id % 3,
                         cp_type=JCpType(cp), n_ports=ports,
                         frame_timing=1234.5 + n_id, fifo_depth=3,
                         fifo_peak_size=70, mib_decode_failures=1.25)
        if n_id != 301:                    # one cell without measurements
            c.ce = rng.normal(size=(ports, 72)) \
                + 1j * rng.normal(size=(ports, 72))
            c.ac_fd = np.linspace(1.0, 0.2, 12) + 0j
            c.ac_td = np.linspace(1.0, 0.6, 72) + 0j
            c.crs_sp_raw = rng.uniform(0.5, 1.0, ports)
            c.crs_np = rng.uniform(0.01, 0.1, ports)
            c.crs_sp_raw_av = rng.uniform(0.5, 1.0, ports)
            c.crs_np_av = rng.uniform(0.01, 0.1, ports)
            c.sync_sp_av, c.sync_np_av = 0.9, 0.05
            c.sync_np_blank_av = 0.01
        cells.append(c)
    return (gs, cells, global_state_from_fields(dataclasses.asdict(gs)),
            [tracked_cell_from_fields(dataclasses.asdict(c)) for c in cells])


def test_handle_key_matches_tpu_package():
    modes = [dict(), dict(mode="detail", detail_type=2, highlight=1),
             dict(mode="detail", detail_type=0), dict(auto_refresh=False,
                                                      refresh_delay_sec=15.0)]
    for kw in modes:
        for ch in list(range(-1, 300)):
            for n_cells in (0, 3):
                ws, wq = jtui.handle_key(jtui.TuiState(**kw), ch, n_cells)
                gs, gq = ttui.handle_key(ttui.TuiState(**kw), ch, n_cells)
                assert dataclasses.asdict(gs) == dataclasses.asdict(ws), \
                    (kw, ch)
                assert gq == wq


@pytest.mark.parametrize("plots", [False, True], ids=["plain", "expert"])
def test_render_matches_tpu_package(plots):
    jgs, jcells, tgs, tcells = _states()
    assert tdisplay.render(tgs, tcells, plots=plots) == \
        jdisplay.render(jgs, jcells, plots=plots)


@pytest.mark.parametrize("kw", [
    dict(highlight=1, fifo_status=True),
    dict(avg_values=False, auto_refresh=False),
    dict(mode="detail", detail_type=0, highlight=0),
    dict(mode="detail", detail_type=1, highlight=1),
    dict(mode="detail", detail_type=2, highlight=2),
    dict(mode="detail", detail_type=3, highlight=2)])
def test_render_screen_matches_tpu_package(kw):
    jgs, jcells, tgs, tcells = _states()
    got = ttui.render_screen(ttui.TuiState(**kw), tgs, tcells)
    want = jtui.render_screen(jtui.TuiState(**kw), jgs, jcells)
    assert got.startswith("LTE-Tracker GPU -- ")
    assert got == want.replace("LTE-Tracker TPU -- ", "LTE-Tracker GPU -- ",
                               1)


class FakeScreen:
    """Headless stand-in for a curses window (tests/test_tui.py)."""

    def __init__(self, keys):
        self._keys = list(keys)
        self.painted = []
        self.erases = 0
        self.refreshes = 0

    def nodelay(self, flag):
        self.nodelay_set = flag

    def erase(self):
        self.erases += 1

    def getmaxyx(self):
        return (40, 120)

    def addstr(self, y, x, s):
        self.painted.append(s)

    def refresh(self):
        self.refreshes += 1

    def getch(self):
        if self._keys:
            v = self._keys.pop(0)
            return ord(v) if isinstance(v, str) else v
        return -1


def test_tui_loop_paints_what_the_tpu_package_paints():
    """The same key stream through both shells paints the same frames
    (title aside) and quits on 'q' while the stream is live."""
    painted = {}
    for name, mod, states in (("port", ttui, _states()[2:]),
                              ("tpu", jtui, _states()[:2])):
        gs, cells = states
        scr = FakeScreen([-1, "f", "j", -1, "l", -1, "q"])
        calls = []

        def process_for(seconds, calls=calls):
            calls.append(seconds)
            return True
        mod.tui_loop(scr, process_for, gs, lambda cells=cells: cells)
        assert len(calls) >= 3 and scr.erases >= 3
        painted[name] = [p.replace("LTE-Tracker TPU", "LTE-Tracker GPU")
                         for p in scr.painted]
    assert painted["port"] == painted["tpu"]
    joined = "\n".join(painted["port"])
    assert "q quit" in joined and "Cell 277" in joined and "[fifo" in joined


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out


def test_render_shows_the_mib_redecode_counters():
    """A cell with MIB re-decodes shows its passes over its re-decodes
    under its row; a cell without any shows no such line."""
    _jgs, _jcells, tgs, tcells = _states()
    tcells[0].mib_redecodes, tcells[0].mib_passes = 12, 11
    lines = tdisplay.render(tgs, tcells).splitlines()
    mib = [ln for ln in lines if ln.startswith("    MIB ")]
    assert mib == ["    MIB passes/re-decodes 11/12"]
    row = lines.index(mib[0])
    assert lines[row - 1].startswith("    coherence bw ")
    assert lines[row - 2].startswith("  Cell 277 ")


def test_cli_track_prints_the_tpu_cli_dashboard(capsys):
    """Lines excluded from the comparison: those starting "Dongle FO:"
    (the searcher cycle time, wall seconds) and the port's own "MIB
    passes/re-decodes" lines."""
    argv = ["track", "-f", "739e6", "--sim", "--duration", "0.5",
            "--no-tui"]
    rc, out = _run(cli.main, argv + ["--device", "cpu"], capsys)
    jrc, jout = _run(jcli.main, ["--platform", "cpu"] + argv, capsys)
    assert rc == jrc == 0

    def kept(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith(("Dongle FO:", "    MIB "))]
    assert kept(out) == kept(jout)
    assert any(ln.startswith("    MIB passes/re-decodes ")
               for ln in out.splitlines())
    assert not any(ln.startswith("    MIB ") for ln in jout.splitlines())
    assert sum(ln.startswith("Dongle FO:") for ln in out.splitlines()) == \
        sum(ln.startswith("Dongle FO:") for ln in jout.splitlines()) == 1
    assert "  Cell 277  ports 2  CP N  nRB   6" in out
    assert "health 100.0%" in out


def test_cli_track_argument_checks(capsys):
    # no source named: a live dongle, which this machine lacks; the TPU
    # CLI's Error:, and no fallback to another source
    with pytest.raises(SystemExit) as got:
        cli.main(["track", "-f", "739e6", "--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jcli.main(["--platform", "cpu", "track", "-f", "739e6"])
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("Error: ")
    assert capsys.readouterr().out == ""
    rc, out = _run(cli.main, ["track", "-f", "739e6", "--sim", "-p", "-1",
                              "--device", "cpu"], capsys)
    assert (rc, out) == (1, "Error: ppm value must be positive\n")
    rc, out = _run(cli.main, ["track", "-f", "739e6", "--sim",
                              "--shard-search", "--no-kalibrate",
                              "--no-warmup", "--duration", "0.01",
                              "--no-tui", "--device", "cpu"], capsys)
    assert rc == 0
    assert out.startswith("Warning: --shard-search requested but only one "
                          "device is visible; running single-device\n")
    assert "Tracking 0 cell(s)" in out


def test_cli_track_needs_the_card_unless_told(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run(cli.main, ["track", "-f", "739e6", "--sim"], capsys)
    assert rc == 1 and out.startswith("Error: no CUDA device")
