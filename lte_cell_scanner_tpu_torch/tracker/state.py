"""Shared tracker state.

Re-design of the reference's thread-shared structs
(reference include/LTE-Tracker.h: global_thread_data_t:158,
tracked_cell_t:19): the boost mutex/condvar registers become plain fields
updated by the single-threaded deterministic event loop (the reference's
"single-writer with tolerated races" discipline becomes exact ordering).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..cell import Cell, CpType, PhichDuration, PhichResource
from ..constants import CELL_DROP_THRESHOLD


@dataclass
class GlobalState:
    """Dongle-level shared state (reference global_thread_data_t)."""
    fc_requested: float
    fc_programmed: float
    fs_programmed: float
    # The global frequency-offset register, blended from every tracker's
    # FOE residuals with inverse-variance weights
    # (reference tracker_thread.cpp:239-242).
    frequency_offset: float = 0.0
    raw_seconds_dropped: int = 0
    cell_seconds_dropped: int = 0
    # seconds of raw USB bytes dropped at the radio->host ring when the
    # consumer stalls (the reference surfaces these on the dashboard,
    # display_thread.cpp:538-541); fed from RtlSdrSource.dropped_seconds
    usb_seconds_dropped: float = 0.0
    searcher_cycle_time: float = 0.0
    # generic developer scratch parameters, the reference's hidden
    # --g1..--g9 debug knobs (LTE-Tracker.cpp:158-166, globals :52-60):
    # carried on the shared state so experimental tracker code can read
    # them without new plumbing; no production path consumes them
    g: tuple = (0.0,) * 9

    def k_factor(self) -> float:
        return (self.fc_requested - self.frequency_offset) \
            / self.fc_programmed

    def blend_frequency_offset(self, fo_est: float, fo_np: float) -> None:
        w_old = 1.0 / 0.000001
        w_new = 1.0 / fo_np
        self.frequency_offset = (self.frequency_offset * w_old
                                 + fo_est * w_new) / (w_old + w_new)


@dataclass
class TrackedCell:
    """Per-cell tracking state (reference tracked_cell_t)."""
    n_id_cell: int
    n_id_1: int
    n_id_2: int
    cp_type: CpType
    n_ports: int
    frame_timing: float            # samples, mod 19200, dongle timescale
    n_rb_dl: int = 6
    phich_duration: PhichDuration = PhichDuration.NORMAL
    phich_resource: PhichResource = PhichResource.ONE
    serial_num: int = 1
    kill_me: bool = False
    freq_superfine: float = float("nan")   # FO estimate at acquisition

    # measurements (reference meas_mutex block, LTE-Tracker.h:100-123)
    mib_decode_failures: float = 0.0
    # the 40 ms MIB re-decodes (cell_tracker.py::_mib_try_decode): the
    # attempts at 16 PBCH symbols, those that passed (CRC, bandwidth and
    # PHICH), and the 24 bits the last attempt decoded
    mib_redecodes: int = 0
    mib_passes: int = 0
    mib_bits: Optional[np.ndarray] = None
    crs_sp_raw: Optional[np.ndarray] = None
    crs_np: Optional[np.ndarray] = None
    crs_tp_av: Optional[np.ndarray] = None
    crs_sp_raw_av: Optional[np.ndarray] = None
    crs_np_av: Optional[np.ndarray] = None
    sync_tp: float = np.nan
    sync_sp: float = np.nan
    sync_np: float = np.nan
    sync_np_blank: float = np.nan
    sync_tp_av: float = np.nan
    sync_sp_av: float = np.nan
    sync_np_av: float = np.nan
    sync_np_blank_av: float = np.nan
    sync_ce: Optional[np.ndarray] = None
    ce: Optional[np.ndarray] = None
    ac_fd: np.ndarray = field(default_factory=lambda: np.zeros(12, complex))
    ac_td: np.ndarray = field(default_factory=lambda: np.zeros(72, complex))
    fifo_peak_size: int = 0
    fifo_depth: int = 0

    def n_symb_dl(self) -> int:
        return 7 if self.cp_type is CpType.NORMAL else 6

    def update_frame_timing(self, new_timing: float) -> None:
        self.frame_timing = new_timing % 19200.0

    def health_pct(self) -> float:
        """Cell health for the dashboard (display_thread.cpp:124-137)."""
        return 100.0 * (1.0 - self.mib_decode_failures / CELL_DROP_THRESHOLD)

    @classmethod
    def from_cell(cls, cell: Cell, frame_timing: float) -> "TrackedCell":
        return cls(
            n_id_cell=cell.n_id_cell(), n_id_1=cell.n_id_1,
            n_id_2=cell.n_id_2, cp_type=cell.cp_type,
            n_ports=cell.n_ports, frame_timing=frame_timing % 19200.0,
            n_rb_dl=cell.n_rb_dl, phich_duration=cell.phich_duration,
            phich_resource=cell.phich_resource,
            freq_superfine=cell.freq_superfine)
