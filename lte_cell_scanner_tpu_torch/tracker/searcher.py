"""Background cell searcher (the reference searcher thread, re-designed).

Behavioral contract: reference src/searcher_thread.cpp:55-248: run the
full CellSearch pipeline over an 8-frame capture with a SINGLE frequency
hypothesis (the current global frequency offset), skip cells already
tracked, and hand newly-found cells to the tracker with frame timing
rescaled into the dongle timescale
(frame_start*(FS_LTE/16)/(fs*k) + capture_lateness, mod 19200).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import List

import numpy as np

from ..constants import FS_LTE
from ..models.search import SearchConfig, cell_search
from .state import GlobalState, TrackedCell


def search_once(capbuf: np.ndarray, capbuf_late: float, state: GlobalState,
                tracked: List[TrackedCell],
                config: SearchConfig = None, device=None, mesh=None
                ) -> List[TrackedCell]:
    """One searcher cycle on ``device`` (None = the card), or with its
    front end over ``mesh``, a (t x 1) grid of devices
    (``parallel/sharded.py``: the capture's time axis in overlap-save
    blocks; ``models/search.py::cell_search_sharded``); returns
    newly-found cells to track.  The one hypothesis makes T = 3
    correlation templates."""
    t0 = time.perf_counter()
    cfg = config or SearchConfig()
    f_search_set = np.array([state.frequency_offset])
    k_factor = state.k_factor()

    # skip already-tracked cells right after SSS detection, before the
    # expensive FOE/tfg/tfoec/MIB back half -- the reference searcher
    # thread's placement of the check (searcher_thread.cpp:157-177)
    tracked_ids = frozenset(c.n_id_cell for c in tracked)
    cfg = replace(cfg, skip_ids=cfg.skip_ids | tracked_ids)

    cells = cell_search(capbuf, f_search_set, state.fc_requested,
                        state.fc_programmed, state.fs_programmed, cfg,
                        device=None if mesh is not None else device,
                        mesh=mesh)

    new_cells = []
    for cell in cells:
        frame_timing = cell.frame_start * (FS_LTE / 16) \
            / (state.fs_programmed * k_factor) + capbuf_late
        new_cells.append(TrackedCell.from_cell(cell, frame_timing))
    state.searcher_cycle_time = time.perf_counter() - t0
    return new_cells
