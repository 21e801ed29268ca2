"""Tracker orchestration: the deterministic event loop.

Re-design of the reference LTE-Tracker thread graph (main/pre-producer +
producer + searcher + N trackers + display,
reference src/LTE-Tracker.cpp:766-875): a single deterministic loop
drives sample blocks through the producer demultiplexer, the per-cell
trackers, and the periodic background searcher.  kalibrate() bootstraps
the dongle frequency-offset estimate exactly as the reference does
(LTE-Tracker.cpp:565-741: run the CellSearch pipeline on one carrier until
any cell is found; its freq_superfine seeds the global FO register).

The runner has a device (None = the card): the searches and the tick's
demod run there, the control loops on the host.  It never moves to the
CPU by itself: without a card the first device operation raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from ..cell import Cell
from ..device import resolve_device
from ..models.search import SearchConfig, cell_search, default_f_search_set
from ..utils.debug import stage
from .cell_tracker import TrackedCellProcessor
from .producer import Producer
from .searcher import search_once
from .state import GlobalState, TrackedCell


def kalibrate(capture_fn: Callable[[], np.ndarray], fc_requested: float,
              fc_programmed: float, fs_programmed: float,
              ppm: float = 120.0, max_tries: Optional[int] = None,
              config: Optional[SearchConfig] = None, device=None) -> float:
    """Estimate the dongle frequency offset by searching until a cell is
    found, each try a full +-ppm ``cell_search`` on ``device`` (None =
    the card); returns the best cell's freq_superfine.

    max_tries=None retries until a cell is found, exactly the
    reference's loop (LTE-Tracker.cpp:591,701-704) -- starting the
    tracker at 0 Hz after a bounded number of failures would strand
    acquisition beyond ~+-2.5 kHz of crystal error.  Bounded sources
    (file replay without --repeat) end the loop by raising when out of
    captures."""
    cfg = config or SearchConfig()
    f_search_set = default_f_search_set(fc_requested, ppm)
    tries = 0
    while max_tries is None or tries < max_tries:
        tries += 1
        capbuf = capture_fn()
        cells = cell_search(capbuf, f_search_set, fc_requested,
                            fc_programmed, fs_programmed, cfg, device=device)
        if cells:
            best = max(cells, key=lambda c: c.pss_pow)
            return float(best.freq_superfine)
    raise RuntimeError("kalibrate: no cell found")


def _deprioritize_thread() -> None:
    """Drop the searcher worker thread to nice+19 (the reference runs
    its searcher thread at nice(20), searcher_thread.cpp:66) so the
    streaming event loop keeps CPU priority."""
    try:
        import os
        import threading
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
    except (OSError, AttributeError):
        pass


class TrackerRunner:
    """Realtime multi-cell tracker over a sample stream."""

    def __init__(self, fc_requested: float, fc_programmed: float,
                 fs_programmed: float, initial_fo: float = 0.0,
                 search_config: Optional[SearchConfig] = None,
                 search_period: float = 0.0, search_async: bool = False,
                 search_duty: float = 0.5, parallel_cells: int = 0,
                 debug_knobs: tuple = (), device_loop: Optional[bool] = None,
                 device=None, search_mesh=None):
        self.device = resolve_device(device)
        g = tuple(debug_knobs) + (0.0,) * (9 - len(debug_knobs))
        self.state = GlobalState(fc_requested=fc_requested,
                                 fc_programmed=fc_programmed,
                                 fs_programmed=fs_programmed,
                                 frequency_offset=initial_fo,
                                 g=g)
        self.producer = Producer(self.state)
        self.cells: List[TrackedCell] = []
        self.processors = {}
        self.search_config = search_config or SearchConfig()
        self._search_enabled = True
        # Min stream-seconds between background-search cycles once at
        # least one cell is tracked.  The reference searcher runs
        # back-to-back but at nice+20 (searcher_thread.cpp:66), i.e. it
        # only ever consumes CPU the trackers left over; in a
        # deterministic event loop the equivalent is a bounded duty
        # cycle.  0 = search every capture (reference cadence while
        # acquiring; acquisition always searches unthrottled).
        self.search_period = search_period
        # CPU-share cap for the background searcher once tracking: the
        # next search is deferred until at least cycle_time/duty seconds
        # of stream have passed since the last one finished.  This is
        # the load-adaptive half of the reference's nice+20 semantics:
        # when the trackers saturate the machine a low-priority searcher
        # naturally cycles slower (searcher_thread.cpp:66).  0 disables
        # (pure search_period cadence).  Acquisition never throttles.
        self.search_duty = search_duty
        self._samples_fed = 0
        self._last_search_at = None
        # optional (t x 1) grid of devices (parallel/sharded.py::
        # make_mesh): the searcher's front end runs over it in
        # overlap-save time blocks, its back half on the grid's first
        # device; the tick stays on ``device``
        self.search_mesh = search_mesh
        # Concurrent background search (the reference's dedicated
        # searcher thread at nice+20, searcher_thread.cpp:66): one
        # worker thread at nice+19 runs search_once on a capbuf
        # snapshot while streaming continues; results integrate on the
        # event loop at the next tick.  Off by default so the pure
        # event loop stays deterministic for tests; the CLI enables it.
        # The worker runs its searches on a CUDA stream of its own, so
        # the tick's download does not queue behind the search's work.
        self.search_async = search_async
        self._search_future = None
        self._search_pool = None
        self._search_stream = None
        # >1 runs each cell's tracker tick (its get_fd + control loops)
        # on a worker pool -- the reference's thread-per-cell layout
        # (tracker_thread.cpp spawn, producer_thread.cpp:171-174).  The
        # native stages release the GIL, so cells overlap on spare
        # cores.  Off by default: the only cross-cell state is the
        # global frequency-offset register, whose update order becomes
        # scheduling-dependent -- the same benign race the reference
        # documents at tracker_thread.cpp:235-238 ("worst that will
        # happen is we lose one of many updates").
        self.parallel_cells = int(parallel_cells)
        self._cell_pool = None
        # Device-loop mode (tracker/device_loop.py): demod + CRS/special
        # extraction on the device, only the [n_rs, 12] raw-CE rows and
        # ~6% special symbol rows download.  None = auto: on for a CUDA
        # device; the CPU runs the dense path.
        self.device_loop = device_loop
        # if a dict: host wall seconds by span of the tick, summed
        # (producer, pop, stage/program/download/control and their
        # nested spans in device-loop mode, fd + control otherwise,
        # search for inline searches; utils/debug.py::stage)
        self.timings: Optional[dict] = None

    def _use_device_loop(self) -> bool:
        if self.device_loop is not None:
            return bool(self.device_loop)
        return self.device.type == "cuda"

    def _search_place(self) -> dict:
        """Where the searches run: over the search grid when there is
        one, else on the runner's device."""
        if self.search_mesh is not None:
            return {"mesh": self.search_mesh}
        return {"device": self.device}

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run the whole search/decode path once per CP type before
        streaming.

        The first acquisition search on the card builds the CUDA
        kernels (nvcc, seconds), creates the cuFFT plans and fills the
        caching allocator; in live streaming that stall would overflow
        the ingest ring and surface as dropped seconds.  One full
        cell_search over a synthetic capture of the production length
        (19200*8 samples, both CP types) at the searcher's one
        hypothesis takes them all before the stream starts.
        """
        from ..cell import CpType
        from ..sim import create_dl_sig

        n_cap = self.producer.capbuf_len
        ms = int(np.ceil(n_cap / (self.state.fs_programmed / 1000.0)))
        for cp in (CpType.NORMAL, CpType.EXTENDED):
            sig = create_dl_sig(cp, ms, 0, 0, 0, 0.0,
                                rng=np.random.default_rng(0), n_ports=2)
            capbuf = np.asarray(sig[:n_cap])
            f_set = np.array([self.state.frequency_offset])
            cell_search(capbuf, f_set, self.state.fc_requested,
                        self.state.fc_programmed, self.state.fs_programmed,
                        self.search_config, **self._search_place())

    # ------------------------------------------------------------------
    def add_cell(self, tc: TrackedCell) -> None:
        self.cells.append(tc)
        self.processors[tc.n_id_cell] = TrackedCellProcessor(tc, self.state)

    def seed_from_cell(self, cell: Cell, frame_timing: float) -> None:
        self.add_cell(TrackedCell.from_cell(cell, frame_timing))

    # ------------------------------------------------------------------
    def process_block(self, samples: np.ndarray) -> None:
        """Feed one block of complex samples through the whole graph."""
        timings = self.timings
        self._samples_fed += len(samples)
        with stage("producer", timings=timings, host=True):
            self.producer.process(samples, self.cells)

        # drive the per-cell trackers: pop each cell's pending symbols as
        # ONE struct-of-arrays chunk, run the get_fd stage (mixer + DFT +
        # phase compensation) of every cell as one batch of
        # [n_cells, n_sym, 128] tensor operations on the runner's device,
        # then the per-cell control loops.
        # The per-tick pop is capped so a backlogged fifo drains over a
        # few ticks instead of staging one huge batch (the backpressure
        # dump in the producer bounds total fifo growth).
        cap = 1024
        with stage("pop", timings=timings, host=True):
            work = []
            for tc in self.cells:
                fifo = self.producer.fifos.get(tc.n_id_cell)
                chunk = fifo.pop_upto(cap) if fifo is not None else None
                work.append((tc, fifo, chunk))
            active = [(tc, ch) for tc, _, ch in work if ch is not None]
        if active and self._use_device_loop():
            # device-loop mode: demod + CRS extraction on the device,
            # the processors' host f64 control loops run on the
            # downloaded raw-CE rows (tracker/device_loop.py; one upload
            # and one download per tick).
            # This branch must come FIRST: a processor's device-loop
            # counters (_sym_base/_emitted_base, sparse special map)
            # and the dense process() path are mutually exclusive --
            # mixing them across ticks (e.g. via the parallel_cells
            # pool on single-cell ticks) would desynchronize the
            # label arithmetic.  The device loop already batches all
            # cells into one dispatch, which is what parallel_cells
            # approximates on CPU hosts.
            from .device_loop import batched_tick_extract
            batch = [(self.processors[tc.n_id_cell], ch)
                     for tc, ch in active]
            batched_tick_extract(batch, self.state, raw_block=samples,
                                 block_seq=self.producer.block_seq,
                                 device=self.device, timings=timings)
        elif self.parallel_cells > 1 and len(active) > 1:
            from .batched import batched_get_fd

            def _cell_job(tc, chunk):
                proc = self.processors[tc.n_id_cell]
                fd = batched_get_fd([(proc, chunk)], self.state,
                                    device=self.device)[0]
                proc.process(chunk, fd_syms=fd)

            pool = self._cell_pool
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor
                pool = self._cell_pool = ThreadPoolExecutor(
                    max_workers=self.parallel_cells,
                    thread_name_prefix="cell")
            futs = [pool.submit(_cell_job, tc, ch) for tc, ch in active]
            for f in futs:
                f.result()
        else:
            if active:
                from .batched import batched_get_fd
                batch = [(self.processors[tc.n_id_cell], ch)
                         for tc, ch in active]
                # raw-block staging: the device receives THIS tick's
                # stream once + per-symbol start indices and gathers
                # every cell's windows itself
                with stage("fd", timings=timings):
                    outs = batched_get_fd(
                        batch, self.state, raw_block=samples,
                        block_seq=self.producer.block_seq,
                        device=self.device)
                with stage("control", timings=timings, host=True):
                    for (proc, ch), fd in zip(batch, outs):
                        proc.process(ch, fd_syms=fd, timings=timings)
        for tc, fifo, chunk in work:
            if fifo is not None:
                tc.fifo_depth = len(fifo)   # post-drain depth for the dash
            if tc.kill_me:
                self.cells.remove(tc)
                self.processors.pop(tc.n_id_cell)
                self.producer.drop_cell(tc.n_id_cell)

        # searcher handshake: request captures, consume them
        if self._search_enabled:
            if self._search_future is not None and self._search_future.done():
                new_cells, had_cells = self._search_future.result()
                self._search_future = None
                self._integrate_search(new_cells, had_cells)
            if self.producer.capbuf_ready and self._search_future is None:
                self.producer.capbuf_ready = False
                had_cells = bool(self.cells)
                if self.search_async:
                    capbuf = self.producer.capbuf.copy()
                    late = self.producer.capbuf_late
                    self._search_future = self._pool().submit(
                        self._search_job, capbuf, late, had_cells)
                else:
                    with stage("search", timings=timings):
                        new_cells = search_once(
                            self.producer.capbuf, self.producer.capbuf_late,
                            self.state, self.cells, self.search_config,
                            **self._search_place())
                        self._integrate_search(new_cells, had_cells)
            elif (self.producer.capture_idle()
                  and self._search_future is None and self._search_due()):
                self.producer.request_capture()

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Stop the background searcher worker (an in-flight search is
        left to finish; it is ~1 s bounded)."""
        if self._search_pool is not None:
            self._search_pool.shutdown(wait=False, cancel_futures=True)
            self._search_pool = None
            self._search_future = None
        if self._cell_pool is not None:
            self._cell_pool.shutdown(wait=True)
            self._cell_pool = None

    def _pool(self):
        if self._search_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._search_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="searcher",
                initializer=_deprioritize_thread)
        return self._search_pool

    def _search_job(self, capbuf, capbuf_late, had_cells):
        ctx = contextlib.nullcontext()
        if self.device.type == "cuda":
            if self._search_stream is None:
                self._search_stream = torch.cuda.Stream(self.device)
            ctx = torch.cuda.stream(self._search_stream)
        with ctx:
            new_cells = search_once(capbuf, capbuf_late, self.state,
                                    self.cells, self.search_config,
                                    **self._search_place())
        return new_cells, had_cells

    def _integrate_search(self, new_cells: List[TrackedCell],
                          had_cells: bool) -> None:
        if new_cells and not had_cells:
            # First acquisition doubles as the reference's kalibrate()
            # bootstrap (LTE-Tracker.cpp:565-741): seed the global FO
            # register from the strongest cell's superfine estimate.
            best = max(new_cells,
                       key=lambda t: 0 if np.isnan(t.freq_superfine)
                       else 1)
            if np.isfinite(best.freq_superfine):
                self.state.frequency_offset = best.freq_superfine
        tracked = {tc.n_id_cell for tc in self.cells}
        for tc in new_cells:
            # an async search may complete after the same cell id was
            # re-acquired (or raced a kill/re-add); keep single-tracker-
            # per-cell like the producer's registry
            if tc.n_id_cell not in tracked:
                self.add_cell(tc)
        self._last_search_at = self._samples_fed

    def _search_due(self) -> bool:
        if not self.cells or self._last_search_at is None:
            return True   # acquiring: search at full cadence
        elapsed = (self._samples_fed - self._last_search_at) \
            / self.state.fs_programmed
        floor = self.search_period
        if self.search_duty > 0:
            floor = max(floor,
                        self.state.searcher_cycle_time / self.search_duty)
        return elapsed >= floor

    def run(self, sample_blocks: Iterable[np.ndarray],
            on_block: Optional[Callable[["TrackerRunner"], None]] = None
            ) -> None:
        for block in sample_blocks:
            self.process_block(np.asarray(block))
            if on_block is not None:
                on_block(self)
