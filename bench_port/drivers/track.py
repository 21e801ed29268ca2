"""The streaming tracker through ``tracker/runner.py::TrackerRunner``.

Set-up makes the stream's seamless loop from the seed and builds the
runner as ``tools_torch/bench_tracker.py`` does (the device loop on the
card, the searcher inline at the configuration's cadence while it
acquires), for the
programmed frequency, which the configuration puts 200 Hz below the
requested one so that the runner's crystal model (k_factor 1 at the
stream's offset) matches the stream's exact sample clock.  It runs the
runner's warm-up and feeds the stream until every cell of the plan is
tracked (at most ``acq_s`` of stream), then ``settle_s`` more so the
last cell reaches MIB sync.  Where the configuration keeps the searcher
out of the window (``searcher.in_window`` false), no search is asked
for after acquisition and the one under way finishes before the
window.  A step is one ``process_block`` of
``block`` samples, the loop replayed as long as the window lasts.

Over the window the driver watches, without changing them, the
program's MIB re-decodes (each cell's, with the 24 bits it decoded and
whether it passed), its dropped-seconds counters and, on ticks drawn
from the seed, the tick's inputs and outputs, for the reference.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np

from bench_port import gen, harness
from bench_port.reference import judge_tracker

TICKS_KEPT = 8


def _host(t):
    return None if t is None else t.detach().cpu().numpy()


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        from lte_cell_scanner_tpu_torch.tracker import TrackerRunner
        t0 = time.perf_counter()
        self.cfg = cfg
        s = cfg["stream"]
        self.fc = s["fc_hz"]
        self.block = traffic["block"]
        self.traffic = traffic
        self.seed = seed
        self.loop = gen.tracker_loop(seed, cfg)
        self.split = {"stream s": time.perf_counter() - t0}
        self.truth = gen.tracker_cells(cfg)
        self.pos = 0
        self.fed = 0      # stream samples handed to the program
        self.device = device
        srch = cfg["searcher"]
        self.runner = TrackerRunner(
            self.fc, s["fc_programmed_hz"], gen.FS, device=device,
            search_period=srch["period_s"], search_duty=srch["duty"],
            device_loop=True)
        self._counting = False

    def _next(self) -> np.ndarray:
        n, p = len(self.loop), self.pos
        if p + self.block <= n:
            out = self.loop[p: p + self.block]
        else:
            out = np.concatenate([self.loop[p:],
                                  self.loop[: p + self.block - n]])
        self.pos = (p + self.block) % n
        self.fed += self.block
        return out

    def warm(self):
        t0 = time.perf_counter()
        self.runner.warmup()
        t1 = time.perf_counter()
        limit = int(self.traffic["acq_s"] * gen.FS)
        fed = 0
        while len(self.runner.cells) < len(self.truth) and fed < limit:
            self.runner.process_block(self._next())
            fed += self.block
        if not self.cfg["searcher"]["in_window"]:
            # no search requested after acquisition; the settling stretch
            # finishes one already under way
            self.runner.search_period = math.inf
        for _ in range(int(self.traffic["settle_s"] * gen.FS) // self.block):
            self.runner.process_block(self._next())
        while not self.runner.producer.capture_idle() and fed < limit:
            self.runner.process_block(self._next())
            fed += self.block
        harness.sync(self.device)
        self.split.update({"warm-up s": t1 - t0,
                           "acquisition s": time.perf_counter() - t1,
                           "acquisition stream s": fed / gen.FS})

    # -- the window's watch ------------------------------------------
    def begin(self):
        """Start watching: the counters' values now, a watch on each
        tracked cell's MIB re-decode, and on the tick's staging and
        device program."""
        from lte_cell_scanner_tpu_torch.tracker import (cell_tracker,
                                                        device_loop)
        r = self.runner
        st = r.state
        self._start = (self.fed, st.cell_seconds_dropped,
                       st.raw_seconds_dropped)
        self.decodes = {}
        self._bits = None
        for cid, proc in r.processors.items():
            self._watch_mib(proc, self.decodes.setdefault(cid, []))
        self._crc = cell_tracker.crc_parity
        self._stage = device_loop.stage_tick
        self._prog = device_loop._tick_program
        drv = self

        def crc(a, kind):
            drv._bits = np.array(a, dtype=np.uint8)
            return drv._crc(a, kind)

        def stage(*a, **k):
            args, plans, shape = drv._stage(*a, **k)
            drv._staged = (a[0], plans, shape)
            return args, plans, shape

        def program(*args):
            out = drv._prog(*args)
            if drv._counting:
                drv._sample_tick(args, out)
            return out

        cell_tracker.crc_parity = crc
        device_loop.stage_tick = stage
        device_loop._tick_program = program
        self._rnd = random.Random(self.seed)
        self._ticks_seen = 0
        self.ticks = []
        self._counting = True

    def _watch_mib(self, proc, decodes):
        drv = self

        def watched():
            before = len(proc.mib_fifo)
            drv._bits = None
            ok = type(proc)._mib_try_decode(proc)
            if drv._counting and before == 16:
                passed = bool(ok) and proc.mib_fifo_synchronized \
                    and proc.cell.mib_decode_failures == 0 \
                    and len(proc.mib_fifo) == before - 16
                decodes.append((drv.fed, passed, drv._bits))
            return ok
        proc._mib_try_decode = watched

    def _sample_tick(self, args, out):
        """Keep TICKS_KEPT ticks of the window, drawn evenly from the seed
        (reservoir sampling): the inputs the reference needs, the
        output, and the cells' labels."""
        n = self._ticks_seen
        self._ticks_seen += 1
        slot = n if n < TICKS_KEPT else self._rnd.randrange(n + 1)
        if slot >= TICKS_KEPT:
            return
        cell_pdus, plans, shape = self._staged
        cells, n_rs, n_spec = [], [], []
        for (proc, _chunk), (slots, syms, _sh, rs_sel, spec_sel) in zip(
                cell_pdus, plans):
            c = proc.cell
            cells.append((c.n_id_cell, c.n_ports, c.n_symb_dl() == 7,
                          slots, syms))
            n_rs.append([len(s) for s in rs_sel])
            n_spec.append(len(spec_sel))
        rec = {"args": args, "out": out, "shape": shape, "cells": cells,
               "n_rs": n_rs, "n_spec": n_spec}
        if slot < len(self.ticks):
            self.ticks[slot] = rec
        else:
            self.ticks.append(rec)

    def end(self):
        """Stop watching: the window's counts, the sampled ticks on the
        host, and the tracked state at the close."""
        from lte_cell_scanner_tpu_torch.tracker import (cell_tracker,
                                                        device_loop)
        self._counting = False
        cell_tracker.crc_parity = self._crc
        device_loop.stage_tick = self._stage
        device_loop._tick_program = self._prog
        for proc in self.runner.processors.values():
            proc.__dict__.pop("_mib_try_decode", None)
        r = self.runner
        st = r.state
        fed0, cell0, raw0 = self._start
        ticks = []
        for rec in self.ticks:
            a = rec.pop("args")
            planes, data, starts, fln, phase = (_host(x) for x in a[:5])
            ticks.append(dict(
                rec, out=_host(rec["out"]).astype(np.float64),
                planes=None if planes is None else planes.astype(np.float64),
                data=None if data is None else data.astype(np.float64),
                starts=starts, fln=fln.astype(np.float64),
                init_phase=phase.astype(np.float64), fc_requested=a[5],
                fc_programmed=a[6], fs_programmed=a[7]))
        self.window = {"samples": self.fed - fed0,
                       "decodes": self.decodes,
                       "cell_seconds_dropped": st.cell_seconds_dropped - cell0,
                       "raw_seconds_dropped": st.raw_seconds_dropped - raw0,
                       "ticks": ticks}
        self.ticks = []
        self.close = {
            "frequency_offset": st.frequency_offset,
            "tracked": [
                {"n_id_cell": tc.n_id_cell, "cp": tc.cp_type.value,
                 "n_ports": tc.n_ports, "n_rb_dl": tc.n_rb_dl,
                 "phich": (tc.phich_duration.value,
                           tc.phich_resource.value),
                 "mib_synced": bool(r.processors[tc.n_id_cell]
                                    .mib_fifo_synchronized),
                 "kill_me": bool(tc.kill_me),
                 "frame_timing": float(tc.frame_timing)}
                for tc in r.cells]}

    # -- the run -----------------------------------------------------
    def step(self, timings):
        self.runner.timings = timings
        self.runner.process_block(self._next())
        return self.block

    def profile_steps(self):
        return int(self.traffic["profile_s"] * gen.FS) // self.block

    def end_to_end(self, units, wall, steps):
        return {"realtime_factor": units / gen.FS / wall}

    def shapes(self):
        return {"fs": gen.FS}

    def release(self):
        self.runner.close()

    def judge(self, guarantees):
        """The window's work and the tracker's state at its close."""
        return judge_tracker(self.close, self.window, self.truth,
                             self.cfg["stream"]["f_off_hz"], self.fc,
                             guarantees)
