"""Per-cell tracking: demod, CE filtering, FOE/TOE feedback, MIB re-decode.

Behavioral contract: the reference tracker thread
(reference src/tracker_thread.cpp): get_fd (:91-174), filter_ce
(:176-202), do_foe (:204-243), do_toe_v2 (:245-279), do_ac_fd (:318-340),
do_ac_td (:343-370), interp72/interp2d (:372-477), pbch_extract_rt /
do_mib_decode (:494-749), do_pss_sss_sigpower_ce (:754-820), and the main
per-OFDM-symbol loop (:823-1068).

Re-design: one TrackedCellProcessor object per cell, driven by the event
loop with struct-of-arrays PDU CHUNKS (tracker/producer.py PduChunk); the
per-cell thread + FIFO/condvar machinery becomes array fifos drained once
per tick.  The per-RS-window numerics and the sequential FOE/TOE feedback
chain run in the native C++ runtime, one call per cell and tick for all
its ports (native/tracker_math.cpp cell_tick, and in device-loop mode
csrc/cell_rows_tick.cpp over the runtime's port_tick -- the reference's
tracker math is C++ too).  The runtime is required: the processor builds
it with g++ (io/native.py::load) and raises without it.  The parity
reference is the JAX package's tracker, whose numpy float64 fallbacks
mirror the reference's double math loop for loop.  The heavy demod front end
(mixer + DFT) is batched across all cells (tracker/batched.py), and in
device-loop mode the CRS extraction with it (tracker/device_loop.py,
process_device).  The control loops stay host float64 on every device."""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from ..cell import CpType
from ..constants import CELL_DROP_THRESHOLD, FS_LTE
from ..models.coding import crc_parity
from ..models.pn import lte_pn
from ..models.pss import PSS_FD
from ..models.rs import RsDl
from ..models.sss import SSS_FD
from ..utils.debug import stage
from .producer import PduChunk
from .state import GlobalState, TrackedCell


class _SoaFifo:
    """FIFO of per-symbol rows stored as struct-of-arrays chunks.

    Each append is a tuple of k same-length arrays (axis 0 = symbols);
    pops return the first n symbols re-merged.  Replaces per-symbol
    Python objects on the streaming hot path (reference ce_interp_fifo
    and data fifos, tracker_thread.cpp)."""

    __slots__ = ("chunks", "n")

    def __init__(self):
        self.chunks: Deque[Tuple[np.ndarray, ...]] = deque()
        self.n = 0

    def append(self, *arrays) -> None:
        self.chunks.append(arrays)
        self.n += arrays[0].shape[0]

    def pop_n(self, k: int) -> Tuple[np.ndarray, ...]:
        """Pop the first k symbols as one tuple of arrays."""
        parts = []
        need = k
        while need > 0:
            chunk = self.chunks[0]
            m = chunk[0].shape[0]
            if m <= need:
                parts.append(self.chunks.popleft())
                need -= m
            else:
                parts.append(tuple(a[:need] for a in chunk))
                self.chunks[0] = tuple(a[need:] for a in chunk)
                need = 0
        self.n -= k
        if len(parts) == 1:
            return parts[0]
        nf = len(parts[0])
        return tuple(np.concatenate([p[i] for p in parts])
                     for i in range(nf))


class TrackedCellProcessor:
    """Processes one tracked cell's symbol stream."""

    def __init__(self, cell: TrackedCell, state: GlobalState):
        self.cell = cell
        self.state = state
        self.rs_dl = RsDl(cell.n_id_cell, 6, cell.cp_type)
        m_bit = 1920 if cell.cp_type is CpType.NORMAL else 1728
        self.scr = lte_pn(cell.n_id_cell, m_bit)
        self.slot_num = 0
        self.sym_num = 0
        self.bulk_phase_offset = 0.0
        n_ports = cell.n_ports
        # (slots, syms, fd-symbols) awaiting interpolated CEs
        self.data_fifo = _SoaFifo()
        self.ce_interp_fifo: List[_SoaFifo] = [_SoaFifo()
                                               for _ in range(n_ports)]
        self.ce_interp_init = [False] * n_ports
        self.mib_fifo: Deque = deque()
        self.mib_fifo_synchronized = False
        self._pbch_keep = None
        # the tick's span sink (utils/debug.py::stage), given to
        # process/process_device and read by the spans nested in them
        self.timings: Optional[dict] = None
        # device-loop mode (tracker/device_loop.py): special-symbol rows
        # keyed by ABSOLUTE symbol index, plus the ingest/emit counters
        # that replace the dense data_fifo alignment
        self._spec_map = {}
        self._sym_base = 0
        self._emitted_base = 0
        self.sss_sym: Optional[np.ndarray] = None
        # cached sync-channel tables: (sss_fd slot0 f64, slot10 f64,
        # conj pss_fd)
        self._sync_tabs: Optional[tuple] = None
        # the native runtime (io/native.py), built here if it is missing;
        # without a compiler this raises
        from ..io.native import load
        self._native = load()
        # the native cell ticks' state (cell_tick, cell_rows_tick):
        # pending CRS rows, pair carry, and the ac_td history, stacked
        # per port; the shift and conjugated-RS tables are read by
        # address there and by the device loop's stager
        # (device_loop.py::stage_tick)
        self._shift_i64 = np.ascontiguousarray(self.rs_dl.shift_table,
                                               np.int64)
        self._shift_at = self._shift_i64.ctypes.data
        self._rs_conj = np.ascontiguousarray(np.conj(self.rs_dl.rs_table),
                                             np.complex128)
        self._rs_conj_at = self._rs_conj.ctypes.data
        self._alloc_pending(512)
        self._carry_ce72 = np.zeros((n_ports, 72), np.complex128)
        self._carry_scal = np.zeros((n_ports, 4))
        self._carry_label = np.zeros((n_ports, 2), np.int64)
        self._carry_valid = np.zeros(n_ports, np.int64)
        self._hist = np.zeros((n_ports, 72, 12), np.complex128)
        self._hist_pos = np.zeros(n_ports, np.int64)
        self._regs = np.zeros(2)
        self._out_meta = np.zeros(3 * n_ports, np.int64)

    def _alloc_pending(self, cap: int) -> None:
        n_ports = self.cell.n_ports
        self._pend_cap = cap
        self._pend_ce = np.zeros((n_ports, cap, 12), np.complex128)
        self._pend_shift = np.zeros((n_ports, cap), np.int64)
        self._pend_slot = np.zeros((n_ports, cap), np.int64)
        self._pend_sym = np.zeros((n_ports, cap), np.int64)
        self._pend_fo = np.zeros((n_ports, cap))
        self._pend_ft = np.zeros((n_ports, cap))
        self._pend_cnt = np.zeros(n_ports, np.int64)
        self._tick_ptrs = None

    def _grow_pending(self, cap: int) -> None:
        old = (self._pend_ce, self._pend_shift, self._pend_slot,
               self._pend_sym, self._pend_fo, self._pend_ft)
        cnt = self._pend_cnt
        self._alloc_pending(cap)
        new = (self._pend_ce, self._pend_shift, self._pend_slot,
               self._pend_sym, self._pend_fo, self._pend_ft)
        for p in range(self.cell.n_ports):
            k = int(cnt[p])
            for o, n in zip(old, new):
                n[p, :k] = o[p, :k]
        self._pend_cnt = cnt

    @property
    def rs_pending(self) -> List[Optional[Tuple[np.ndarray, ...]]]:
        """Per-port pending raw-CE rows (ce[m,12], shift, slot, sym, fo,
        ft), None before the port's first row: copies of the native
        pending buffers."""
        bufs = (self._pend_ce, self._pend_shift, self._pend_slot,
                self._pend_sym, self._pend_fo, self._pend_ft)
        return [tuple(a[p, :k].copy() for a in bufs) if k else None
                for p, k in enumerate(self._pend_cnt.tolist())]

    def _emit_rows(self, port, ce_rows, tp_rows, sp_rows, spr_rows, np_rows,
                   slot0, sym0) -> None:
        """Append interpolated rows to the port fifo, bootstrapping the
        first emission back to slot 0 sym 0 (the first emitted symbol IS
        the first pair's prev label)."""
        if not self.ce_interp_init[port]:
            self.ce_interp_init[port] = True
            boot = slot0 * self.cell.n_symb_dl() + sym0
            if boot:
                ce_rows = np.concatenate(
                    [np.broadcast_to(ce_rows[0], (boot, 72)), ce_rows])
                tp_rows = np.concatenate([np.full(boot, tp_rows[0]), tp_rows])
                sp_rows = np.concatenate([np.full(boot, sp_rows[0]), sp_rows])
                spr_rows = np.concatenate(
                    [np.full(boot, spr_rows[0]), spr_rows])
                np_rows = np.concatenate([np.full(boot, np_rows[0]), np_rows])

        self.ce_interp_fifo[port].append(ce_rows, tp_rows, sp_rows,
                                         spr_rows, np_rows)

    def _cell_tick(self, S, slots_a, syms_a, fo, ft) -> None:
        """One fused native call for the whole cell tick: per-port CRS
        extraction from the tick's fd symbols, pending-row management,
        window statistics + sequential feedback, and the pair
        time-interpolation emission (native cell_tick)."""
        S = np.ascontiguousarray(S, np.complex128)
        self._run_cell_tick(
            self._native.cell_tick, S.shape[0],
            (S.ctypes.data, *self._tick_labels(slots_a, syms_a, fo, ft),
             self._shift_at, self._rs_conj.ctypes.data))

    def _cell_rows_tick(self, ce_rows, n_rows, slots_a, syms_a, fo,
                        ft) -> None:
        """The device loop's cell tick in one native call: the raw-CE
        rows the device extracted (ce_rows [>= n_ports, NR, 12], port
        p's n_rows[p] rows first, in symbol order) appended to the
        pending rows, then the same windows, feedback and emission as
        _cell_tick (native cell_rows_tick, csrc/cell_rows_tick.cpp,
        which raises here when its own selection of a port's rows does
        not count n_rows[p])."""
        ce_rows = np.ascontiguousarray(ce_rows, np.complex128)
        self._run_cell_tick(
            self._native.cell_rows_tick, len(slots_a),
            (ce_rows.ctypes.data, ce_rows.shape[1], n_rows.ctypes.data,
             *self._tick_labels(slots_a, syms_a, fo, ft), self._shift_at),
            scal_by_field=True)

    @staticmethod
    def _tick_labels(slots_a, syms_a, fo, ft) -> tuple:
        return (np.ascontiguousarray(slots_a, np.int64).ctypes.data,
                np.ascontiguousarray(syms_a, np.int64).ctypes.data,
                np.ascontiguousarray(fo, np.float64).ctypes.data,
                np.ascontiguousarray(ft, np.float64).ctypes.data)

    def _run_cell_tick(self, entry, n_new: int, head: tuple,
                       scal_by_field: bool = False) -> None:
        """Call a native cell tick (cell_tick or cell_rows_tick, whose
        own leading arguments are ``head``) on the persistent per-port
        state, whose addresses are cached until _alloc_pending or a new
        ac_fd/ac_td array replaces one, with a fresh output buffer (the
        fifo keeps views of it); then emit each port's rows.  The
        emitted scalars come packed per row ({tp, sp, spr, np}), or per
        field with ``scal_by_field`` (cell_rows_tick)."""
        c = self.cell
        st = self.state
        n_ports = c.n_ports
        n_symb = c.n_symb_dl()
        # a cell tick leaves at most 2 rows pending on every port
        if n_new + 2 > self._pend_cap:
            cap = self._pend_cap
            while n_new + 2 > cap:
                cap *= 2
            self._grow_pending(cap)
        ptrs = self._tick_ptrs
        if ptrs is None or ptrs[0] is not c.ac_fd or ptrs[1] is not c.ac_td:
            meta_at = self._out_meta.ctypes.data
            ptrs = self._tick_ptrs = (c.ac_fd, c.ac_td, tuple(
                a.ctypes.data for a in (
                    self._pend_ce, self._pend_shift, self._pend_slot,
                    self._pend_sym, self._pend_fo, self._pend_ft,
                    self._pend_cnt, self._carry_ce72, self._carry_scal,
                    self._carry_label, self._carry_valid, c.ac_fd, c.ac_td,
                    self._hist, self._hist_pos, self._regs)),
                (meta_at, meta_at + 8 * n_ports))
        # one fresh buffer: out_ce [P, cap_out, 72], then out_scal
        # {tp, sp, spr, np} as [P, cap_out, 4] (or [P, 4, cap_out],
        # viewed as the former)
        cap_out = n_new + 4 * n_symb + 8
        n_ce = n_ports * cap_out * 144
        out = np.empty(n_ce + n_ports * cap_out * 4)
        out_ce = out[:n_ce].view(np.complex128).reshape(n_ports, cap_out, 72)
        if scal_by_field:
            out_scal = out[n_ce:].reshape(n_ports, 4, cap_out).transpose(
                0, 2, 1)
        else:
            out_scal = out[n_ce:].reshape(n_ports, cap_out, 4)
        at = out.ctypes.data
        regs = self._regs
        regs[0] = st.frequency_offset
        regs[1] = c.frame_timing
        r = entry(
            n_new, *head, n_ports, n_symb, int(c.cp_type is CpType.EXTENDED),
            FS_LTE, st.fc_requested, st.fc_programmed, st.fs_programmed,
            self._pend_cap, *ptrs[2], cap_out, at, at + 8 * n_ce, *ptrs[3])
        if r < 0:
            raise RuntimeError("native cell tick: capacity exceeded or "
                               "a port's rows miscounted")
        st.frequency_offset = float(regs[0])
        c.frame_timing = float(regs[1])
        meta = self._out_meta.tolist()      # out_cnt [P], out_label0 [P, 2]
        for p in range(n_ports):
            w = meta[p]
            if w:
                self._emit_rows(p, out_ce[p, :w], out_scal[p, :w, 0],
                                out_scal[p, :w, 1], out_scal[p, :w, 2],
                                out_scal[p, :w, 3], meta[n_ports + 2 * p],
                                meta[n_ports + 2 * p + 1])

    # ------------------------------------------------------------------
    def _do_pss_sss_sigpower_ce(self, syms, slot_num, sym_num) -> None:
        c = self.cell
        n_symb = c.n_symb_dl()
        if slot_num not in (0, 10) or sym_num not in (n_symb - 2, n_symb - 1):
            return
        if sym_num == n_symb - 2:
            self.sss_sym = syms
            return
        if self.sss_sym is None:
            return
        sss_sym = self.sss_sym
        pss_sym = syms
        tabs = self._sync_tabs
        if tabs is None:
            tabs = self._sync_tabs = (
                np.ascontiguousarray(SSS_FD()[c.n_id_1, c.n_id_2, 0],
                                     np.float64),
                np.ascontiguousarray(SSS_FD()[c.n_id_1, c.n_id_2, 1],
                                     np.float64),
                np.ascontiguousarray(np.conj(PSS_FD()[c.n_id_2])))
        sss_tab = tabs[0 if slot_num == 0 else 1]
        sss_c = np.ascontiguousarray(sss_sym)
        pss_c = np.ascontiguousarray(pss_sym)
        scal = np.empty(4)
        ce_smooth = np.empty(62, np.complex128)
        self._native.sync_snr(
            sss_c.ctypes.data, pss_c.ctypes.data, sss_tab.ctypes.data,
            tabs[2].ctypes.data, scal.ctypes.data, ce_smooth.ctypes.data)
        tp, sp, np_est, np_blank = scal
        c.sync_tp, c.sync_sp, c.sync_np, c.sync_np_blank = \
            tp, sp, np_est, np_blank
        c.sync_ce = np.concatenate([np.zeros(5), ce_smooth, np.zeros(5)])
        if np.isnan(c.sync_sp_av):
            c.sync_tp_av, c.sync_sp_av = tp, sp
            c.sync_np_av, c.sync_np_blank_av = np_est, np_blank
        else:
            c.sync_tp_av = 0.999 * c.sync_tp_av + 0.001 * tp
            c.sync_sp_av = 0.999 * c.sync_sp_av + 0.001 * sp
            c.sync_np_av = 0.999 * c.sync_np_av + 0.001 * np_est
            c.sync_np_blank_av = 0.999 * c.sync_np_blank_av + 0.001 * np_blank

    # ------------------------------------------------------------------
    def _mib_try_decode(self) -> bool:
        """Attempt the 4-frame blind MIB re-decode once 16 PBCH symbols
        are queued; returns False if the cell should be dropped
        (reference do_mib_decode, tracker_thread.cpp:531-749).  Each
        attempt counts in the cell's ``mib_redecodes`` and is the span
        "control.mib"."""
        if len(self.mib_fifo) != 16:
            return True
        self.cell.mib_redecodes += 1
        with stage("control.mib", timings=self.timings, host=True):
            return self._mib_decode()

    def _mib_decode(self) -> bool:
        from ..models.coding import (conv_decode_tailbite_host,
                                     conv_deratematch_host)
        from ..models.modulation import lte_demodulate_host

        c = self.cell
        n_ports = c.n_ports
        v3 = c.n_id_cell % 3
        n_symb = c.n_symb_dl()
        keep = self._pbch_keep
        if keep is None:
            # [16, 72] RE-selection mask: skip possible-RS positions
            # (sc % 3 == v_shift_m3) in CRS-bearing symbols
            symn = np.arange(16) % 4
            rs_sym = (symn <= 1) | ((symn == 3) & (n_symb == 6))
            keep = ~(rs_sym[:, None]
                     & (np.arange(72)[None, :] % 3 == v3))
            keep = self._pbch_keep = keep.reshape(-1)
        syms16 = np.stack([e[0] for e in self.mib_fifo])     # [16, 72]
        ce16 = np.stack([e[1] for e in self.mib_fifo])       # [16, P, 72]
        np16 = np.stack([e[3] for e in self.mib_fifo])       # [16, P]
        pbch_sym = syms16.reshape(-1)[keep]
        pbch_ce = ce16.transpose(1, 0, 2).reshape(n_ports, -1)[:, keep]
        pbch_np = np.repeat(np16.T, 72, axis=1)[:, keep]

        if n_ports == 1:
            h = pbch_ce[0]
            gain = np.conj(h / np.abs(h) ** 2)
            syms_mib = pbch_sym * gain
            np_mib = pbch_np[0] * np.abs(gain) ** 2
        else:
            x1 = pbch_sym[0::2]
            x2 = pbch_sym[1::2]
            if n_ports == 2:
                h1 = (pbch_ce[0, 0::2] + pbch_ce[0, 1::2]) / 2
                h2 = (pbch_ce[1, 0::2] + pbch_ce[1, 1::2]) / 2
                np_t = (pbch_np[0, 0::2] + pbch_np[1, 0::2]) / 2
            else:
                even = np.arange(len(x1)) % 2 == 0
                h1 = np.where(even, (pbch_ce[0, 0::2] + pbch_ce[0, 1::2]) / 2,
                              (pbch_ce[1, 0::2] + pbch_ce[1, 1::2]) / 2)
                h2 = np.where(even, (pbch_ce[2, 0::2] + pbch_ce[2, 1::2]) / 2,
                              (pbch_ce[3, 0::2] + pbch_ce[3, 1::2]) / 2)
                np_t = np.where(even,
                                (pbch_np[0, 0::2] + pbch_np[2, 0::2]) / 2,
                                (pbch_np[1, 0::2] + pbch_np[3, 0::2]) / 2)
            scale = np.abs(h1) ** 2 + np.abs(h2) ** 2
            s1 = (np.conj(h1) * x1 + h2 * np.conj(x2)) / scale
            s2 = np.conj((-np.conj(h2) * x1 + h1 * np.conj(x2)) / scale)
            syms_mib = np.stack([s1, s2], 1).reshape(-1) * np.sqrt(2)
            np_pair = (np.abs(h1) / scale) ** 2 * np_t \
                + (np.abs(h2) / scale) ** 2 * np_t
            np_mib = np.stack([np_pair, np_pair], 1).reshape(-1)

        # host decode chain (numpy log-MAP demod, cached-plan
        # de-ratematch, native tail-biting Viterbi): this runs
        # every 40 ms per cell on one codeword, where per-step tensor
        # dispatch would outweigh the math (the scanner's batched blind
        # decode stays on tensors, models/mib.py)
        e_est = lte_demodulate_host(syms_mib, np_mib, "qpsk")
        e_est = e_est * (1.0 - 2.0 * self.scr.astype(np.float64))
        d_est = conv_deratematch_host(e_est, 40)
        c_est = conv_decode_tailbite_host(d_est)
        c.mib_bits = c_est[:24].astype(np.uint8)
        crc_est = crc_parity(c.mib_bits, "crc16")
        if n_ports == 2:
            crc_est = crc_est ^ 1
        elif n_ports == 4:
            crc_est = crc_est ^ np.tile([0, 1], 8)

        bw_map = {0: 6, 1: 15, 2: 25, 3: 50, 4: 75, 5: 100}
        bw = int(c_est[0] * 4 + c_est[1] * 2 + c_est[2])
        n_rb_ok = bw_map.get(bw, 0) == c.n_rb_dl
        phich_dur_ok = bool(c_est[3]) == \
            (c.phich_duration.value == "extended")
        res = int(c_est[4] * 2 + c_est[5])
        res_ok = res == {"1/6": 0, "1/2": 1, "one": 2, "two": 3}[
            c.phich_resource.value]

        if np.array_equal(crc_est, c_est[24:40]) and n_rb_ok \
                and phich_dur_ok and res_ok:
            self.mib_fifo_synchronized = True
            c.mib_passes += 1
            c.mib_decode_failures = 0.0
            for _ in range(16):
                self.mib_fifo.popleft()
        elif self.mib_fifo_synchronized:
            c.mib_decode_failures += 1
            for _ in range(16):
                self.mib_fifo.popleft()
        else:
            c.mib_decode_failures += 0.25
            for _ in range(4):
                self.mib_fifo.popleft()

        if c.mib_decode_failures >= CELL_DROP_THRESHOLD:
            c.kill_me = True
            return False
        return True

    # ------------------------------------------------------------------
    def process(self, chunk: Optional[PduChunk],
                fd_syms: Optional[np.ndarray],
                timings: Optional[dict] = None) -> None:
        """Consume one tick's symbol-PDU chunk (one reference loop
        iteration per symbol, tracker_thread.cpp:856-1067).

        fd_syms carries the frequency-domain symbols of the whole chunk
        [n_pdus, 72], from the batched get_fd (tracker/batched.py).
        ``timings``: the spans "control.phase_c" and, nested in it,
        "control.mib" (utils/debug.py::stage).
        """
        self.timings = timings
        c = self.cell
        n_symb_dl = c.n_symb_dl()

        # Phases A+B -- ingest the tick's PDUs: frequency-domain symbols
        # into data_fifo; then one native call (_cell_tick) for the CRS
        # extraction into the per-port pending rows, every complete RS
        # 3-window with its feedback, and the pair interpolation.  The
        # (slot, sym) labels are a running symbol counter.
        n_new = 0 if chunk is None else len(chunk)
        if n_new and not c.kill_me:
            start = self.slot_num * n_symb_dl + self.sym_num
            k = start + np.arange(n_new)
            slots_a = (k // n_symb_dl) % 20
            syms_a = k % n_symb_dl
            end = start + n_new
            self.slot_num = (end // n_symb_dl) % 20
            self.sym_num = end % n_symb_dl
            S = np.asarray(fd_syms)
            if S.shape != (n_new, 72):
                raise ValueError(f"fd_syms {S.shape} for {n_new} symbols")
            self.data_fifo.append(slots_a, syms_a, S)
            self._cell_tick(S, slots_a, syms_a, chunk.fo, chunk.ft)

        # Phase C -- pair data symbols with interpolated CEs: dashboard
        # measurements, sync-channel SNR, and the 40 ms MIB re-decode.
        # All ready symbols are popped as arrays; per-symbol Python work
        # happens only at the rare special symbols (EMA updates at slots
        # 0/10 syms 5/6, PSS/SSS SNR at the half-frame boundaries, PBCH
        # appends at slot 1 syms 0-3), selected by mask.
        n_ready = self.data_fifo.n
        for f in self.ce_interp_fifo:
            n_ready = min(n_ready, f.n)
        if n_ready <= 0 or c.kill_me:
            return
        slots, symsn, S_rdy = self.data_fifo.pop_n(n_ready)
        self._phase_c(n_ready, slots, symsn, lambda i: S_rdy[i])

    def _phase_c(self, n_ready: int, slots, symsn, row_of) -> None:
        """Dashboard measurements, sync SNR and MIB appends over
        n_ready emitted symbols.  row_of(i) returns symbol i's
        frequency-domain row -- dense callers index the popped
        data-fifo slab; the device-loop caller looks up the sparse
        special-row map (only sync/PBCH indices are ever requested).
        The span "control.phase_c"."""
        with stage("control.phase_c", timings=self.timings, host=True):
            c = self.cell
            per_port = [f.pop_n(n_ready) for f in self.ce_interp_fifo]
            ce_p = [pp[0] for pp in per_port]                  # each [n, 72]
            # per-port scalar tracks stay as lists of [n] arrays; full
            # [n_ports, n] matrices are never needed -- only single columns
            # at the rare special symbols below (lazy gathers beat 4 stacks
            # per tick on the hot path)
            tp_p = [pp[1] for pp in per_port]
            sp_p = [pp[2] for pp in per_port]
            spr_p = [pp[3] for pp in per_port]
            np_p = [pp[4] for pp in per_port]

            def col(track, i):
                return np.array([a[i] for a in track])

            # instant dashboard registers carry the LAST processed symbol
            c.ce = np.stack([cep[-1] for cep in ce_p])
            c.crs_sp_raw = col(spr_p, -1)
            c.crs_np = col(np_p, -1)

            first_init = c.crs_sp_raw_av is None
            if first_init:
                c.crs_tp_av = col(tp_p, 0)
                c.crs_sp_raw_av = col(spr_p, 0)
                c.crs_np_av = col(np_p, 0)
            ema = ((slots == 0) | (slots == 10)) \
                & ((symsn == 5) | (symsn == 6))
            for i in np.nonzero(ema)[0]:
                if first_init and i == 0:
                    continue   # the init symbol itself takes no EMA step
                c.crs_tp_av = 0.999 * c.crs_tp_av + 0.001 * col(tp_p, i)
                c.crs_sp_raw_av = 0.999 * c.crs_sp_raw_av \
                    + 0.001 * col(spr_p, i)
                c.crs_np_av = 0.999 * c.crs_np_av + 0.001 * col(np_p, i)

            n_symb = c.n_symb_dl()
            sync = ((slots == 0) | (slots == 10)) \
                & ((symsn == n_symb - 2) | (symsn == n_symb - 1))
            pbch = (slots == 1) & (symsn <= 3)
            for i in np.nonzero(sync | pbch)[0]:
                sl, sy = int(slots[i]), int(symsn[i])
                dsyms = row_of(i)
                if sync[i]:
                    self._do_pss_sss_sigpower_ce(dsyms, sl, sy)
                if pbch[i]:
                    self.mib_fifo.append(
                        (dsyms, np.stack([cep[i] for cep in ce_p]),
                         col(sp_p, i), col(np_p, i)))
                    if len(self.mib_fifo) == 16 and not self._mib_try_decode():
                        return

    # ------------------------------------------------------------------
    def process_device(self, chunk: Optional[PduChunk], slots_a, syms_a,
                       rs_sel, ce_rows, spec_sel, spec_rows,
                       final_phase: float,
                       timings: Optional[dict] = None) -> None:
        """Device-loop tick (tracker/device_loop.py): the demod + CRS
        extraction already ran on device -- consume the downloaded
        raw-CE rows (ce_rows [>= n_ports, NR, 12]: port p's first
        len(rs_sel[p]) rows) and the sparse special-symbol rows, then
        run the UNCHANGED host f64 control loops (window statistics,
        sequential FOE/frame-timing feedback, CE interpolation: one
        native cell_rows_tick for all ports) and the sparse Phase C.

        slots_a/syms_a/rs_sel/spec_sel are the planner's
        structural arrays for this tick (label arithmetic identical to
        process(); the planner read the counters, this advances them).
        ``timings``: the spans "control.rs" (the RS-window chain of
        every port), "control.phase_c" and, nested in it, "control.mib"
        (utils/debug.py::stage).
        """
        self.timings = timings
        c = self.cell
        n_new = 0 if chunk is None else len(chunk)
        if n_new and not c.kill_me:
            self.bulk_phase_offset = float(final_phase)
            n_symb = c.n_symb_dl()
            end = self.slot_num * n_symb + self.sym_num + n_new
            self.slot_num = (end // n_symb) % 20
            self.sym_num = end % n_symb
            for j, i in enumerate(spec_sel):
                self._spec_map[self._sym_base + int(i)] = spec_rows[j]
            self._sym_base += n_new
            with stage("control.rs", timings=timings, host=True):
                n_rows = np.fromiter(map(len, rs_sel), np.int64, c.n_ports)
                self._cell_rows_tick(ce_rows, n_rows, slots_a, syms_a,
                                     chunk.fo, chunk.ft)

        # sparse Phase C: labels recomputed from the absolute emitted-
        # row counter (emitted row j corresponds to absolute symbol j,
        # the _emit_rows bootstrap invariant); symbol rows exist only at
        # the special indices, exactly the ones _phase_c reads
        n_ready = min((f.n for f in self.ce_interp_fifo), default=0)
        if n_ready <= 0 or c.kill_me:
            return
        base = self._emitted_base
        n_symb = c.n_symb_dl()
        k = base + np.arange(n_ready)
        slots = (k // n_symb) % 20
        symsn = k % n_symb
        self._emitted_base = base + n_ready
        self._phase_c(n_ready, slots, symsn,
                      lambda i: self._spec_map.pop(base + i))
        # _phase_c can return mid-batch (a failed MIB decode at the
        # 16-PDU boundary); entries whose absolute index is already
        # below the advanced emit counter will never be requested --
        # prune them so repeated decode failures cannot leak rows
        if self._spec_map:
            for key in [key for key in self._spec_map
                        if key < self._emitted_base]:
                del self._spec_map[key]
