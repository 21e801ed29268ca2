"""Whole tracker runs of the port (lte_cell_scanner_tpu_torch/tracker/)
against the TPU package's, on the CPU.

The stream of tests/test_tracker.py:23-35 (seed 11, 400 ms, cell 277 at
+300 Hz, 5 dB SNR, 10000-sample blocks) runs through both packages'
``TrackerRunner``: on the host path (the port's CPU demod, float64) and
with ``device_loop=True`` (the port on ``device="cpu"``).  Each pair is
held to the TPU package's own device-loop tolerances
(tests/test_tracker.py:917-930): the cell set equal, frame_timing within
1e-6, frequency_offset within rtol 1e-9 / atol 1e-6, mib_decode_failures
equal, the sync and CRS averages within rtol 1e-7, ac_fd and ce within
rtol 1e-6 / atol 1e-9.  Then the structural cases through the device
loop (a 4-port cell and an extended-CP cell), the bucketed shapes (the
same trajectory with every bucket set to 1), the asynchronous searcher,
the per-cell worker pool against the serial run, cell drop, backpressure, and the card as the default device.
The tick's spans (utils/debug.py::stage): every key in ``timings``,
nested spans within their parent, host spans as profiler ranges; and the
cells' MIB re-decode counters against a watch of the re-decodes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.sim import apply_freq_offset, awgn, create_dl_sig
from lte_cell_scanner_tpu.tracker import TrackerRunner as JRunner
from lte_cell_scanner_tpu.tracker.state import TrackedCell as JTrackedCell
from lte_cell_scanner_tpu_torch.constants import CELL_DROP_THRESHOLD
from lte_cell_scanner_tpu_torch.interop import tracked_cell_from_fields
from lte_cell_scanner_tpu_torch.tracker import TrackerRunner
from lte_cell_scanner_tpu_torch.tracker import batched as tb
from lte_cell_scanner_tpu_torch.tracker import cell_tracker as tct
from lte_cell_scanner_tpu_torch.tracker import device_loop as tdl
from lte_cell_scanner_tpu_torch.tracker.producer import Producer
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState

FS = 1.92e6
FC = 739e6
F_OFF = 300.0


def _stream(seed=11, cp=JCpType.NORMAL, n_id_1=92, n_ports=2, sfn=4,
            snr=5.0, ms=400):
    rng = np.random.default_rng(seed)
    sig = create_dl_sig(cp, ms, 0, n_id_1, 1, 0.4, rng=rng, n_ports=n_ports,
                        sfn=sfn)
    return awgn(apply_freq_offset(sig, F_OFF), snr, rng=rng)


def _feed(runner, sig, block=10000):
    for i in range(0, len(sig), block):
        runner.process_block(sig[i: i + block])
    return runner


@pytest.fixture(scope="module")
def sig():
    return _stream()


@pytest.fixture(scope="module")
def runs(sig):
    """{device_loop: (TPU package's runner, the port's runner)}."""
    return {dl: (_feed(JRunner(FC, FC, FS, device_loop=dl), sig),
                 _feed(TrackerRunner(FC, FC, FS, device_loop=dl,
                                     device="cpu"), sig))
            for dl in (False, True)}


def _assert_same_run(ref, got):
    assert sorted(c.n_id_cell for c in got.cells) == \
        sorted(c.n_id_cell for c in ref.cells)
    assert np.isclose(got.state.frequency_offset,
                      ref.state.frequency_offset, rtol=1e-9, atol=1e-6)
    by_id = {c.n_id_cell: c for c in ref.cells}
    for tg in got.cells:
        tr = by_id[tg.n_id_cell]
        assert (tg.n_ports, tg.cp_type.value, tg.n_rb_dl) == \
            (tr.n_ports, tr.cp_type.value, tr.n_rb_dl)
        assert np.isclose(tg.frame_timing, tr.frame_timing, rtol=0,
                          atol=1e-6)
        assert tg.mib_decode_failures == tr.mib_decode_failures
        assert np.isclose(tg.sync_sp_av, tr.sync_sp_av, rtol=1e-7)
        assert np.isclose(tg.sync_np_av, tr.sync_np_av, rtol=1e-7)
        assert np.allclose(tg.crs_sp_raw_av, tr.crs_sp_raw_av, rtol=1e-7)
        assert np.allclose(tg.crs_np_av, tr.crs_np_av, rtol=1e-7)
        assert np.allclose(tg.ac_fd, tr.ac_fd, rtol=1e-6, atol=1e-9)
        assert np.allclose(tg.ce, tr.ce, rtol=1e-6, atol=1e-9)
        assert got.processors[tg.n_id_cell].mib_fifo_synchronized == \
            ref.processors[tr.n_id_cell].mib_fifo_synchronized


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["host-path", "device-loop"])
def test_whole_run_matches_tpu_package(runs, device_loop):
    ref, got = runs[device_loop]
    assert got._use_device_loop() == device_loop
    _assert_same_run(ref, got)
    assert [c.n_id_cell for c in got.cells] == [277]
    tc = got.cells[0]
    assert got.processors[277].mib_fifo_synchronized
    assert tc.health_pct() > 99.0
    assert abs(got.state.frequency_offset - F_OFF) < 50.0


def test_device_loop_matches_dense_path(runs):
    """The port's two paths agree with each other as the TPU package's
    do (tests/test_tracker.py:894-930)."""
    _assert_same_run(runs[False][1], runs[True][1])


@pytest.mark.parametrize("cp,n_ports,n_id_1,want_id", [
    (JCpType.NORMAL, 4, 100, 301), (JCpType.EXTENDED, 2, 92, 277)],
    ids=["four-port", "extended-cp"])
def test_device_loop_structural_cases(cp, n_ports, n_id_1, want_id):
    """A 4-port cell (CRS on ports 2/3 only in symbol 1: four port rows
    in the plan) and an extended-CP cell (6-symbol slots, 160-sample
    framing) through both packages' device loops
    (tests/test_tracker.py:934-960)."""
    sig = _stream(31, cp, n_id_1, n_ports, sfn=12, snr=10.0)
    ref = _feed(JRunner(FC, FC, FS, device_loop=True), sig)
    got = _feed(TrackerRunner(FC, FC, FS, device_loop=True, device="cpu"),
                sig)
    _assert_same_run(ref, got)
    assert len(got.cells) == 1
    tc = got.cells[0]
    assert (tc.n_id_cell, tc.n_ports, tc.cp_type.value) == \
        (want_id, n_ports, cp.value)
    assert got.processors[want_id].mib_fifo_synchronized
    assert tc.health_pct() > 99.0


def test_bucketed_shapes_change_no_output(runs, sig, monkeypatch):
    """Every bucket set to 1 (no padding rows, no guard-window padding
    of the raw block beyond one window): the device loop's trajectory
    is identical to the bucketed run's."""
    monkeypatch.setattr(tb, "_BUCKET", 1)
    monkeypatch.setattr(tb, "_EXT_BUCKET", 1)
    monkeypatch.setattr(tdl, "_RS_BUCKET", 1)
    got = _feed(TrackerRunner(FC, FC, FS, device_loop=True, device="cpu"),
                sig)
    ref = runs[True][1]
    assert got.state.frequency_offset == ref.state.frequency_offset
    for tg, tr in zip(got.cells, ref.cells):
        for f in ("frame_timing", "mib_decode_failures", "sync_sp_av",
                  "sync_np_av", "crs_sp_raw_av", "crs_np_av", "ac_fd",
                  "ac_td", "ce"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(tr, f),
                                          err_msg=f)
        assert got.processors[tg.n_id_cell].bulk_phase_offset == \
            ref.processors[tr.n_id_cell].bulk_phase_offset


@pytest.fixture(scope="module")
def watched(sig):
    """A device-loop run with its spans in ``runner.timings`` and every
    MIB re-decode watched as the benchmark's tracker cell watches it: the
    method through each processor's instance attribute, the 24 bits
    through ``cell_tracker.crc_parity``.  Returns (runner, {cell id:
    [(passed, bits)]})."""
    crc = tct.crc_parity
    bits = [None]

    def crc_watch(a, kind):
        bits[0] = np.array(a, dtype=np.uint8)
        return crc(a, kind)

    def watch(proc, out):
        def watched_decode():
            before = len(proc.mib_fifo)
            bits[0] = None
            ok = type(proc)._mib_try_decode(proc)
            if before == 16:
                out.append((bool(ok) and proc.mib_fifo_synchronized
                            and proc.cell.mib_decode_failures == 0
                            and len(proc.mib_fifo) == before - 16,
                            bits[0]))
            return ok
        proc._mib_try_decode = watched_decode

    runner = TrackerRunner(FC, FC, FS, device_loop=True, device="cpu")
    runner.timings = {}
    decodes = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tct, "crc_parity", crc_watch)
        for i in range(0, len(sig), 10000):
            runner.process_block(sig[i: i + 10000])
            for cid, proc in runner.processors.items():
                if cid not in decodes:
                    watch(proc, decodes.setdefault(cid, []))
    return runner, decodes


def test_tick_timings_cover_the_tick(watched):
    runner, _ = watched
    assert set(runner.timings) == {
        "producer", "pop", "stage", "program", "download", "control",
        "search", "control.rs", "control.phase_c", "control.mib",
        "stage.inputs", "stage.plan", "stage.upload", "program.launch"}
    assert all(v > 0 for v in runner.timings.values())


@pytest.mark.parametrize("parent, children", [
    ("control", ("control.rs", "control.phase_c")),
    ("control.phase_c", ("control.mib",)),
    ("stage", ("stage.inputs", "stage.plan", "stage.upload")),
    ("program", ("program.launch",))])
def test_nested_spans_fit_in_their_parent(watched, parent, children):
    t = watched[0].timings
    assert 0 < sum(t[c] for c in children) <= t[parent]


def test_mib_counters_match_a_watch_of_the_redecodes(watched):
    """The program's own count of its MIB re-decodes, of those that
    passed and of the last one's bits, against the benchmark's watch."""
    runner, decodes = watched
    assert [c.n_id_cell for c in runner.cells] == [277]
    for tc in runner.cells:
        seen = decodes[tc.n_id_cell]
        assert tc.mib_redecodes == len(seen) > 0
        assert tc.mib_passes == sum(ok for ok, _ in seen) > 0
        np.testing.assert_array_equal(tc.mib_bits, seen[-1][1])
        assert tc.mib_bits.shape == (24,)


def test_host_spans_are_profiler_ranges(sig, runs):
    """Under a recording torch.profiler, the spans that enclose no device
    work are host ranges of their names; the spans around device work
    open none.  With no sink on (the runs of the ``runs`` fixture),
    ``timings`` stays None."""
    assert runs[True][1].timings is None
    runner = TrackerRunner(FC, FC, FS, device_loop=True, device="cpu")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _feed(runner, sig)
    assert runner.timings is None
    names = {e.name for e in prof.events()}
    assert {"producer", "pop", "control", "control.rs", "control.phase_c",
            "control.mib", "stage.inputs", "stage.plan"} <= names
    assert not names & {"stage", "stage.upload", "program",
                        "program.launch", "download", "search"}


def test_async_searcher_acquires_and_tracks(sig):
    """The searcher on a worker thread (tests/test_tracker.py:579-615):
    it acquires while the event loop streams, the cell integrates at a
    later tick and is then tracked.  The loop waits for each search in
    flight before streaming on, so a starved low-priority worker makes
    the test slower, not flaky."""
    runner = TrackerRunner(FC, FC, FS, search_period=5.0, search_async=True,
                           device="cpu")
    try:
        for _ in range(10):
            _feed(runner, sig)
            if runner.cells:
                break
            if runner._search_future is not None:
                runner._search_future.result(timeout=300)
        assert [c.n_id_cell for c in runner.cells] == [277]
        _feed(runner, sig)
        assert runner.cells[0].health_pct() > 90.0
    finally:
        runner.close()


def test_parallel_cells_follow_the_serial_trajectory():
    """parallel_cells=2 (each cell's get_fd and control loops on a worker
    pool, the CPU's dense path) against the serial run on the same
    two-cell stream (tests/test_tracker.py:87-110).  Only the order of
    the cells' updates to the shared frequency-offset register depends
    on scheduling (the reference's benign race,
    tracker_thread.cpp:235-238); each run's differences from the serial
    one measured under 0.05 Hz and 3e-5 samples on the CPU."""
    rng = np.random.default_rng(22)
    a = create_dl_sig(JCpType.NORMAL, 400, 0, 92, 1, 0.4, rng=rng,
                      n_ports=2, sfn=4)
    b = create_dl_sig(JCpType.NORMAL, 400, 7, 90, 1, 0.4, rng=rng,
                      n_ports=2, sfn=8)
    two = awgn(apply_freq_offset(a + 0.7 * b, 200.0), 12.0, rng=rng)
    runs = {}
    for pc in (0, 2):
        runner = _feed(TrackerRunner(FC, FC, FS, parallel_cells=pc,
                                     device="cpu"), two)
        assert (runner._cell_pool is not None) == (pc == 2)
        runner.close()
        runs[pc] = runner
    ref, got = runs[0], runs[2]
    assert abs(got.state.frequency_offset - ref.state.frequency_offset) \
        < 1.0
    by_id = {c.n_id_cell: c for c in ref.cells}
    assert sorted(c.n_id_cell for c in got.cells) == sorted(by_id) == \
        [271, 277]
    for tg in got.cells:
        tr = by_id[tg.n_id_cell]
        assert abs(tg.frame_timing - tr.frame_timing) < 1e-3
        assert tg.mib_decode_failures == tr.mib_decode_failures == 0
        assert tg.health_pct() > 99.0
        assert got.processors[tg.n_id_cell].mib_fifo_synchronized


def test_cell_dropped_at_health_threshold():
    rng = np.random.default_rng(3)
    sig = awgn(create_dl_sig(JCpType.NORMAL, 200, 0, 92, 1, 0.4, rng=rng,
                             n_ports=2, sfn=0), 10.0, rng=rng)
    runner = TrackerRunner(FC, FC, FS, device_loop=True, device="cpu")
    runner._search_enabled = False
    # a wrong cell (no such signal): every MIB decode fails
    tc = tracked_cell_from_fields(dataclasses.asdict(JTrackedCell(
        n_id_cell=100, n_id_1=33, n_id_2=1, cp_type=JCpType.NORMAL,
        n_ports=2, frame_timing=0.0)))
    tc.mib_decode_failures = CELL_DROP_THRESHOLD - 1
    runner.add_cell(tc)
    for i in range(0, len(sig), 10000):
        runner.process_block(sig[i: i + 10000])
        if not runner.cells:
            break
    assert runner.cells == [] and tc.kill_me
    assert 100 not in runner.producer.fifos


def test_backpressure_dumps_symbols_and_counts():
    rng = np.random.default_rng(4)
    n = int(2.2 * FS)
    sig = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.1
    state = GlobalState(fc_requested=FC, fc_programmed=FC, fs_programmed=FS)
    producer = Producer(state)
    cells = [tracked_cell_from_fields(dataclasses.asdict(JTrackedCell(
        n_id_cell=277, n_id_1=92, n_id_2=1, cp_type=JCpType.NORMAL,
        n_ports=2, frame_timing=0.0)))]
    for i in range(0, len(sig), 10000):
        producer.process(sig[i: i + 10000], cells)
    assert state.cell_seconds_dropped >= 1
    assert len(producer.fifos[277]) <= 1.5 * FS * 140 / 19200.0 + 1


def test_runner_defaults_to_the_card(sig):
    """device=None is the card; without one the tick raises instead of
    running on the CPU."""
    runner = TrackerRunner(FC, FC, FS)
    assert runner.device == torch.device("cuda")
    assert runner._use_device_loop()
    runner._search_enabled = False
    runner.add_cell(tracked_cell_from_fields(dataclasses.asdict(
        JTrackedCell(n_id_cell=277, n_id_1=92, n_id_2=1,
                     cp_type=JCpType.NORMAL, n_ports=2, frame_timing=0.0))))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            _feed(runner, sig[:20000])
