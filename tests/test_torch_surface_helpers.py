"""The smaller public functions and parameters that close the port's
surface (tests/test_torch_surface.py) against the TPU package on the
CPU: pbch_extract (exact) and ce_interp_hex (1e-12) on
tests/vectors/test_tfg.it, interpft and fshift_ramp(t0=) at 1e-12,
awgn(signal_power=) bit for bit, v4_band_applicable and
n_samp_elapsed_of over a grid of inputs; then the port-side knobs:
bench_tracker's flags wired through bench_one to a stub TrackerRunner,
native.ensure_built, multihost.initialize(**kwargs) and
CaptureSource.fs_programmed.
"""

import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import Cell as JCell
from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.io import capture as jcapture
from lte_cell_scanner_tpu.models import chan_est as jce
from lte_cell_scanner_tpu.models import mib as jmib
from lte_cell_scanner_tpu.models.rs import RsDl as JRsDl
from lte_cell_scanner_tpu.models.xcorr import combine_start_indices
from lte_cell_scanner_tpu.ops import dsp as jdsp
from lte_cell_scanner_tpu.parallel import carriers as jcarriers
from lte_cell_scanner_tpu.sim import channel as jchannel
from lte_cell_scanner_tpu.tracker import batched as jbatched
from lte_cell_scanner_tpu.utils.itfile import read_itfile
from lte_cell_scanner_tpu_torch.cell import Cell, CpType
from lte_cell_scanner_tpu_torch.io import capture as tcapture
from lte_cell_scanner_tpu_torch.io import native
from lte_cell_scanner_tpu_torch.models import chan_est as tce
from lte_cell_scanner_tpu_torch.models import mib as tmib
from lte_cell_scanner_tpu_torch.models.rs import RsDl
from lte_cell_scanner_tpu_torch.ops import dsp as tdsp
from lte_cell_scanner_tpu_torch.parallel import carriers as tcarriers
from lte_cell_scanner_tpu_torch.parallel import multihost
from lte_cell_scanner_tpu_torch.sim import channel as tchannel
from lte_cell_scanner_tpu_torch.tracker import batched as tbatched
from tools_torch import bench_tracker

FC = 739e6
FS = 1.92e6
VEC = pathlib.Path(__file__).parent / "vectors"


def _tfg_cell(cls, cp):
    # the peak of the reference's two-cell capture (BASELINE.md)
    return cls(fc_requested=FC, fc_programmed=FC, ind=8674, freq=40e3,
               n_id_2=1, n_id_1=92, cp_type=cp, frame_start=17448.525,
               freq_fine=39684.0775)


@pytest.fixture(scope="module")
def tfg():
    return read_itfile(str(VEC / "test_tfg.it"))["tfg"]


def test_pbch_extract_matches_tpu_package(tfg):
    jcell = _tfg_cell(JCell, JCpType.NORMAL)
    ces = [np.array(jce.chan_est(jcell, JRsDl(277, 6, JCpType.NORMAL),
                                 tfg, port)[0]) for port in range(4)]
    ref_sym, ref_ce = jmib.pbch_extract(jcell, jnp.asarray(tfg),
                                        [jnp.asarray(c) for c in ces])
    sym, ce = tmib.pbch_extract(_tfg_cell(Cell, CpType.NORMAL),
                                torch.from_numpy(tfg),
                                [torch.from_numpy(c) for c in ces])
    assert ce.shape == (4, sym.shape[0])
    np.testing.assert_array_equal(sym.numpy(), np.asarray(ref_sym))
    np.testing.assert_array_equal(ce.numpy(), np.asarray(ref_ce))


@pytest.mark.parametrize("port", range(4))
def test_ce_interp_hex_matches_tpu_package_and_chan_est(tfg, port):
    jcell = _tfg_cell(JCell, JCpType.NORMAL)
    ce_raw, rs_set, shifts = jce._extract_raw_ce(
        jcell, JRsDl(277, 6, JCpType.NORMAL), jnp.asarray(tfg), port)
    ce_filt = np.array(jce._hex_filter(ce_raw, int(shifts[0]),
                                         int(shifts[1])))
    n_ofdm = tfg.shape[0]
    ref = np.asarray(jce.ce_interp_hex(jnp.asarray(ce_filt), rs_set, shifts,
                                       n_ofdm, 7, port))
    got = tce.ce_interp_hex(torch.from_numpy(ce_filt), rs_set, shifts,
                            n_ofdm, 7, port)
    assert got.shape == (n_ofdm, 72)
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-12

    # interchangeable with the fused hex chain of chan_est
    rs_dl = RsDl(277, 6, CpType.NORMAL)
    raw, t_set, t_shifts = tce._extract_raw_ce(rs_dl, torch.from_numpy(tfg),
                                               port)
    filt = tce._hex_filter(raw, int(t_shifts[0]), int(t_shifts[1]))
    fused, _np = tce.chan_est(_tfg_cell(Cell, CpType.NORMAL), rs_dl,
                              torch.from_numpy(tfg), port, interp="hex")
    staged = tce.ce_interp_hex(filt, t_set, t_shifts, n_ofdm, 7, port)
    assert torch.max(torch.abs(staged - fused)).item() <= 1e-12


@pytest.mark.parametrize("n_x,n_y", [(7, 21), (7, 30), (8, 24), (8, 30),
                                     (8, 5), (9, 9)])
def test_interpft_matches_tpu_package(n_x, n_y):
    rng = np.random.default_rng(n_x * 100 + n_y)
    x = rng.normal(size=(2, n_x)) + 1j * rng.normal(size=(2, n_x))
    ref = np.asarray(jdsp.interpft(jnp.asarray(x), n_y))
    got = tdsp.interpft(torch.from_numpy(x), n_y).numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-12
    np.testing.assert_allclose(got, tdsp.interpft_host(x, n_y), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        tdsp.interpft(torch.from_numpy(x), 0)


@pytest.mark.parametrize("t0", [0, 7, 12345])
def test_fshift_ramp_t0_matches_tpu_package(t0):
    ref = np.asarray(jdsp.fshift_ramp(256, 35e3, FS, dtype=jnp.complex128,
                                      t0=t0))
    got = tdsp.fshift_ramp(256, 35e3, FS, torch.complex128,
                           torch.device("cpu"), t0=t0).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-12


@pytest.mark.parametrize("signal_power", [None, 0.3])
def test_awgn_signal_power_draws_the_same_noise(signal_power):
    sig = np.exp(1j * np.arange(1000) * 0.01) * 0.7
    ref = jchannel.awgn(sig, 5.0, np.random.default_rng(11),
                        signal_power=signal_power)
    got = tchannel.awgn(sig, 5.0, np.random.default_rng(11),
                        signal_power=signal_power)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_carriers,span", [(1, 0.0), (3, 0.3e6),
                                             (101, 10e6), (64, 60e6)])
@pytest.mark.parametrize("ppm", [5.0, 100.0, 400.0, 1000.0])
def test_v4_band_applicable_matches_tpu_package(n_carriers, span, ppm):
    f_set = np.arange(-ppm * 1e-6 * FC, ppm * 1e-6 * FC + 1, 5e3)
    fcs = FC + np.linspace(0.0, span, n_carriers)
    starts = np.stack([combine_start_indices(f_set, fc, fc, FS, 15)
                       for fc in fcs])
    for margin in (0, 1):
        want = jcarriers.v4_band_applicable(starts, margin)
        assert tcarriers.v4_band_applicable(starts, margin) == want
        assert want == (jcarriers.v4_band_kv(starts, margin) != 0)


def test_n_samp_elapsed_of_matches_tpu_package():
    for extended in (False, True):
        for sym in range(7):
            assert tbatched.n_samp_elapsed_of(sym, extended) == \
                jbatched.n_samp_elapsed_of(sym, extended)

    class Chunk:
        def __init__(self, sym0, n):
            self.sym0, self.n = sym0, n

        def __len__(self):
            return self.n

    for n_symb in (6, 7):
        for sym0 in range(n_symb):
            ch = Chunk(sym0, 20)
            np.testing.assert_array_equal(
                tbatched._nse_of_chunk(ch, n_symb),
                jbatched._nse_of_chunk(ch, n_symb))


class _StubRunner:
    """Enough of TrackerRunner for bench_one: every cell is tracked
    after the first tick (none with ``acquire=False``)."""

    made = []
    acquire = True

    def __init__(self, fc_requested, fc_programmed, fs_programmed, **kw):
        from types import SimpleNamespace
        self.kw = kw
        self.blocks = []
        self.cells = []
        self.processors = {}
        self.timings = {}
        self.state = SimpleNamespace(frequency_offset=200.0)
        self._search_future = None
        self._last_search_at = None
        self._samples_fed = 0
        _StubRunner.made.append(self)

    def warmup(self):
        pass

    def process_block(self, samples):
        from types import SimpleNamespace
        self.blocks.append(len(samples))
        self._samples_fed += len(samples)
        if _StubRunner.acquire and not self.cells:
            for n_id in (277, 271):
                self.cells.append(SimpleNamespace(
                    n_id_cell=n_id, health_pct=lambda: 100.0,
                    frame_timing=0.0, mib_decode_failures=0.0))
                self.processors[n_id] = SimpleNamespace(
                    mib_fifo_synchronized=True)

    def close(self):
        pass


class _StubStream:
    made = []

    def __init__(self, n_cells, snr_db, **kw):
        self.snr_db = snr_db
        _StubStream.made.append(self)

    def take(self, n):
        return np.zeros(n, np.complex64)


@pytest.fixture
def stubs(monkeypatch):
    import lte_cell_scanner_tpu_torch.tracker as tracker
    monkeypatch.setattr(tracker, "TrackerRunner", _StubRunner)
    monkeypatch.setattr(bench_tracker, "MultiCellStream", _StubStream)
    monkeypatch.setattr(_StubRunner, "made", [])
    monkeypatch.setattr(_StubStream, "made", [])
    monkeypatch.setattr(_StubRunner, "acquire", True)


def test_bench_tracker_flags_reach_the_runner(stubs, capsys):
    rc = bench_tracker.main(
        ["--device", "cpu", "--cells", "2", "--runs", "1", "--seconds",
         "0.05", "--snr", "7.5", "--block", "2000", "--parallel", "4",
         "--device-loop", "off", "--profile", "--json"])
    out = capsys.readouterr()
    assert rc == 0
    res = json.loads(out.out.strip().splitlines()[-1])
    runner, = _StubRunner.made
    assert runner.kw["parallel_cells"] == 4
    assert runner.kw["device_loop"] is False
    assert runner.kw["device"] == "cpu"
    assert set(runner.blocks) == {2000}
    assert _StubStream.made[0].snr_db == 7.5
    assert (res["snr_db"], res["parallel_cells"], res["device_loop"]) == \
        (7.5, 4, False)
    assert res["tick_ms_stream"] == pytest.approx(1e3 * 2000 / FS)
    assert "function calls" in out.err          # the cProfile report


@pytest.mark.parametrize("mode,want", [("auto", None), ("on", True),
                                       ("off", False)])
def test_bench_tracker_device_loop_choices(stubs, capsys, mode, want):
    assert bench_tracker.main(["--device", "cpu", "--cells", "2", "--runs",
                               "1", "--seconds", "0.02", "--device-loop",
                               mode]) == 0
    runner, = _StubRunner.made
    assert runner.kw["device_loop"] is want
    assert runner.kw["parallel_cells"] == 0
    assert set(runner.blocks) == {10000}
    assert _StubStream.made[0].snr_db == 12.0


def test_bench_tracker_acq_seconds_bounds_the_acquisition(stubs):
    _StubRunner.acquire = False
    with pytest.raises(RuntimeError, match=r"in 0\.5 s"):
        bench_tracker.bench_one(2, 1, 0.02, acq_seconds=0.5, block=9600,
                                device="cpu", verbose=False)
    runner, = _StubRunner.made
    assert sum(runner.blocks) == 9600 * 101     # just past 0.5 s


def test_ensure_built(monkeypatch):
    calls = []

    def build():
        calls.append(1)
        return 0.1, "compiler output"

    monkeypatch.setattr(native, "build", build)
    monkeypatch.setattr(native, "_stale", lambda: False)
    assert native.ensure_built() and not calls
    assert native.ensure_built(force=True) and calls
    monkeypatch.setattr(native, "_stale", lambda: True)

    def broken():
        raise RuntimeError("c++ failed")

    monkeypatch.setattr(native, "build", broken)
    assert native.ensure_built() is False


def test_initialize_passes_its_keywords(monkeypatch):
    import datetime
    seen = {}
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *a, **k: seen.update(args=a, kw=k))
    timeout = datetime.timedelta(seconds=5)
    multihost.initialize("127.0.0.1:29500", 2, 1, timeout=timeout)
    assert seen["args"] == ("gloo",)
    assert seen["kw"] == {"init_method": "tcp://127.0.0.1:29500",
                          "world_size": 2, "rank": 1, "timeout": timeout}


def test_capture_source_fs_programmed():
    assert tcapture.CaptureSource.fs_programmed == \
        jcapture.CaptureSource.fs_programmed
    assert tcapture.SimSource().fs_programmed == \
        jcapture.SimSource().fs_programmed


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
