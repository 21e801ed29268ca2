"""The port's live RTL-SDR source (io/rtlsdr.py) against a fake
librtlsdr, case for case as tests/test_rtlsdr.py drives the TPU
package's: the reference's retry/settle/correction semantics without
hardware (reference src/capbuf.cpp:117-186, src/CellSearch.cpp:344-433),
the asynchronous reader and its native ring; then ``cli.py search`` on
a live "dongle" that serves a recorded capture, against the TPU CLI
through the same fake and against ``--load-files`` of the same bytes.
"""

import ctypes

import numpy as np
import pytest

from chip_smoke import FakeDongle
from lte_cell_scanner_tpu import cli as jcli
from lte_cell_scanner_tpu.io import rtlsdr as jrtlsdr
from lte_cell_scanner_tpu_torch import cli
from lte_cell_scanner_tpu_torch.constants import CAPLENGTH
from lte_cell_scanner_tpu_torch.io import native
from lte_cell_scanner_tpu_torch.io import rtlsdr
from lte_cell_scanner_tpu_torch.io.e4000 import fc_programmed_with_fudge
from lte_cell_scanner_tpu_torch.io.rtlsdr import (RTLSDR_TUNER_E4000,
                                                  RtlSdrSource)
from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                      two_cell_capture)
from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8


class FakeLib:
    """Just enough of the librtlsdr ctypes surface."""

    def __init__(self, n_devices=1, tuner=RTLSDR_TUNER_E4000,
                 center_freq_failures=0, fill=128):
        self.n_devices = n_devices
        self.tuner = tuner
        self.center_freq_failures = center_freq_failures
        self.fill = fill
        self.calls = []
        self.tuned = []
        self.sample_rate = None
        self.bytes_read = 0

    def rtlsdr_get_device_count(self):
        return self.n_devices

    def rtlsdr_get_device_name(self, idx):
        return f"FakeSDR{idx}".encode()

    def rtlsdr_open(self, dev_p, idx):
        self.calls.append(("open", idx))
        return 0

    def rtlsdr_close(self, dev):
        self.calls.append(("close",))
        return 0

    def rtlsdr_set_sample_rate(self, dev, rate):
        self.sample_rate = rate
        return 0

    def rtlsdr_get_sample_rate(self, dev):
        return self.sample_rate

    def rtlsdr_set_center_freq(self, dev, freq):
        if self.center_freq_failures > 0:
            self.center_freq_failures -= 1
            return -1
        self.tuned.append(freq)
        return 0

    def rtlsdr_get_tuner_type(self, dev):
        return self.tuner

    def rtlsdr_set_tuner_gain_mode(self, dev, mode):
        self.calls.append(("gain_mode", mode))
        return 0

    def rtlsdr_reset_buffer(self, dev):
        self.calls.append(("reset",))
        return 0

    def rtlsdr_read_sync(self, dev, buf, n, n_read_p):
        data = bytes([self.fill]) * n
        ctypes.memmove(buf, data, n)
        n_read_p._obj.value = n
        self.bytes_read += n
        return 0


def make_source(**kw):
    lib = kw.pop("lib", None) or FakeLib(**{
        k: kw.pop(k) for k in ("n_devices", "tuner", "center_freq_failures")
        if k in kw})
    src = RtlSdrSource(lib=lib, sleep=lambda s: None, **kw)
    return src, lib


def test_agc_settle_discards_1p5s():
    src, lib = make_source()
    # the constructor must have discarded >= 1.5 s of bytes
    assert lib.bytes_read >= 2880000 * 2
    assert ("gain_mode", 0) in lib.calls
    assert ("reset",) in lib.calls


def test_correction_applied_at_tune_and_rate():
    corr = 1 + 50e-6
    src, lib = make_source(correction=corr, agc_settle=False)
    assert lib.sample_rate == int(round(1920000 * corr))
    src.tune(739e6)
    assert lib.tuned[-1] == int(round(739e6 * corr))


def test_center_freq_retry_then_success():
    src, lib = make_source(agc_settle=False)
    lib.center_freq_failures = 3
    fc_prog = src.tune(739e6)   # 3 failures + 1 success < 5 limit
    assert lib.tuned, "tune must eventually succeed"
    assert fc_prog == fc_programmed_with_fudge(739e6)


def test_center_freq_five_failures_abort():
    src, lib = make_source(agc_settle=False)
    lib.center_freq_failures = 10
    with pytest.raises(RuntimeError, match="center frequency"):
        src.tune(739e6)


def test_non_e4000_reports_requested_freq():
    src, lib = make_source(tuner=99, agc_settle=False)
    assert src.tune(739e6) == 739e6


def test_capture_unit_scaling():
    src, lib = make_source(agc_settle=False)
    lib.fill = 128
    buf, fc_prog = src.capture(739e6)
    assert len(buf) == CAPLENGTH
    # (128-127)/128 for both I and Q
    expected = (128 - 127) / 128.0
    assert np.allclose(buf, expected + 1j * expected)
    assert fc_prog == fc_programmed_with_fudge(739e6)


def test_device_index_bounds():
    with pytest.raises(RuntimeError, match="out of range"):
        make_source(lib=FakeLib(n_devices=1), device_index=2,
                    agc_settle=False)
    src, lib = make_source(lib=FakeLib(n_devices=3), device_index=2,
                           agc_settle=False)
    assert ("open", 2) in lib.calls
    assert src.device_name == "FakeSDR2"


def test_no_devices():
    with pytest.raises(RuntimeError, match="no RTL-SDR devices"):
        make_source(lib=FakeLib(n_devices=0))


class PacedFakeLib(FakeLib):
    """FakeLib whose reads are paced (so the reader thread does not
    spin unboundedly) and fill an incrementing byte pattern."""

    def __init__(self, pace=0.0005, **kw):
        super().__init__(**kw)
        self.pace = pace
        self._ctr = 0

    def rtlsdr_read_sync(self, dev, buf, n, n_read_p):
        import time as _t
        if self.pace:
            _t.sleep(self.pace)
        data = bytes((self._ctr + i) & 0xFF for i in range(n))
        self._ctr += n
        ctypes.memmove(buf, data, n)
        n_read_p._obj.value = n
        self.bytes_read += n
        return 0


def test_async_stream_slow_consumer_counts_drops():
    """The reference's async-ingest contract (capbuf.cpp:41-71): a
    stalled consumer must NOT stall the radio -- the reader thread keeps
    draining, the ring drops with COUNTERS, and the stream keeps
    yielding afterwards."""
    import time

    src, lib = make_source(lib=PacedFakeLib(pace=0.0), agc_settle=False)
    # tiny ring (1000-sample blocks -> 8000-byte floor) so a slow
    # consumer overruns within milliseconds of free-running reads
    gen = src.stream(block=1000, ring_seconds=1e-9, poll_sleep=1e-4)
    first = next(gen)
    assert len(first) == 1000
    time.sleep(0.05)            # stalled consumer; reader keeps reading
    second = next(gen)          # stream survives the stall
    assert len(second) == 1000
    reader = src._reader
    assert reader.dropped_bytes > 0
    assert reader.overruns > 0
    assert src.dropped_seconds() == pytest.approx(
        reader.dropped_bytes / (2.0 * src.fs_programmed))
    gen.close()                 # generator finally: reader stops
    assert src._reader is None
    src.close()


def test_async_stream_no_drops_when_consumer_keeps_up():
    """A consumer faster than the (paced) radio sees a gap-free
    incrementing byte stream and zero drops."""
    src, lib = make_source(lib=PacedFakeLib(pace=0.0005),
                           agc_settle=False)
    gen = src.stream(block=2000, ring_seconds=2.0, poll_sleep=1e-4)
    blocks = [next(gen) for _ in range(5)]
    reader = src._reader
    assert reader.dropped_bytes == 0
    assert src.dropped_seconds() == 0.0
    gen.close()
    # continuity: undo the (x-127)/128 scaling back to the u8 pattern
    raw = np.empty(2 * sum(len(b) for b in blocks), dtype=np.uint8)
    flat = np.concatenate(blocks)
    raw[0::2] = np.round(flat.real * 128 + 127).astype(np.uint8)
    raw[1::2] = np.round(flat.imag * 128 + 127).astype(np.uint8)
    expected = (np.arange(raw.size) & 0xFF).astype(np.uint8)
    assert np.array_equal(raw, expected)
    src.close()


def test_async_stream_surfaces_reader_death():
    """A dead USB endpoint surfaces as a RuntimeError from the stream,
    not a silent hang."""
    src, lib = make_source(agc_settle=False)

    def boom(dev, buf, n, n_read_p):
        raise OSError("usb gone")

    lib.rtlsdr_read_sync = boom
    gen = src.stream(block=1000, poll_sleep=1e-4)
    with pytest.raises(RuntimeError, match="reader thread died"):
        next(gen)
    src.close()


@pytest.mark.parametrize("native_lib", [True, False],
                         ids=["native", "python"])
def test_stream_ring_is_the_native_one_when_it_loads(monkeypatch,
                                                     native_lib):
    """The reader fills the native SPSC ring (native/ingest.cpp) when the
    runtime loads, else the locked Python ring; both deliver the same
    bytes."""
    if native_lib and native.get_lib() is None:
        pytest.skip("the native runtime does not build here")
    if not native_lib:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    src, lib = make_source(lib=PacedFakeLib(pace=0.0002), agc_settle=False)
    gen = src.stream(block=1500, ring_seconds=1.0, poll_sleep=1e-4)
    flat = np.concatenate([next(gen) for _ in range(3)])
    ring = src._reader.ring
    assert isinstance(ring, native.SampleRing if native_lib
                      else rtlsdr._PyRing)
    gen.close()
    src.close()
    raw = np.empty(2 * len(flat), dtype=np.uint8)
    raw[0::2] = np.round(flat.real * 128 + 127).astype(np.uint8)
    raw[1::2] = np.round(flat.imag * 128 + 127).astype(np.uint8)
    assert np.array_equal(raw, (np.arange(raw.size) & 0xFF).astype(np.uint8))


def test_blocking_stream_yields_the_async_streams_bytes():
    """stream(use_async=False): the plain blocking read loop, no reader
    thread; the same blocks as the asynchronous stream of the same
    dongle, and the TPU package's blocking loop."""
    blocks = {}
    for name, use_async in (("sync", False), ("async", True)):
        src, lib = make_source(lib=PacedFakeLib(pace=0.0), agc_settle=False)
        gen = src.stream(block=1500, use_async=use_async, poll_sleep=1e-4)
        blocks[name] = [next(gen) for _ in range(4)]
        assert (getattr(src, "_reader", None) is None) == (not use_async)
        gen.close()
        src.close()
    jsrc = jrtlsdr.RtlSdrSource(lib=PacedFakeLib(pace=0.0),
                                sleep=lambda s: None, agc_settle=False)
    jgen = jsrc.stream(block=1500, use_async=False)
    ref = [next(jgen) for _ in range(4)]
    jsrc.close()
    for s, a, r in zip(blocks["sync"], blocks["async"], ref):
        assert len(s) == 1500
        np.testing.assert_array_equal(s, a)
        np.testing.assert_array_equal(s, r)


def test_no_librtlsdr_is_an_error(monkeypatch):
    monkeypatch.setattr(rtlsdr.ctypes.util, "find_library", lambda n: None)

    def no_lib(name):
        raise OSError(name)

    monkeypatch.setattr(rtlsdr.ctypes, "CDLL", no_lib)
    with pytest.raises(RuntimeError, match="librtlsdr not found"):
        rtlsdr.load_librtlsdr()


def _table(out: str):
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(("Detected the following cells:",
                                   "No LTE cells were found")))
    return lines[start:]


def test_live_search_prints_the_tpu_cli_table(tmp_path, monkeypatch,
                                              capsys):
    """`search` with no source named opens the dongle: through a fake
    librtlsdr (chip_smoke.FakeDongle: filler through the AGC settle, then
    the payload) that serves the two-cell capture's u8 bytes (+1 kHz,
    inside -p 5), the port (--device cpu) prints the TPU CLI's table, and
    the table of --load-files on the same bytes."""
    raw = complex_to_iq_u8(adc_quantize(two_cell_capture(f_off=1e3)))
    path = tmp_path / "cap.u8"
    raw.tofile(path)
    argv = ["search", "-s", "739e6", "-p", "5"]
    monkeypatch.setattr(rtlsdr, "load_librtlsdr", lambda: FakeDongle(raw))
    assert cli.main(argv + ["--device", "cpu"]) == 0
    live = capsys.readouterr().out
    monkeypatch.setattr(jrtlsdr, "load_librtlsdr", lambda: FakeDongle(raw))
    assert jcli.main(["--platform", "cpu"] + argv) == 0
    jlive = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu", "--load-files",
                            str(path)]) == 0
    replay = capsys.readouterr().out
    assert _table(live) == _table(jlive) == _table(replay)
    assert [ln.split()[0] for ln in _table(live)[3:]] == ["277", "271"]
