"""The port's capture layer (lte_cell_scanner_tpu_torch/utils/itfile.py,
utils/rtl.py, utils/debug.py, io/e4000.py, io/capture.py) against the
TPU package's on the CPU.

Files written by either package are read by both; sources draw from
generators seeded alike and must give the same samples bit for bit; the
E4000 model's integer arithmetic must agree exactly; the 160 ms
coupled-offset capture must decode the same cell through both
``cell_search`` functions (complex128, the exact correlation on both
sides; freq_fine within 1e-8 Hz, freq_superfine within 1e-7 Hz).
"""

import pathlib

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.io import capture as jcap
from lte_cell_scanner_tpu.io import e4000 as je4000
from lte_cell_scanner_tpu.models import search as js
from lte_cell_scanner_tpu.utils import itfile as jit
from lte_cell_scanner_tpu.utils import rtl as jrtl
from lte_cell_scanner_tpu_torch.cell import CpType
from lte_cell_scanner_tpu_torch.io import capture as tcap
from lte_cell_scanner_tpu_torch.io import e4000 as te4000
from lte_cell_scanner_tpu_torch.models import search as ts
from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                      two_cell_capture)
from lte_cell_scanner_tpu_torch.utils import debug as tdebug
from lte_cell_scanner_tpu_torch.utils import itfile as tit
from lte_cell_scanner_tpu_torch.utils import rtl as trtl

VEC = pathlib.Path(__file__).parent / "vectors"
FS = 1.92e6
FC = 739e6


def _variables():
    rng = np.random.default_rng(3)
    return {"capbuf": rng.normal(size=50) + 1j * rng.normal(size=50),
            "fc": np.array([739000000], dtype=np.int32),
            "dvec": rng.normal(size=7),
            "dmat": rng.normal(size=(3, 5)),
            "imat": rng.integers(-9, 9, size=(4, 2)),
            "cmat": rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3))}


def _assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["port", "tpu"])
def test_it_files_round_trip_between_the_packages(tmp_path, writer):
    """Exact: the same bytes on disk, the same arrays read back."""
    v = _variables()
    port_path, tpu_path = tmp_path / "port.it", tmp_path / "tpu.it"
    tit.write_itfile(str(port_path), v)
    jit.write_itfile(str(tpu_path), v)
    assert port_path.read_bytes() == tpu_path.read_bytes()
    path = str(port_path if writer == "port" else tpu_path)
    _assert_same_dict(tit.read_itfile(path), jit.read_itfile(path))
    for k, a in tit.read_itfile(path).items():
        np.testing.assert_array_equal(a, np.asarray(v[k]))


@pytest.mark.parametrize("name", ["test_tfg.it", "test_xcorr_pss.it"])
def test_shipped_vectors_read_identically(name):
    _assert_same_dict(tit.read_itfile(str(VEC / name)),
                      jit.read_itfile(str(VEC / name)))


def _u8_file(tmp_path, n=4000):
    """A raw u8 file with every byte value, saturated 255s among them."""
    raw = np.random.default_rng(7).integers(0, 256, size=2 * n)
    raw[::97] = 255
    path = tmp_path / "cap.u8"
    raw.astype(np.uint8).tofile(path)
    return str(path)


@pytest.mark.parametrize("drop", [0.0, 0.001])
def test_rtlsdr_files_read_identically(tmp_path, drop):
    path = _u8_file(tmp_path)
    got = trtl.read_rtlsdr_file(path, drop)
    want = jrtl.read_rtlsdr_file(path, drop)
    assert got.dtype == want.dtype == np.complex128
    np.testing.assert_array_equal(got, want)
    assert len(got) == 4000 - int(round(drop * FS))
    # odd byte counts drop the dangling I sample
    raw = np.fromfile(path, dtype=np.uint8)[:-1]
    np.testing.assert_array_equal(trtl.iq_u8_to_complex(raw),
                                  jrtl.iq_u8_to_complex(raw))


def test_u8_writer_round_trips_an_adc_grid_capture(tmp_path):
    """The port's writer (chip_smoke.py uses it): an 8-bit-grid capture
    comes back bit for bit through either package's reader."""
    cap = adc_quantize(two_cell_capture(f_off=1e3))[:20000]
    path = str(tmp_path / "grid.u8")
    trtl.complex_to_iq_u8(cap).tofile(path)
    np.testing.assert_array_equal(jrtl.read_rtlsdr_file(path), cap)
    np.testing.assert_array_equal(trtl.read_rtlsdr_file(path), cap)


def test_e4000_pll_model_matches_tpu_package():
    fcs = np.concatenate([np.linspace(50e6, 1.25e9, 997),
                          [72.4e6 - 1, 72.4e6, 739e6, 739.1e6, 1.2e9]])
    for fc in fcs:
        assert te4000.compute_fc_programmed(28.8e6, fc) == \
            je4000.compute_fc_programmed(28.8e6, fc)
        assert te4000.fc_programmed_with_fudge(fc) == \
            je4000.fc_programmed_with_fudge(fc)


@pytest.mark.parametrize("kw", [
    {},
    {"freq_offset": 3e3, "snr_db": 5.0, "n_ports": 4,
     "cp": "extended", "seed": 4},
    {"freq_offset": 25e3, "coupled_fc": FC, "seed": 2},
], ids=["plain", "plain-4port-ext", "coupled"])
def test_sim_source_is_bit_equal_to_tpu_package(kw):
    kw = dict(kw)
    cp = kw.pop("cp", "normal")
    got = tcap.SimSource(cp_type=CpType(cp), **kw)
    want = jcap.SimSource(cp_type=JCpType(cp), **kw)
    for _ in range(2):                     # successive draws stay in step
        g, gfc = got.capture(FC)
        w, wfc = want.capture(FC)
        assert gfc == wfc == FC
        assert g.shape == w.shape == (153600,)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["u8", "it"])
def test_file_source_with_noise_matches_tpu_package(tmp_path, kind):
    """A shared seeded generator: the same noise on the same samples
    (exact); replay stops with ValueError unless repeat is set."""
    if kind == "u8":
        path = _u8_file(tmp_path)
    else:
        path = str(tmp_path / "cap.it")
        tit.write_itfile(path, {"capbuf": two_cell_capture()[:5000],
                                "fc": np.array([int(FC)], np.int32)})
    got = tcap.FileSource([path], drop_seconds=0.001, noise_power=0.01,
                          rng=np.random.default_rng(11))
    want = jcap.FileSource([path], drop_seconds=0.001, noise_power=0.01,
                           rng=np.random.default_rng(11))
    g, _ = got.capture(FC)
    w, _ = want.capture(FC)
    np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        got.capture(FC)
    rep = tcap.FileSource([path], repeat=True)
    a, _ = rep.capture(FC)
    b, _ = rep.capture(FC)
    np.testing.assert_array_equal(a, b)


def test_capture_session_records_and_replays_like_tpu_package(tmp_path,
                                                              capsys):
    """Numbering, the index override, the int32 fc field, the tuner
    model, record then load, and the frequency-mismatch warning: the same
    files and the same results as the TPU package's session."""
    out = {}
    for name, mod in (("port", tcap), ("tpu", jcap)):
        d = tmp_path / name
        d.mkdir()
        src = mod.SimSource(seed=5)
        sess = mod.CaptureSession(str(d))
        recs = [sess.capture_data(FC, src, save_cap=True, tuner="none"),
                sess.capture_data(FC + 1e5, src, save_cap=True),
                sess.capture_data(FC, src, save_cap=True, index=7)]
        assert sorted(p.name for p in d.iterdir()) == \
            ["capbuf_0000.it", "capbuf_0001.it", "capbuf_0007.it"]
        replay = mod.CaptureSession(str(d))
        loads = [replay.capture_data(FC, None, use_recorded_data=True),
                 replay.capture_data(FC, None, use_recorded_data=True)]
        out[name] = (recs, loads, {p.name: p.read_bytes()
                                   for p in d.iterdir()})
    printed = capsys.readouterr().out
    (p_recs, p_loads, p_files), (j_recs, j_loads, j_files) = \
        out["port"], out["tpu"]
    assert p_files == j_files
    for (pc, pf), (jc, jf) in zip(p_recs + p_loads, j_recs + j_loads):
        assert pf == jf
        np.testing.assert_array_equal(pc, jc)
    assert [f for _, f in p_recs] == [FC, je4000.fc_programmed_with_fudge(
        FC + 1e5), je4000.fc_programmed_with_fudge(FC)]
    assert p_loads[1][1] == FC
    assert printed.count("Warning: capture") == 2     # one per package
    assert "taken at 739.100 MHz, not 739.000" in printed
    fc = tit.read_itfile(str(tmp_path / "port" / "capbuf_0001.it"))["fc"]
    assert fc.dtype == np.int32 and fc.tolist() == [int(FC + 1e5)]
    with pytest.raises(RuntimeError):
        tcap.capture_data(FC, None, data_dir=str(tmp_path))


def test_debug_dump_and_stage_timings(tmp_path):
    """The dump takes tensors and numpy arrays, suffixes repeated names,
    and writes a file the TPU package's reader reads; a stage records into
    the profile when enabled and into a timings dict when given."""
    path = str(tmp_path / "dump.it")
    dump = tdebug.DebugDump(path)
    tdebug.set_dump(dump)
    try:
        tdebug.debug_export("x", torch.arange(4, dtype=torch.float64))
        tdebug.debug_export("x", np.array([1.5 + 2j]))
    finally:
        tdebug.set_dump(None)
    tdebug.debug_export("x", np.zeros(2))          # no dump: no-op
    d = jit.read_itfile(path)
    assert sorted(d) == ["x", "x_1"]
    np.testing.assert_array_equal(d["x"], np.arange(4.0))
    assert tdebug.DebugDump(path)._names == {"x", "x_1"}

    timings = {}
    with tdebug.stage("a", "cpu", timings):
        pass
    with tdebug.stage("a", None, timings):
        pass
    assert list(timings) == ["a"] and timings["a"] >= 0.0
    tdebug.enable_profiling()
    try:
        with tdebug.stage("b"):
            pass
        with tdebug.stage("b"):
            pass
        report = tdebug.profile_report()
    finally:
        tdebug.enable_profiling(False)
    assert report.splitlines()[1].split()[:1] == ["b"]
    assert " 2 " in report.splitlines()[1]
    assert "not enabled" in tdebug.profile_report()


LONG = {"coupled_fc": FC, "freq_offset": 60e3, "capture_ms": 160}


@pytest.fixture(scope="module")
def long_capture():
    """160 ms through the coupled crystal channel at 60 kHz (~81 ppm) at
    739 MHz, the SimSource chip_smoke.py drives on the card."""
    return tcap.SimSource(**LONG).capture(FC)[0]


def test_long_sim_source_is_bit_equal_to_tpu_package(long_capture):
    want, _ = jcap.SimSource(**LONG).capture(FC)
    assert long_capture.shape == want.shape == (2 * 153600,)
    np.testing.assert_array_equal(long_capture, want)


def test_long_coupled_capture_matches_tpu_package(long_capture):
    """Both cell_search functions on a narrow grid around the offset: the
    fold over 31 half frames decodes cell 277, the same fields on both."""
    f_set = np.array([55e3, 60e3, 65e3])
    ref = js.cell_search(long_capture, f_set, FC, FC, FS, js.SearchConfig())
    got = ts.cell_search(long_capture, f_set, FC, FC, FS, device="cpu")
    assert len(got) == len(ref) >= 1
    for r, g in zip(ref, got):
        assert (g.n_id_cell(), g.cp_type.value, g.n_rb_dl, g.n_ports,
                g.sfn) == (r.n_id_cell(), r.cp_type.value, r.n_rb_dl,
                           r.n_ports, r.sfn)
        assert abs(g.freq_fine - r.freq_fine) < 1e-8
        assert abs(g.freq_superfine - r.freq_superfine) < 1e-7
    best = {c.n_id_cell(): c for c in got}[277]
    assert best.n_rb_dl == 6
    assert abs(best.freq_fine - 60e3) < 50.0


def test_debug_dump_of_cell_search_matches_tpu_package(tmp_path):
    """With a dump active, both cell_search functions export the front
    end's intermediates under the same names: collapsed powers within
    1e-8 of their max, sp_incoherent and Z_th1 within 1e-12 relative,
    hypothesis indices and peak lists exact."""
    from lte_cell_scanner_tpu.utils import debug as jdebug
    cap = two_cell_capture(f_off=1e3)
    f_set = np.array([-5e3, 0.0, 5e3])
    dumps = {}
    for name, dbg, run in (
            ("port", tdebug, lambda: ts.cell_search(
                cap, f_set, FC, FC, FS, ts.SearchConfig(decode=False),
                device="cpu")),
            ("tpu", jdebug, lambda: js.cell_search(
                cap, f_set, FC, FC, FS, js.SearchConfig(decode=False)))):
        path = str(tmp_path / f"{name}.it")
        dbg.set_dump(dbg.DebugDump(path))
        try:
            run()
        finally:
            dbg.set_dump(None)
        dumps[name] = jit.read_itfile(path)
    got, want = dumps["port"], dumps["tpu"]
    assert sorted(got) == sorted(want) == sorted(
        ["xc_incoherent_collapsed_pow", "xc_incoherent_collapsed_frq",
         "sp_incoherent", "Z_th1", "peak_ind", "peak_n_id_2"])
    for k in ("xc_incoherent_collapsed_frq", "peak_ind", "peak_n_id_2"):
        np.testing.assert_array_equal(got[k], want[k])
    pw = want["xc_incoherent_collapsed_pow"]
    assert np.max(np.abs(got["xc_incoherent_collapsed_pow"] - pw)) <= \
        1e-8 * np.max(pw)
    for k in ("sp_incoherent", "Z_th1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
