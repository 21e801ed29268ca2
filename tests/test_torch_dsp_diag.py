"""The port's ``ops/dsp.py`` helpers, ``diag.py`` and ``cli.py check``
against the TPU package's on the CPU.

The same numpy inputs, drawn from a seed, go through both packages (JAX
with x64).  The helpers agree within 1e-12 of the largest value; the
capture check finds the same peaks (locations, spacings, drops, flags)
and the same missing peaks, its peak power within 1e-4 dB (both
correlate in complex64); ``check`` prints the TPU CLI's lines.
"""

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu import cli as jcli
from lte_cell_scanner_tpu import diag as jdiag
from lte_cell_scanner_tpu.ops import dsp as jdsp
from lte_cell_scanner_tpu_torch import cli
from lte_cell_scanner_tpu_torch import diag as tdiag
from lte_cell_scanner_tpu_torch.cell import CpType
from lte_cell_scanner_tpu_torch.ops import dsp as tdsp
from lte_cell_scanner_tpu_torch.sim import awgn, create_dl_sig
from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                      two_cell_capture)
from lte_cell_scanner_tpu_torch.utils.itfile import write_itfile
from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8

FC = 739e6
FS = 1.92e6


def _draw(seed=0, n=96):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    r = rng.normal(size=n) * 7.0
    return x, r


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# each case: (name, port call, TPU call), both on the same numpy inputs
def _cases():
    x, r = _draw()
    k = np.arange(-20, 21)
    x2 = np.stack([x, x[::-1]])
    return {
        "matlab_mod": (lambda: (tdsp.matlab_mod(_t(r), 3.5),
                                tdsp.matlab_mod(_t(k), 7),
                                tdsp.matlab_mod(-7, 3),
                                tdsp.matlab_mod(2.5, 0)),
                       lambda: (jdsp.matlab_mod(r, 3.5),
                                jdsp.matlab_mod(k, 7),
                                jdsp.matlab_mod(-7, 3),
                                jdsp.matlab_mod(2.5, 0))),
        "wrap": (lambda: tdsp.wrap(_t(r), -np.pi, np.pi),
                 lambda: jdsp.wrap(r, -np.pi, np.pi)),
        "sigpower": (lambda: (tdsp.sigpower(_t(x)), tdsp.sigpower(_t(r))),
                     lambda: (jdsp.sigpower(x), jdsp.sigpower(r))),
        "db10": (lambda: tdsp.db10(_t(np.abs(r) + 0.1)),
                 lambda: jdsp.db10(np.abs(r) + 0.1)),
        "udb10": (lambda: tdsp.udb10(_t(r)), lambda: jdsp.udb10(r)),
        "idft": (lambda: tdsp.idft(_t(x2)), lambda: jdsp.idft(x2)),
        "fshift": (lambda: tdsp.fshift(_t(x), 1234.5, FS),
                   lambda: jdsp.fshift(x, 1234.5, FS)),
        "tshift": (lambda: (tdsp.tshift(_t(x2), 5), tdsp.tshift(_t(x), -3)),
                   lambda: (jdsp.tshift(x2, 5), jdsp.tshift(x, -3))),
        # the TPU package's device interpft against the port's one host
        # version: even and odd lengths, integer and non-integer ratios
        "interpft": (lambda: (tdsp.interpft_host(x, 4 * 96),
                              tdsp.interpft_host(x[:95], 200),
                              tdsp.interpft_host(x2, 48)),
                     lambda: (jdsp.interpft(x, 4 * 96),
                              jdsp.interpft(x[:95], 200),
                              jdsp.interpft(x2, 48))),
        "interpft_host": (lambda: (tdsp.interpft_host(x, 4 * 96),
                                   tdsp.interpft_host(x[:95], 200)),
                          lambda: (jdsp.interpft_host(x, 4 * 96),
                                   jdsp.interpft_host(x[:95], 200))),
        "chi2cdf": (lambda: (tdsp.chi2cdf(_t(np.abs(r)), 4),
                             tdsp.chi2cdf(_t(np.abs(r) * 3), 23.0)),
                    lambda: (jdsp.chi2cdf(np.abs(r), 4),
                             jdsp.chi2cdf(np.abs(r) * 3, 23.0))),
        "extract_center_subcarriers": (
            lambda: (tdsp.extract_center_subcarriers(_t(np.resize(x, 128)),
                                                     62),
                     tdsp.extract_center_subcarriers(
                         _t(np.resize(x2, (2, 128))), 72)),
            lambda: (jdsp.extract_center_subcarriers(np.resize(x, 128), 62),
                     jdsp.extract_center_subcarriers(
                         np.resize(x2, (2, 128)), 72))),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_dsp_helper_matches_the_tpu_package(name):
    port, tpu = _cases()[name]
    got, want = port(), tpu()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        assert np.iscomplexobj(g) == np.iscomplexobj(w)
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= 1e-12 * scale, name


def test_channel_resampler_uses_the_dsp_interpft():
    """sim/channel.py resamples through ops/dsp.py::interpft_host and
    keeps the TPU package's channel bit for bit."""
    from lte_cell_scanner_tpu.sim import channel as jch
    from lte_cell_scanner_tpu_torch.sim import channel as tch
    x, _ = _draw(4, 2000)
    pos = np.linspace(0, 1990, 777)
    np.testing.assert_array_equal(
        tch.apply_clock_offset_positions(x, pos, 8),
        jch.apply_clock_offset_positions(x, pos, 8))


def _sig(ms=120, seed=0):
    rng = np.random.default_rng(seed)
    sig = create_dl_sig(CpType.NORMAL, ms, 0, 92, 1, 0.3, rng=rng)
    return awgn(sig, 15.0, rng=rng)


def _drop(sig, n=50):
    cut = len(sig) // 2
    return np.concatenate([sig[:cut], sig[cut + n:]])


def test_sync_template_matches_the_tpu_package():
    for cell, k, f_off in ((277, 1.0, 0.0), (42, (FC - 35e3) / FC, 35e3)):
        got = tdiag.build_sync_template(cell, FS, k, f_off)
        want = jdiag.build_sync_template(cell, FS, k, f_off)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["clean", "dropped", "wrong_cell"])
def test_check_capture_matches_the_tpu_package(kind):
    sig = _sig(seed=1)
    cell = 42 if kind == "wrong_cell" else 277
    if kind == "dropped":
        sig = _drop(sig)
    got = tdiag.check_capture(sig, FC, 0.0, FS, cell, device="cpu")
    want = jdiag.check_capture(sig, FC, 0.0, FS, cell)
    assert [vars(p) for p in got.peaks] == [vars(p) for p in want.peaks]
    assert got.missing == want.missing
    assert got.n_samples == want.n_samples
    assert got.expected_period == want.expected_period
    assert abs(got.peak_power_db - want.peak_power_db) <= 1e-4
    assert got.sync_found() == want.sync_found() == (kind != "wrong_cell")
    if kind == "dropped":
        assert any(abs(p.n_dropped) >= 40 for p in got.peaks)
    if kind == "clean":
        assert len(got.peaks) >= 8 and got.worst_drop() <= 2


@pytest.fixture(scope="module")
def check_files(tmp_path_factory):
    """The two-cell capture as a u8 file (ADC grid), and a 120 ms
    single-cell capture with 50 samples dropped as an .it file."""
    d = tmp_path_factory.mktemp("check")
    u8 = d / "cap.u8"
    complex_to_iq_u8(adc_quantize(two_cell_capture())).tofile(u8)
    it = d / "drop.it"
    write_itfile(str(it), {"capbuf": _drop(_sig(seed=3)),
                           "fc": np.array([739000000], np.int32)})
    return {"u8": str(u8), "it": str(it)}


@pytest.mark.parametrize("kind,cell,rc", [("u8", 277, 0), ("u8", 42, 1),
                                          ("it", 277, 2)])
def test_check_cli_prints_the_tpu_cli_lines(check_files, kind, cell, rc,
                                            capsys):
    """The u8 file carries the two-cell capture's +35 kHz offset."""
    foff = "35e3" if kind == "u8" else "0"
    argv = ["check", check_files[kind], "-f", "739e6", "--cell-id",
            str(cell), "--foff", foff]
    got = cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    want = jcli.main(["--platform", "cpu"] + argv)
    jout = capsys.readouterr().out
    assert got == want == rc
    assert out.splitlines() == jout.splitlines()
    if rc == 0:
        assert "(capture is CLEAN)" in out


def test_check_cli_errors(tmp_path, capsys):
    p = tmp_path / "novar.it"
    write_itfile(str(p), {"fc": np.array([739000000], np.int32)})
    argv = ["check", str(p), "-f", "739e6", "--cell-id", "277",
            "--device", "cpu"]
    assert cli.main(argv) == 1
    assert "has no 'capbuf' variable" in capsys.readouterr().err
    assert cli.main(["check", str(tmp_path / "none.u8"), "-f", "739e6",
                     "--cell-id", "277", "--device", "cpu"]) == 1
    assert capsys.readouterr().err.startswith("Error: file not found")
