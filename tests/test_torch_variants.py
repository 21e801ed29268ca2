"""The port's search variants against the TPU package on the CPU:
SearchConfig's compat="golden" (models/sss_detect.py), the 2-stage and
frequency-then-time interpolators (models/chan_est.py, ops/dsp.py
interp1) with decode_mib, the peak-at-a-time batch_peaks=False
(models/search.py::refine_peaks, parallel/carriers.py), and
sim/channel.py::multipath_channel.

Tolerances (complex128 on both sides): SSS log-likelihoods within 1e-12
of their largest magnitude, frame_start 1e-9, freq_fine 1e-8 Hz; channel
estimates and noise estimates 1e-10; freq_superfine 1e-7 Hz; cell IDs,
CP, MIB fields and random draws exact.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import Cell as JCell
from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.models import chan_est as jce
from lte_cell_scanner_tpu.models import mib as jmib
from lte_cell_scanner_tpu.models import search as js
from lte_cell_scanner_tpu.models import sss_detect as jsd
from lte_cell_scanner_tpu.models import tfg as jtfg
from lte_cell_scanner_tpu.models.rs import RsDl as JRsDl
from lte_cell_scanner_tpu.ops import dsp as jdsp
from lte_cell_scanner_tpu.sim import apply_freq_offset, awgn, create_dl_sig
from lte_cell_scanner_tpu.sim import multipath_channel as j_multipath
from lte_cell_scanner_tpu.utils.itfile import read_itfile
from lte_cell_scanner_tpu_torch.cell import Cell, CpType
from lte_cell_scanner_tpu_torch.interop import (cell_from_fields,
                                                config_from_fields)
from lte_cell_scanner_tpu_torch.models import chan_est as tce
from lte_cell_scanner_tpu_torch.models import decode as tdec
from lte_cell_scanner_tpu_torch.models import search as ts
from lte_cell_scanner_tpu_torch.models import sss_detect as tsd
from lte_cell_scanner_tpu_torch.models.rs import RsDl
from lte_cell_scanner_tpu_torch.ops.dsp import interp1
from lte_cell_scanner_tpu_torch.sim import multipath_channel

FS = 1.92e6
FC = 739e6
F_SET = np.array([-5e3, 0.0, 5e3])
VEC = pathlib.Path(__file__).parent / "vectors"


def _port(cells):
    return [cell_from_fields(dataclasses.asdict(c)) for c in cells]


def test_interp1_matches_tpu_package():
    """Inside, on the knots and outside both edges (extrapolated from the
    edge segments, not clamped), batched over rows with their own knots."""
    rng = np.random.default_rng(0)
    X = np.cumsum(rng.uniform(0.5, 2.0, size=(4, 9)), axis=1)
    Y = rng.normal(size=(4, 9)) + 1j * rng.normal(size=(4, 9))
    x = np.linspace(-3.0, 25.0, 61)
    got = interp1(torch.from_numpy(X), torch.from_numpy(Y),
                  torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(jdsp.interp1(X[i], Y[i], x))
                     for i in range(4)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def tfg_comp():
    """The compensated grid of tests/vectors/test_tfg.it (cell 277 of
    the reference's air capture: 50 RB, 2 ports, SFN 649) and its cells
    in both packages."""
    gold = read_itfile(str(VEC / "test_tfg.it"))
    kw = dict(fc_requested=FC, fc_programmed=FC, ind=8674, freq=40e3,
              n_id_2=1, n_id_1=92, frame_start=17448.525,
              freq_fine=39684.0775)
    jc = JCell(cp_type=JCpType.NORMAL, **kw)
    jc, comp, _ = jtfg.tfoec(jc, gold["tfg"], gold["tfg_timestamp"], FC, FC,
                             JRsDl(277, 6, JCpType.NORMAL))
    comp = np.array(comp)
    return jc, cell_from_fields(dataclasses.asdict(jc)), comp


@pytest.mark.parametrize("interp", ["hex", "2stage", "freq_time"])
def test_chan_est_and_mib_match_tpu_package(tfg_comp, interp):
    """All four ports' CE arrays and noise estimates within 1e-10, then
    the blind MIB equal to the TPU package's decode_mib (its CE through
    its own MIB program) and to the vector's."""
    jc, tc, comp = tfg_comp
    jrs, trs = JRsDl(277, 6, JCpType.NORMAL), RsDl(277, 6, CpType.NORMAL)
    comp_t = torch.from_numpy(comp)
    j_ce, j_np = [], []
    for port in range(4):
        ce, npv = jce.chan_est(jc, jrs, comp, port, interp)
        got, got_np = tce.chan_est(tc, trs, comp_t, port, interp)
        assert got.shape == (comp.shape[0], 72)
        assert np.max(np.abs(got.numpy() - np.asarray(ce))) <= 1e-10
        assert abs(float(got_np) - float(npv)) <= 1e-10
        j_ce.append(ce)
        j_np.append(npv)
    rows, cols, scr, crc_m, flen = jmib._mib_device_args(jc)
    c_all, crc_all = jmib._mib_candidates(
        comp, np.stack(j_ce), np.stack(j_np), rows, cols, scr, crc_m, flen)
    want = jmib._scan_mib_results(jc, np.asarray(c_all), np.asarray(crc_all))
    got = tdec.decode_mib(tc, comp_t, trs, interp=interp)
    fields = ("n_rb_dl", "n_ports", "sfn")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields] == [50, 2, 649]
    assert (got.phich_duration.value, got.phich_resource.value) == \
        (want.phich_duration.value, want.phich_resource.value)


def _peaks(cp_type, seed=4):
    rng = np.random.default_rng(seed)
    sig = create_dl_sig(cp_type, 30, 0, 60, 2, 0.5, rng=rng, n_ports=2)
    cap = awgn(apply_freq_offset(sig, -3300.0), 3.0, rng=rng)
    res = js.xcorr_pss(cap, F_SET, 2, FC, FC, FS, lean=True,
                       corr_backend="xla")
    z = js.compute_z_th1(res.sp_incoherent, res.n_comb_xc)
    peaks = js.peak_search(res.xc_incoherent_collapsed_pow,
                           res.xc_incoherent_collapsed_frq, z, F_SET, FC,
                           FC, None, 2, refine_slab=res.refine_slab)
    assert peaks
    return cap, peaks


@pytest.mark.parametrize("cp_type", [JCpType.NORMAL, JCpType.EXTENDED])
def test_golden_sss_detect_and_foe_match_tpu_package(cp_type):
    """The per-peak sss_detect (with its extras) and pss_sss_foe in
    golden compat, peak by peak."""
    cap, peaks = _peaks(cp_type)
    cap_t = torch.from_numpy(cap)
    accepted = 0
    for p in peaks:
        ref, rx = jsd.sss_detect(p, cap, 3.0, FC, FC, FS,
                                 return_extras=True, compat="golden")
        got, gx = tsd.sss_detect(_port([p])[0], cap_t, 3.0, FC, FC, FS,
                                 return_extras=True, compat="golden")
        assert sorted(gx) == sorted(rx)
        for k in ("log_lik_nrm", "log_lik_ext"):
            assert np.max(np.abs(gx[k] - rx[k])) <= \
                1e-12 * np.max(np.abs(rx[k]))
        for k in rx:
            np.testing.assert_allclose(gx[k], rx[k], rtol=1e-10, atol=0)
        assert (got.n_id_1, got.cp_type.value) == \
            (ref.n_id_1, ref.cp_type.value)
        if ref.n_id_1 < 0:
            continue
        accepted += 1
        assert abs(got.frame_start - ref.frame_start) < 1e-9
        jf = jsd.pss_sss_foe(ref, cap, FC, FC, FS, compat="golden")
        tf = tsd.pss_sss_foe(got, cap_t, FC, FC, FS, compat="golden")
        assert abs(tf.freq_fine - jf.freq_fine) < 1e-8
    assert accepted >= 1


@pytest.mark.parametrize("cp_type", [JCpType.NORMAL, JCpType.EXTENDED])
def test_golden_fused_sss_foe_has_no_fallback(cp_type, monkeypatch):
    """The fused pass re-derives golden's decision and timing plan on the
    device; at float64 every peak's plan agrees with the host's, so no
    peak falls back to the staged FOE, and the results equal the TPU
    package's."""
    cap, peaks = _peaks(cp_type)
    staged = []
    monkeypatch.setattr(tsd, "pss_sss_foe",
                        lambda *a, **k: staged.append(a) or None)
    ref = jsd.sss_foe_batch_fused(peaks, cap, 3.0, FS, compat="golden")
    got = tsd.sss_foe_batch_fused(_port(peaks), torch.from_numpy(cap)[None],
                                  [0] * len(peaks), 3.0, FS,
                                  compat="golden")
    assert staged == []
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert (g.n_id_1, g.cp_type.value) == (r.n_id_1, r.cp_type.value)
        if r.n_id_1 >= 0:
            assert abs(g.frame_start - r.frame_start) < 1e-9
            assert abs(g.freq_fine - r.freq_fine) < 1e-8
    skipped = tsd.sss_foe_batch_fused(
        _port(peaks), torch.from_numpy(cap)[None], [0] * len(peaks), 3.0,
        FS, compat="golden",
        skip_ids=frozenset(c.n_id_cell() for c in got if c.n_id_1 >= 0))
    assert all(np.isnan(c.freq_fine) for c in skipped)


def _sim(seed=1, f_off=2500.0, channel=None):
    rng = np.random.default_rng(seed)
    sig = create_dl_sig(JCpType.NORMAL, 80, 0, 92, 1, 0.5, rng=rng,
                        n_ports=2, sfn=40)
    if channel:
        sig = channel(sig, rng=rng)
    return awgn(apply_freq_offset(sig, f_off), 10.0, rng=rng)


def _assert_same_cells(ref, got):
    assert len(got) == len(ref) >= 1
    for r, g in zip(ref, got):
        assert (g.n_id_1, g.n_id_2, g.cp_type.value, g.ind, g.n_rb_dl,
                g.n_ports, g.sfn) == (r.n_id_1, r.n_id_2, r.cp_type.value,
                                      r.ind, r.n_rb_dl, r.n_ports, r.sfn)
        assert abs(g.frame_start - r.frame_start) < 1e-9
        assert abs(g.freq_fine - r.freq_fine) < 1e-8
        assert abs(g.freq_superfine - r.freq_superfine) < 1e-7


@pytest.mark.parametrize("kw", [
    {"compat": "golden"},
    {"batch_peaks": False},
    {"interp": "freq_time"},
], ids=["golden", "peak-at-a-time", "freq_time"])
def test_cell_search_variants_match_tpu_package(kw):
    jcfg = js.SearchConfig(**kw)
    cap = _sim()
    ref = js.cell_search(cap, F_SET, FC, FC, FS, jcfg)
    got = ts.cell_search(cap, F_SET, FC, FC, FS,
                         config_from_fields(dataclasses.asdict(jcfg)),
                         device="cpu")
    _assert_same_cells(ref, got)
    assert max(got, key=lambda c: c.pss_pow).n_id_cell() == 277


@pytest.mark.parametrize("interp", ["hex", "2stage"])
def test_peak_at_a_time_equals_batched(interp):
    """refine_peaks(batch_peaks=False) gives the batched result on one
    capture's peaks, and so does the band's back half (whose per-carrier
    branch it is)."""
    from lte_cell_scanner_tpu_torch.models.peaks import peak_search
    from lte_cell_scanner_tpu_torch.models.xcorr import xcorr_pss
    from lte_cell_scanner_tpu_torch.parallel.carriers import \
        _refine_from_peaks
    cap = _sim(seed=3, f_off=-1200.0)
    cap_t = torch.from_numpy(cap)
    res = xcorr_pss(cap, F_SET, 2, FC, FC, FS, lean=True, device="cpu")
    peaks = peak_search(res.xc_incoherent_collapsed_pow,
                        res.xc_incoherent_collapsed_frq,
                        ts.compute_z_th1(res.sp_incoherent, res.n_comb_xc),
                        F_SET, FC, FC, None, 2, refine_slab=res.refine_slab)
    cells = {}
    for batch in (True, False):
        cfg = ts.SearchConfig(interp=interp, batch_peaks=batch)
        cells[batch] = [
            ts.refine_peaks(peaks, cap_t, FC, FC, FS, cfg),
            _refine_from_peaks(peaks, [0] * len(peaks), cap_t[None], [FC],
                               [FC], FS, cfg)[0]]
    for b, s in zip(cells[True], cells[False]):
        assert [(c.n_id_cell(), c.ind, c.n_rb_dl, c.sfn) for c in s] == \
            [(c.n_id_cell(), c.ind, c.n_rb_dl, c.sfn) for c in b]
        for x, y in zip(b, s):
            assert abs(x.freq_superfine - y.freq_superfine) < 1e-9
    assert 277 in [c.n_id_cell() for c in cells[True][0]]


def test_multipath_channel_is_bit_equal():
    sig = _sim()[:5000]
    got = multipath_channel(sig, n_taps=4, delay_spread=1.5,
                            rng=np.random.default_rng(17))
    want = j_multipath(sig, n_taps=4, delay_spread=1.5,
                       rng=np.random.default_rng(17))
    np.testing.assert_array_equal(got, want)


def test_multipath_capture_decodes_with_every_interpolator():
    """A 4-tap Rayleigh channel tells a right hex-filter window parity
    from an inverted one (a flat channel cannot): every interpolator
    decodes the MIB, the hex one equal to the TPU package's."""
    cap = _sim(seed=17, f_off=0.0, channel=multipath_channel)
    ref = js.cell_search(cap, F_SET, FC, FC, FS, js.SearchConfig())
    for interp in ("hex", "2stage", "freq_time"):
        got = ts.cell_search(cap, F_SET, FC, FC, FS,
                             ts.SearchConfig(interp=interp), device="cpu")
        best = max(got, key=lambda c: c.pss_pow)
        assert (best.n_id_cell(), best.n_rb_dl, best.n_ports) == \
            (277, 6, 2), interp
        assert best.sfn in (40, 41), interp
        if interp == "hex":
            _assert_same_cells(ref, got)
