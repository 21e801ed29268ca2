"""The port's staged SSS/FOE batch API (models/sss_detect.py:
sss_detect_batch, pss_sss_foe_batch, their _multi forms over a capture
stack, and the public helpers extract_dft_segments, sss_detect_getce_sss,
sss_detect_ml) against the TPU package on the CPU in complex128, and
the staged pair against the port's fused path.

Tolerances: n_id_1 and CP exact, frame_start 1e-9 samples, freq_fine
1e-8 Hz, the helpers' outputs 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import Cell as JCell
from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.models import search as js
from lte_cell_scanner_tpu.models import sss_detect as jsd
from lte_cell_scanner_tpu.sim import awgn, create_dl_sig
from lte_cell_scanner_tpu_torch.interop import cell_from_fields
from lte_cell_scanner_tpu_torch.models import sss_detect as tsd
from lte_cell_scanner_tpu_torch.sim.scenarios import two_cell_capture

FS = 1.92e6
FC = 739e6
THRESH2 = 3.0
TWO_CELL_F_SET = np.array([30e3, 35e3, 40e3])


def _port(cells):
    return [cell_from_fields(dataclasses.asdict(c)) for c in cells]


def _jax_peaks(cap, f_set, fc):
    res = js.xcorr_pss(cap, f_set, 2, fc, fc, FS, lean=True,
                       corr_backend="xla")
    z = js.compute_z_th1(res.sp_incoherent, res.n_comb_xc)
    return js.peak_search(res.xc_incoherent_collapsed_pow,
                          res.xc_incoherent_collapsed_frq, z, f_set, fc, fc,
                          None, 2, refine_slab=res.refine_slab)


@pytest.fixture(scope="module")
def two_cell():
    cap = two_cell_capture(seed=0, f_off=35e3, fc=FC)
    peaks = _jax_peaks(cap, TWO_CELL_F_SET, FC)
    assert peaks
    return cap, peaks


def _same_decisions(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.n_id_1, g.n_id_2, g.cp_type.value) == \
            (r.n_id_1, r.n_id_2, r.cp_type.value)
        if r.n_id_1 >= 0:
            assert abs(g.frame_start - r.frame_start) <= 1e-9


def _same_foe(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert abs(g.freq_fine - r.freq_fine) <= 1e-8


def test_staged_pair_matches_tpu_package_on_two_cells(two_cell):
    cap, peaks = two_cell
    ref = jsd.sss_detect_batch(peaks, cap, THRESH2, FC, FC, FS)
    got = tsd.sss_detect_batch(_port(peaks), cap, THRESH2, FC, FC, FS,
                               device="cpu")
    _same_decisions(got, ref)
    acc_ref = [c for c in ref if c.n_id_1 >= 0]
    acc_got = [c for c in got if c.n_id_1 >= 0]
    assert {c.n_id_cell() for c in acc_got} >= {277, 271}
    _same_foe(tsd.pss_sss_foe_batch(acc_got, torch.from_numpy(cap), FC, FC,
                                    FS),
              jsd.pss_sss_foe_batch(acc_ref, cap, FC, FC, FS))


def test_staged_pair_matches_fused_path(two_cell):
    """The port's staged pair against its fused path on the same peaks
    (the TPU package's tests/test_sss_detect.py holds its own pair so on
    the reference's capture)."""
    cap, peaks = two_cell
    cells = _port(peaks)
    cap_t = torch.from_numpy(cap)
    staged = tsd.sss_detect_batch(cells, cap_t, THRESH2, FC, FC, FS)
    accepted = [c for c in staged if c.n_id_1 >= 0]
    foe = iter(tsd.pss_sss_foe_batch(accepted, cap_t, FC, FC, FS))
    staged = [next(foe) if c.n_id_1 >= 0 else c for c in staged]
    fused = tsd.sss_foe_batch_fused(cells, cap_t[None], [0] * len(cells),
                                    THRESH2, FS)
    _same_decisions(staged, fused)
    _same_foe([c for c in staged if c.n_id_1 >= 0],
              [c for c in fused if c.n_id_1 >= 0])


def _ragged():
    """tests/test_sss_detect.py:83-113: one peak at 3000 ppm, whose
    location list outgrows the capture-length pad capacity."""
    rng = np.random.default_rng(7)
    capbuf = (rng.normal(size=40000) + 1j * rng.normal(size=40000)) * 0.1
    fc = 739e6
    peaks = [JCell(fc_requested=fc, fc_programmed=fc, pss_pow=0.1, ind=4000,
                   freq=0.0, n_id_2=1),
             JCell(fc_requested=fc, fc_programmed=fc, pss_pow=0.1, ind=4000,
                   freq=fc * 3000e-6, n_id_2=2)]
    return capbuf, peaks, fc


def test_ragged_batch_matches_tpu_package_and_serial_path():
    capbuf, peaks, fc = _ragged()
    cap_t = torch.from_numpy(capbuf)
    ref = jsd.sss_detect_batch(peaks, capbuf, -1e9, fc, fc, FS)
    got = tsd.sss_detect_batch(_port(peaks), cap_t, -1e9, fc, fc, FS)
    serial = [tsd.sss_detect(p, cap_t, -1e9, fc, fc, FS)
              for p in _port(peaks)]
    _same_decisions(got, ref)
    _same_decisions(got, serial)
    assert all(c.n_id_1 >= 0 for c in got)
    ref_f = jsd.pss_sss_foe_batch(ref, capbuf, fc, fc, FS)
    got_f = tsd.pss_sss_foe_batch(got, cap_t, fc, fc, FS)
    _same_foe(got_f, ref_f)
    _same_foe(got_f, [tsd.pss_sss_foe(c, cap_t, fc, fc, FS) for c in got])


def test_multi_pair_matches_tpu_package_on_two_carriers():
    """The two-carrier stack of tests/test_carriers.py:91-120, each
    carrier's peaks reading its own row of the stack."""
    rng = np.random.default_rng(3)
    sig_a = awgn(create_dl_sig(JCpType.NORMAL, 80, 0, 92, 1, 0.5, rng=rng,
                               n_ports=2, sfn=0), 10.0, rng=rng)
    sig_b = awgn(create_dl_sig(JCpType.NORMAL, 80, 0, 90, 1, 0.5, rng=rng,
                               n_ports=1, sfn=4), 10.0, rng=rng)
    f_set = np.arange(-10e3, 10e3 + 1, 5e3)
    peaks, ci = [], []
    for k, (sig, fc) in enumerate([(sig_a, 739e6), (sig_b, 739.1e6)]):
        p = _jax_peaks(sig, f_set, fc)
        peaks += p
        ci += [k] * len(p)
    stack = np.stack([sig_a, sig_b])
    ref = jsd.sss_detect_batch_multi(peaks, stack, ci, THRESH2, FS)
    got = tsd.sss_detect_batch_multi(_port(peaks), stack, ci, THRESH2, FS,
                                     device="cpu")
    _same_decisions(got, ref)
    keep = [i for i, c in enumerate(ref) if c.n_id_1 >= 0]
    assert {got[i].n_id_cell() for i in keep} >= {277, 271}
    ci_acc = [ci[i] for i in keep]
    ref_f = jsd.pss_sss_foe_batch_multi([ref[i] for i in keep], stack,
                                        ci_acc, FS)
    got_f = tsd.pss_sss_foe_batch_multi([got[i] for i in keep],
                                        torch.from_numpy(stack), ci_acc, FS)
    _same_foe(got_f, ref_f)


def test_empty_batches_return_empty():
    cap = torch.zeros(40000, dtype=torch.complex128)
    assert tsd.sss_detect_batch([], cap, THRESH2, FC, FC, FS) == []
    assert tsd.pss_sss_foe_batch([], cap, FC, FC, FS) == []
    assert tsd.sss_detect_batch_multi([], cap[None], [], THRESH2, FS) == []
    assert tsd.pss_sss_foe_batch_multi([], cap[None], [], FS) == []


def test_public_helpers_match_tpu_package(two_cell):
    cap, peaks = two_cell
    peak = max(peaks, key=lambda c: c.pss_pow)
    cell = _port([peak])[0]
    cap_t = torch.from_numpy(cap)

    locs = np.array([200, 9800, 19400, 150000])
    ref = np.asarray(jsd.extract_dft_segments(cap, locs, -35e3, FS))
    got = tsd.extract_dft_segments(cap_t, locs, -35e3, FS).numpy()
    assert got.shape == (4, 62)
    assert np.max(np.abs(got - ref)) <= 1e-12

    ref_ce = jsd.sss_detect_getce_sss(peak, cap, FC, FC, FS)
    got_ce = tsd.sss_detect_getce_sss(cell, cap, FC, FC, FS, device="cpu")
    assert len(got_ce) == 6
    for g, r in zip(got_ce, ref_ce):
        assert g.shape == (62,)
        assert np.max(np.abs(g.numpy() - np.asarray(r))) <= 1e-12

    ref_ll = jsd.sss_detect_ml(peak, *ref_ce)
    got_ll = tsd.sss_detect_ml(cell, *got_ce)
    for g, r in zip(got_ll, ref_ll):
        assert g.shape == (168, 2)
        r = np.asarray(r)
        assert np.max(np.abs(g.numpy() - r)) <= 1e-12 * np.max(np.abs(r))

    # the helpers compose to sss_detect's own tables
    _c, extras = tsd.sss_detect(cell, cap_t, THRESH2, FC, FC, FS,
                                return_extras=True)
    np.testing.assert_array_equal(extras["log_lik_nrm"], got_ll[0].numpy())
    np.testing.assert_array_equal(extras["log_lik_ext"], got_ll[1].numpy())


def test_fused_path_checks_every_sss_window_of_its_device_plan(monkeypatch):
    """On the card the fused path plans the FOE's SSS windows in float32.
    On the band's 739 MHz capture (sim/scenarios.py::band_captures) the
    float32 plan of one weak extended-CP peak puts window 9 of 16 one
    sample after the float64 host plan while the decision, the PSS-SSS
    distance and the window count all agree; the device M then sits
    38 Hz from the staged FOE.  The host must catch it and re-run that
    peak's FOE staged.  The CPU emulates the card's working types."""
    from lte_cell_scanner_tpu_torch import device as tdevice
    from lte_cell_scanner_tpu_torch.cell import Cell
    from lte_cell_scanner_tpu_torch.models.search import SearchConfig
    from lte_cell_scanner_tpu_torch.sim.channel import awgn as tawgn
    from lte_cell_scanner_tpu_torch.sim.scenarios import (SNR_DB,
                                                          _two_cell_signal,
                                                          band_offset)
    rng = np.random.default_rng(1)
    cap = tawgn(_two_cell_signal(rng, band_offset(FC), FC), SNR_DB, rng=rng)
    peak = Cell(fc_requested=FC, fc_programmed=FC, ind=3789, freq=30000.0,
                n_id_2=2)
    th = SearchConfig().thresh2_n_sigma
    cap_t = torch.from_numpy(cap)
    ref = tsd.pss_sss_foe(tsd.sss_detect(peak, cap_t, th, FC, FC, FS),
                          cap_t, FC, FC, FS)
    assert ref.n_id_1 == 112 and ref.cp_type is tsd.CpType.EXTENDED

    monkeypatch.setattr(tdevice, "complex_dtype", lambda d: torch.complex64)
    monkeypatch.setattr(tdevice, "real_dtype", lambda d: torch.float32)
    got = tsd.sss_foe_batch_fused([peak], cap_t.to(torch.complex64)[None],
                                  [0], th, FS)[0]
    assert (got.n_id_1, got.cp_type) == (ref.n_id_1, ref.cp_type)
    assert abs(got.freq_fine - ref.freq_fine) < 1e-3
