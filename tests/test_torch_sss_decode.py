"""The port's SSS detection / fine FOE (models/sss_detect.py) and decode
back half (models/tfg.py, chan_est.py, mib.py, decode.py) against the
TPU package on the CPU, stage by stage: the TPU package's peak list is
handed to the port through lte_cell_scanner_tpu_torch.interop.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import Cell as JCell
from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.models import search as js
from lte_cell_scanner_tpu.models import sss_detect as jsd
from lte_cell_scanner_tpu.models import tfg as jtfg
from lte_cell_scanner_tpu.models.rs import RsDl as JRsDl
from lte_cell_scanner_tpu.sim import apply_freq_offset, awgn, create_dl_sig
from lte_cell_scanner_tpu.utils.itfile import read_itfile
from lte_cell_scanner_tpu_torch.cell import Cell, CpType
from lte_cell_scanner_tpu_torch.interop import cell_from_fields
from lte_cell_scanner_tpu_torch.models import decode as tdec
from lte_cell_scanner_tpu_torch.models import sss_detect as tsd
from lte_cell_scanner_tpu_torch.models import tfg as ttfg
from lte_cell_scanner_tpu_torch.models.rs import RsDl

FS = 1.92e6
FC = 739e6
F_SET = np.array([-5e3, 0.0, 5e3])
VEC = pathlib.Path(__file__).parent / "vectors"


def _peaks(cp_type, seed):
    rng = np.random.default_rng(seed)
    sig = create_dl_sig(cp_type, 30, 0, 60, 2, 0.5, rng=rng, n_ports=2)
    cap = awgn(apply_freq_offset(sig, -3300.0), 3.0, rng=rng)
    res = js.xcorr_pss(cap, F_SET, 2, FC, FC, FS, lean=True,
                       corr_backend="xla")
    z = js.compute_z_th1(res.sp_incoherent, res.n_comb_xc)
    peaks = js.peak_search(res.xc_incoherent_collapsed_pow,
                           res.xc_incoherent_collapsed_frq, z, F_SET, FC,
                           FC, None, 2, refine_slab=res.refine_slab)
    return cap, peaks


def _port(cells):
    return [cell_from_fields(dataclasses.asdict(c)) for c in cells]


@pytest.mark.parametrize("cp_type", [JCpType.NORMAL, JCpType.EXTENDED])
def test_sss_foe_batch_fused_matches_tpu_package(cp_type):
    cap, peaks = _peaks(cp_type, seed=4)
    assert peaks
    ref = jsd.sss_foe_batch_fused(peaks, cap, 3.0, FS)
    got = tsd.sss_foe_batch_fused(_port(peaks), torch.from_numpy(cap)[None],
                                  [0] * len(peaks), 3.0, FS)
    assert len(got) == len(ref)
    accepted = 0
    for r, g in zip(ref, got):
        assert (g.n_id_1, g.n_id_2, g.cp_type.value) == \
            (r.n_id_1, r.n_id_2, r.cp_type.value)
        if r.n_id_1 < 0:
            continue
        accepted += 1
        assert abs(g.frame_start - r.frame_start) < 1e-9
        assert abs(g.freq_fine - r.freq_fine) < 1e-8
    assert accepted >= 1
    best = max(got, key=lambda c: c.pss_pow)
    assert best.n_id_cell() == 3 * 60 + 2
    assert best.cp_type.value == cp_type.value


def test_staged_fine_foe_matches_tpu_package():
    """The staged pss_sss_foe, the fused path's fallback."""
    cap, peaks = _peaks(JCpType.NORMAL, seed=4)
    cells = [c for c in jsd.sss_foe_batch_fused(peaks, cap, 3.0, FS)
             if c.n_id_1 >= 0]
    for c in cells:
        c0 = dataclasses.replace(c, freq_fine=float("nan"))
        ref = jsd.pss_sss_foe(c0, cap, FC, FC, FS)
        got = tsd.pss_sss_foe(_port([c0])[0], torch.from_numpy(cap), FC, FC,
                              FS)
        assert abs(got.freq_fine - ref.freq_fine) < 1e-8
        assert abs(got.freq_fine - c.freq_fine) < 1e-8


@pytest.fixture(scope="module")
def tfg_vector():
    return read_itfile(str(VEC / "test_tfg.it"))


def _tfg_cell(cls, cp):
    # the peak of the reference's two-cell capture (BASELINE.md): cell
    # 277, normal CP, freq_fine 39684.0775 Hz
    return cls(fc_requested=FC, fc_programmed=FC, ind=8674, freq=40e3,
               n_id_2=1, n_id_1=92, cp_type=cp, frame_start=17448.525,
               freq_fine=39684.0775)


def test_tfoec_and_mib_on_tfg_vector(tfg_vector):
    gold = tfg_vector
    fc = FC
    jcell = _tfg_cell(JCell, JCpType.NORMAL)
    jout, _jcomp, _ = jtfg.tfoec(jcell, gold["tfg"], gold["tfg_timestamp"],
                                 fc, fc, JRsDl(277, 6, JCpType.NORMAL))

    cell = _tfg_cell(Cell, CpType.NORMAL)
    out, comp, ts2 = ttfg.tfoec(cell, torch.from_numpy(gold["tfg"]),
                                gold["tfg_timestamp"], fc, fc,
                                RsDl(277, 6, CpType.NORMAL))
    # reference test tolerances (test_tfg.cpp:87-100)
    assert np.max(np.abs(comp.numpy() - gold["tfg_comp"])) <= 1e-10
    assert np.max(np.abs(ts2 - gold["tfg_comp_timestamp"])) <= 1e-10
    assert abs(out.freq_superfine - jout.freq_superfine) <= 1e-7
    # the vector's freq_superfine rests on the full-precision freq_fine;
    # this cell carries it rounded to 1e-4 Hz
    assert abs(out.freq_superfine - gold["freq_superfine"][0]) < 1e-3

    dec = tdec.decode_mib(out, comp, RsDl(277, 6, CpType.NORMAL))
    assert (dec.n_rb_dl, dec.n_ports, dec.sfn) == tuple(gold["mib"]) \
        == (50, 2, 649)


def test_extract_tfg_matches_tpu_package():
    cap, peaks = _peaks(JCpType.NORMAL, seed=4)
    rng = np.random.default_rng(9)
    cap = np.concatenate([cap, awgn(np.zeros(153600 - len(cap)), 0.0, rng,
                                    signal_power=1e-3)])
    c = max((x for x in jsd.sss_foe_batch_fused(peaks, cap, 3.0, FS)
             if x.n_id_1 >= 0), key=lambda x: x.pss_pow)
    ref, ref_ts = jtfg.extract_tfg(c, cap, FC, FC, FS)
    got, ts = ttfg.extract_tfg(_port([c])[0], torch.from_numpy(cap), FC, FC,
                               FS)
    np.testing.assert_array_equal(ts, ref_ts)
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) <= 1e-10
