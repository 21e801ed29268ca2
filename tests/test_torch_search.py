"""The port's single-carrier cell search (lte_cell_scanner_tpu_torch/
models/search.py) against the TPU package's, end to end on the CPU.

Sim captures made with numpy from fixed seeds go through both
``cell_search`` functions (complex128, the exact correlation on both
sides); every decoded field must agree, the frequency estimates within
the reference tolerances (freq_fine 1e-8 Hz, freq_superfine 1e-7 Hz).
"""

import dataclasses

import numpy as np
import pytest

from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.models import search as js
from lte_cell_scanner_tpu.sim import apply_freq_offset, awgn, create_dl_sig
from lte_cell_scanner_tpu_torch import cli
from lte_cell_scanner_tpu_torch.interop import config_from_fields
from lte_cell_scanner_tpu_torch.models import search as ts
from lte_cell_scanner_tpu_torch.sim.scenarios import (TWO_CELL_TRUTH,
                                                      two_cell_capture)

FS = 1.92e6
FC = 739e6
F_SET = np.arange(-10e3, 10e3 + 1, 5e3)


def _sim(cp_type, n_ports, seed=1, f_off=2500.0):
    rng = np.random.default_rng(seed)
    sig = create_dl_sig(cp_type, 80, 0, 92, 1, 0.5, rng=rng,
                        n_ports=n_ports, sfn=256)
    return awgn(apply_freq_offset(sig, f_off), 10.0, rng=rng)


def _both(capbuf, f_set, decode=True):
    jcfg = js.SearchConfig(decode=decode)
    ref = js.cell_search(capbuf, f_set, FC, FC, FS, jcfg)
    got = ts.cell_search(capbuf, f_set, FC, FC, FS,
                         config_from_fields(dataclasses.asdict(jcfg)),
                         device="cpu")
    return ref, got


def _assert_same_cells(ref, got, decode=True):
    assert len(got) == len(ref) >= 1
    for r, g in zip(ref, got):
        assert (g.n_id_1, g.n_id_2, g.cp_type.value, g.ind, g.freq) == \
            (r.n_id_1, r.n_id_2, r.cp_type.value, r.ind, r.freq)
        assert abs(g.pss_pow - r.pss_pow) <= 1e-8 * r.pss_pow
        assert abs(g.frame_start - r.frame_start) < 1e-9
        assert abs(g.freq_fine - r.freq_fine) < 1e-8
        if decode:
            assert (g.n_rb_dl, g.n_ports, g.sfn) == \
                (r.n_rb_dl, r.n_ports, r.sfn)
            assert (g.phich_duration.value, g.phich_resource.value) == \
                (r.phich_duration.value, r.phich_resource.value)
            assert abs(g.freq_superfine - r.freq_superfine) < 1e-7
        else:
            assert np.isnan(g.freq_superfine) and g.n_rb_dl == r.n_rb_dl


@pytest.mark.parametrize("cp_type,n_ports", [
    (JCpType.NORMAL, 1),
    (JCpType.NORMAL, 2),
    (JCpType.NORMAL, 4),
    (JCpType.EXTENDED, 2),
    (JCpType.EXTENDED, 4),
])
def test_cell_search_matches_tpu_package(cp_type, n_ports):
    ref, got = _both(_sim(cp_type, n_ports), F_SET)
    _assert_same_cells(ref, got)
    best = max(got, key=lambda c: c.pss_pow)
    assert best.n_id_cell() == 277
    assert best.cp_type.value == cp_type.value
    assert (best.n_rb_dl, best.n_ports) == (6, n_ports)
    assert best.sfn in (256, 257)


def test_detection_without_decode_matches_tpu_package():
    ref, got = _both(_sim(JCpType.NORMAL, 2, seed=5, f_off=-4000.0), F_SET,
                     decode=False)
    _assert_same_cells(ref, got, decode=False)


def test_two_cell_capture_matches_tpu_package():
    """The capture chip_smoke.py drives on the card: cells 277 and 271
    at about +35 kHz through the coupled crystal offset."""
    f_set = np.arange(25e3, 45e3 + 1, 5e3)
    ref, got = _both(two_cell_capture(), f_set)
    _assert_same_cells(ref, got)
    assert sorted(c.n_id_cell() for c in got) == sorted(TWO_CELL_TRUTH)
    for c in got:
        truth = TWO_CELL_TRUTH[c.n_id_cell()]
        assert (c.n_rb_dl, c.n_ports) == (6, truth["n_ports"])
        assert c.sfn in (truth["sfn"], truth["sfn"] + 1)
        assert abs(c.freq_superfine - 35e3) < 50.0


def test_dedup_keeps_the_strongest_detection():
    ref, got = _both(_sim(JCpType.NORMAL, 2), F_SET)

    def halved(cells):
        return [dataclasses.replace(c, pss_pow=c.pss_pow / 2) for c in cells]

    merged = ts.dedup([halved(got), got])
    merged_ref = js.dedup([halved(ref), ref])
    assert [c.n_id_cell() for c in merged] == \
        [c.n_id_cell() for c in merged_ref]
    assert [c.pss_pow for c in merged] == [c.pss_pow for c in got]


@pytest.mark.parametrize("field,value", [
    ("search_mesh", None),
])
def test_config_from_fields_refuses_unported_behaviour(field, value):
    """A field the port's SearchConfig does not have is refused, never
    dropped."""
    fields = dataclasses.asdict(js.SearchConfig())
    fields[field] = value
    with pytest.raises(ValueError, match=field):
        config_from_fields(fields)


def test_config_from_fields_carries_every_field():
    """Both SearchConfigs have the same fields, and the TPU package's
    defaults cross as the port's."""
    assert {f.name for f in dataclasses.fields(ts.SearchConfig)} == \
        {f.name for f in dataclasses.fields(js.SearchConfig)}
    assert config_from_fields(dataclasses.asdict(js.SearchConfig())) \
        == ts.SearchConfig()


@pytest.mark.parametrize("field,value", [
    ("interp", "2stage"),
    ("compat", "golden"),
    ("batch_peaks", False),
    ("skip_ids", frozenset({277})),
])
def test_config_from_fields_carries_search_variants(field, value):
    fields = dataclasses.asdict(js.SearchConfig())
    fields[field] = value
    cfg = config_from_fields(fields)
    assert getattr(cfg, field) == value
    assert dataclasses.replace(cfg, **{field: getattr(ts.SearchConfig(),
                                                      field)}) \
        == ts.SearchConfig()


def test_cli_search_on_a_sim_capture(capsys):
    assert cli.main(["search", "-s", "739e6", "--sim", "--device", "cpu",
                     "-p", "5", "--sim-foff", "1200"]) == 0
    out = capsys.readouterr().out
    assert "Detected the following cells:" in out
    rows = [ln for ln in out.splitlines() if ln.startswith("277 ")]
    assert len(rows) == 1
    assert rows[0].split()[1] == "2"            # antenna ports
    assert " N   6 N one " in rows[0]
