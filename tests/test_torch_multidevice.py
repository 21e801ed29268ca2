"""The port's multi-device layouts inside one process against the TPU
package's, on the CPU: the carrier axis over a device list
(``parallel/carriers.py``: make_carrier_mesh, plan_carrier_inputs'
padding, scan_band(mesh=)), the v4 gate's margin, the (t x 1) grid under
``cell_search(mesh=)`` and the tracker's searcher grid.

The TPU package runs on tests/conftest.py's eight virtual CPU devices,
the port on lists and grids that repeat the one CPU device; both in
complex128 on the same numpy inputs.  The cases mirror
tests/test_carriers.py:26-108, :222-247 and tests/test_tracker.py:
485-500.
"""

import jax
import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.models import search as jsearch
from lte_cell_scanner_tpu.ops import corr_pallas as jp
from lte_cell_scanner_tpu.parallel import carriers as jc
from lte_cell_scanner_tpu.parallel import sharded as jsh
from lte_cell_scanner_tpu.sim import apply_freq_offset, awgn, create_dl_sig
from lte_cell_scanner_tpu.tracker import TrackerRunner as JRunner
from lte_cell_scanner_tpu_torch.models import search as tsearch
from lte_cell_scanner_tpu_torch.models.xcorr import xcorr_pss
from lte_cell_scanner_tpu_torch.ops import corr_fold_cuda as tf
from lte_cell_scanner_tpu_torch.parallel import carriers as tc
from lte_cell_scanner_tpu_torch.parallel import sharded as tsh
from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                      two_cell_capture)
from lte_cell_scanner_tpu_torch.tracker import TrackerRunner

FS = 1.92e6
FC = 739e6
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax8():
    if len(jax.devices()) < 8:
        pytest.skip("needs tests/conftest.py's 8 virtual devices")


def _key(c):
    return (c.n_id_cell(), c.cp_type.value, c.n_rb_dl, c.n_ports, c.sfn,
            c.phich_duration.value, c.phich_resource.value)


def test_carrier_mesh_front_end_matches_per_carrier(jax8):
    """Three carriers over 8 devices: padded to 8 rows by repeating the
    last, c_real 3, the planned arrays equal to the TPU package's, and
    each real carrier's maps, slab and sp_incoherent equal to the
    one-device front end's (tests/test_carriers.py:26-67)."""
    rng = np.random.default_rng(0)
    n_cap = 40000
    f_set = np.array([-5e3, 0.0, 5e3])
    fcs = [739e6, 739.1e6, 2145e6]
    caps = [(rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1
            for _ in fcs]
    mesh = tc.make_carrier_mesh(8, ["cpu"] * 8)
    plan = tc.plan_carrier_inputs(caps, fcs, f_set, fcs, FS, 8)
    jplan = jc.plan_carrier_inputs(caps, fcs, f_set, fcs, FS, 8,
                                   dtype=np.complex128)
    assert plan[4] == jplan[4] == 3 and plan[0].shape[0] == 8
    for g, w in zip(plan[:3], jplan[:3]):
        np.testing.assert_array_equal(g, w)
    assert plan[3] == jplan[3]

    chunk = tc._stage_chunk(list(zip(caps, fcs, fcs)), f_set, FS, 8)
    blocks = tc._front_blocks(chunk, tc.BandRoute(None), 2, mesh)
    assert [lo for lo, _c, _f in blocks] == list(range(8))
    for i, (c, fc) in enumerate(zip(caps, fcs)):
        slab, pow_c, frq_c, sp_inc = (x[0].numpy() for x in blocks[i][2])
        ref = xcorr_pss(c, f_set, 2, fc, fc, FS, lean=True, device="cpu")
        np.testing.assert_allclose(pow_c, ref.xc_incoherent_collapsed_pow,
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(frq_c, ref.xc_incoherent_collapsed_frq)
        np.testing.assert_allclose(slab, ref.refine_slab, rtol=0, atol=1e-12)
        np.testing.assert_allclose(sp_inc, ref.sp_incoherent, rtol=0,
                                   atol=1e-12)
    # the padding rows repeat the last carrier
    for b in range(3, 8):
        np.testing.assert_array_equal(blocks[b][2][1].numpy(),
                                      blocks[2][2][1].numpy())


def test_make_carrier_mesh():
    assert tc.make_carrier_mesh(devices=["cpu", "cpu"]) == [CPU, CPU]
    assert tc.make_carrier_mesh(1, ["cpu", "meta"]) == [CPU]
    with pytest.raises(ValueError, match="needs 3 devices"):
        tc.make_carrier_mesh(3, ["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 given or visible"):
            tc.make_carrier_mesh()
    with pytest.raises(ValueError, match="not both"):
        tc.scan_band([], np.zeros(1), FS, device="cpu", mesh=[CPU])


@pytest.fixture(scope="module")
def two_cells():
    """Cell 277 (2 ports, SFN 0) on 739.0 MHz and cell 271 (1 port,
    SFN 4) on 739.1 MHz, 10 dB (tests/test_carriers.py:89-95)."""
    rng = np.random.default_rng(3)
    sig_a = awgn(create_dl_sig(JCpType.NORMAL, 80, 0, 92, 1, 0.5, rng=rng,
                               n_ports=2, sfn=0), 10.0, rng=rng)
    sig_b = awgn(create_dl_sig(JCpType.NORMAL, 80, 0, 90, 1, 0.5, rng=rng,
                               n_ports=1, sfn=4), 10.0, rng=rng)
    return [(sig_a, 739e6, 739e6), (sig_b, 739.1e6, 739.1e6)]


F_BAND = np.arange(-10e3, 10e3 + 1, 5e3)


def test_scan_band_over_two_devices(two_cells, jax8):
    """scan_band(mesh=2 devices): each cell on its carrier, the batched
    back half equal to the serial one, the one-device scan's cells, and
    the TPU package's on its 2-device mesh
    (tests/test_carriers.py:70-108)."""
    mesh = tc.make_carrier_mesh(devices=["cpu", "cpu"])
    port_cfg = tsearch.SearchConfig
    batched = tc.scan_band(two_cells, F_BAND, FS, port_cfg(), mesh=mesh)
    serial = tc.scan_band(two_cells, F_BAND, FS,
                          port_cfg(batch_peaks=False), mesh=mesh)
    one = tc.scan_band(two_cells, F_BAND, FS, port_cfg(), device="cpu")
    ref = jc.scan_band(two_cells, F_BAND, FS, jsearch.SearchConfig(),
                       mesh=jc.make_carrier_mesh(2), dtype=np.complex128)
    assert [c.n_id_cell() for c in batched[0]] == [277]
    assert [c.n_id_cell() for c in batched[1]] == [271]
    for lists in (serial, one, ref):
        assert len(lists) == 2
        for rb, rs in zip(batched, lists):
            assert [_key(c) for c in rb] == [_key(c) for c in rs]
            for cb, cs in zip(rb, rs):
                assert abs(cb.frame_start - cs.frame_start) < 1e-6
                np.testing.assert_allclose(cb.freq_fine, cs.freq_fine,
                                           rtol=0, atol=1e-8)
                np.testing.assert_allclose(cb.pss_pow, cs.pss_pow,
                                           rtol=1e-8)


@pytest.mark.parametrize("adc", [False, True], ids=["bf16", "int8"])
def test_kernel_route_over_two_devices(adc):
    """The kernel route (the plain versions on the CPU) over a 2-device
    list finds what it finds on one device, the route planned once for
    the chunk (the mesh part of tests/test_carriers.py:222-247)."""
    rng = np.random.default_rng(5)
    n_cap = 20 * 1920
    sig = awgn(create_dl_sig(JCpType.NORMAL, 20, 0, 92, 1, 0.5, rng=rng,
                             n_ports=2), 8.0, rng=rng)
    noise = (rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) \
        * np.sqrt(0.5)
    caps = [(noise, 739e6, 739e6), (sig, 739.1e6, 739.1e6)]
    if adc:
        caps = [(adc_quantize(c), fc, fcp) for c, fc, fcp in caps]
    f_set = np.array([-5e3, 0.0, 5e3])
    cfg = tsearch.SearchConfig(decode=False, corr_backend="kernel")
    one = tc.scan_band(caps, f_set, FS, cfg, device="cpu")
    two = tc.scan_band(caps, f_set, FS, cfg, mesh=[CPU, CPU])
    assert [len(x) for x in one] == [len(x) for x in two]
    assert not two[0] and two[1][0].n_id_cell() == 277
    for lo, lt in zip(one, two):
        for co, ct in zip(lo, lt):
            assert co.n_id_cell() == ct.n_id_cell()
            assert co.pss_pow == ct.pss_pow


def _edge_tables(d_max: int, d_min: int = 0):
    """Two carriers' [n_f, n_comb] fold-start tables 9600 m + delta whose
    deltas reach d_max and d_min (the v4 window's edges)."""
    n_f, n_comb = 3, 8
    delta = np.zeros((n_f, n_comb), np.int64)
    delta[0, -1] = d_max
    delta[2, -1] = d_min
    base = 9600 * np.arange(n_comb)[None] + delta
    return np.stack([base, base])


@pytest.mark.parametrize("d_max,d_min", [(20, 0), (19, 0), (21, 0),
                                         (0, -20), (0, -19), (83, 0),
                                         (84, 0), (85, 0), (0, -84)])
@pytest.mark.parametrize("margin", [0, 1, 2])
def test_v4_band_kv_margin_matches_tpu_package(d_max, d_min, margin):
    """v4_band_kv(margin) on tables at the 256- and 384-row windows'
    edges (+-20 and +-84 samples) equals the TPU package's."""
    tables = _edge_tables(d_max, d_min)
    want = jc.v4_band_kv(tables, margin)
    assert tc.v4_band_kv(tables, margin=margin) == want
    assert (tf.v4_kv_for(tables[1], margin=margin) or 0) == \
        (jp.v4_kv_for(tables[1], margin=margin) or 0)
    if (d_max, d_min, margin) == (20, 0, 1):
        assert want == 384      # the 256 window's edge, moved in by 1


def test_plan_scan_bands_forced_route():
    """force_int8 / force_v4 impose the route the gathered verdict
    names; without them the chunk decides."""
    caps = [np.zeros(40000, complex) + 0.5, np.zeros(40000, complex) + 0.5]
    f_set = np.array([-5e3, 0.0, 5e3])
    _cap, tmpl, starts, _n, _c = tc.plan_carrier_inputs(
        caps, [FC, FC + 1e5], f_set, [FC, FC + 1e5], FS)
    cfg = tsearch.SearchConfig(corr_backend="kernel")
    auto = tc._plan_scan_bands(tmpl, starts, caps, cfg, CPU)
    assert auto.kern.precision == "int8" and auto.mid_starts is not None
    forced = tc._plan_scan_bands(tmpl, starts, caps, cfg, CPU,
                                 force_int8=False, force_v4=0)
    assert forced.kern.precision == "bf16" and forced.mid_starts is None
    kv = tc._plan_scan_bands(tmpl, starts, caps, cfg, CPU, force_v4=384)
    assert kv.mid_starts is not None
    exact = tc._plan_scan_bands(tmpl, starts, caps, tsearch.SearchConfig(),
                                CPU, force_int8=True, force_v4=256)
    assert exact.kern is None


def test_cell_search_over_a_time_grid_matches_tpu_package(jax8):
    """cell_search(mesh=(8 x 1)) on the two-cell capture against the TPU
    package's on its 8 devices and the port's one-device search: cells,
    IDs, CP and MIB exact, freq_fine within 1e-8 Hz."""
    cap = two_cell_capture(f_off=1e3)
    f_set = np.array([-5e3, 0.0, 5e3])
    got = tsearch.cell_search(cap, f_set, FC, FC, FS,
                              mesh=tsh.make_mesh(8, 1, ["cpu"] * 8))
    want = jsearch.cell_search(cap, f_set, FC, FC, FS,
                               mesh=jsh.make_mesh(8, 1))
    one = tsearch.cell_search(cap, f_set, FC, FC, FS, device="cpu")
    assert sorted(c.n_id_cell() for c in got) == [271, 277]
    for ref in (want, one):
        assert [_key(c) for c in got] == [_key(c) for c in ref]
        for g, r in zip(got, ref):
            assert g.frame_start == pytest.approx(r.frame_start, abs=1e-9)
            np.testing.assert_allclose(g.freq_fine, r.freq_fine, rtol=0,
                                       atol=1e-8)
    with pytest.raises(ValueError, match="not both"):
        tsearch.cell_search(cap, f_set, FC, FC, FS, device="cpu",
                            mesh=tsh.make_mesh(1, 1, ["cpu"]))


def test_tracker_search_grid_matches_tpu_package(jax8):
    """The tracker with its searcher's front end over an (8 x 1) grid on
    a 250 ms cut of tests/test_tracker.py:485-500's stream, against the
    TPU package's runner on its 8 devices at the tolerances of
    tests/test_torch_tracker_run.py."""
    rng = np.random.default_rng(11)
    sig = create_dl_sig(JCpType.NORMAL, 250, 0, 92, 1, 0.4, rng=rng,
                        n_ports=2, sfn=4)
    sig = awgn(apply_freq_offset(sig, 300.0), 5.0, rng=rng)
    ref = JRunner(FC, FC, FS, search_mesh=jsh.make_mesh(8, 1))
    got = TrackerRunner(FC, FC, FS, device="cpu",
                        search_mesh=tsh.make_mesh(8, 1, ["cpu"] * 8))
    for i in range(0, len(sig), 10000):
        ref.process_block(sig[i: i + 10000])
        got.process_block(sig[i: i + 10000])
    assert [c.n_id_cell for c in got.cells] == \
        [c.n_id_cell for c in ref.cells] == [277]
    assert np.isclose(got.state.frequency_offset,
                      ref.state.frequency_offset, rtol=1e-9, atol=1e-6)
    tg, tr = got.cells[0], ref.cells[0]
    assert (tg.n_ports, tg.cp_type.value, tg.n_rb_dl) == \
        (tr.n_ports, tr.cp_type.value, tr.n_rb_dl) == (2, "normal", 6)
    assert np.isclose(tg.frame_timing, tr.frame_timing, rtol=0, atol=1e-6)
    assert tg.mib_decode_failures == tr.mib_decode_failures
    assert np.allclose(tg.ce, tr.ce, rtol=1e-6, atol=1e-9)
    assert tg.health_pct() > 99.0
    assert abs(got.state.frequency_offset - 300.0) < 50.0
