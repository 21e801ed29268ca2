"""The port's batched band scan (lte_cell_scanner_tpu_torch/parallel/
carriers.py) and its cross-carrier back half against the TPU package's,
end to end on the CPU.

A three-carrier band made with numpy from a fixed seed: cell 277 (2
ports, SFN 0) on 739.0 MHz, noise on 739.1 MHz, cell 271 (1 port, SFN 4)
on 739.2 MHz, each cell a few kHz off its carrier.  The exact routes run
complex128 on both sides (reference tolerances); the kernel routes run
the port's plain v4 versions against the Pallas v4 kernels in interpret
mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.models import decode as jdec
from lte_cell_scanner_tpu.models import peaks as jpk
from lte_cell_scanner_tpu.models import search as js
from lte_cell_scanner_tpu.models import sss_detect as jsd
from lte_cell_scanner_tpu.parallel import carriers as jc
from lte_cell_scanner_tpu.sim import apply_freq_offset, awgn, create_dl_sig
from lte_cell_scanner_tpu_torch import cli
from lte_cell_scanner_tpu_torch.interop import (cell_from_fields,
                                                config_from_fields)
from lte_cell_scanner_tpu_torch.models import decode as tdec
from lte_cell_scanner_tpu_torch.models import peaks as tpk
from lte_cell_scanner_tpu_torch.models import sss_detect as tsd
from lte_cell_scanner_tpu_torch.models import xcorr as tx
from lte_cell_scanner_tpu_torch.parallel import carriers as tc
from lte_cell_scanner_tpu_torch.sim.scenarios import adc_quantize

FS = 1.92e6
F_SET = np.arange(-10e3, 10e3 + 1, 5e3)
FCS = (739.0e6, 739.1e6, 739.2e6)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def band():
    rng = np.random.default_rng(3)
    a = create_dl_sig(JCpType.NORMAL, 80, 0, 92, 1, 0.5, rng=rng, n_ports=2,
                      sfn=0)
    b = create_dl_sig(JCpType.NORMAL, 80, 0, 90, 1, 0.5, rng=rng, n_ports=1,
                      sfn=4)
    a = awgn(apply_freq_offset(a, 2500.0), 10.0, rng=rng)
    b = awgn(apply_freq_offset(b, -1500.0), 10.0, rng=rng)
    sigma = np.sqrt(np.mean(np.abs(a) ** 2) / 11.0 / 2.0)
    noise = (rng.normal(size=len(a)) + 1j * rng.normal(size=len(a))) * sigma
    return [(c, fc, fc) for c, fc in zip((a, noise, b), FCS)]


@pytest.fixture(scope="module")
def jax_exact(band):
    return jc.scan_band(band, F_SET, FS, js.SearchConfig(),
                        mesh=jc.make_carrier_mesh(1), dtype=np.complex128)


def _port_cfg(**kw):
    return config_from_fields(dataclasses.asdict(js.SearchConfig(**kw)))


def _key(c):
    return (c.n_id_cell(), c.cp_type.value, c.n_rb_dl, c.n_ports, c.sfn)


def test_front_batch_matches_single_carrier_xcorr(band):
    caps = [c for c, _, _ in band]
    cap, tmpl, starts, _n, _c = tc.plan_carrier_inputs(caps, FCS, F_SET, FCS,
                                                       FS)
    slab, pow_c, frq_c, sp_inc = tc._front_batch(
        torch.from_numpy(cap), tmpl, starts, tc.BandRoute(None), 2)
    for i, (c, fc, _) in enumerate(band):
        r = tx.xcorr_pss(c, F_SET, 2, fc, fc, FS, lean=True,
                         corr_backend="exact", device="cpu")
        scale = np.max(r.xc_incoherent_collapsed_pow)
        assert np.max(np.abs(pow_c[i].numpy()
                             - r.xc_incoherent_collapsed_pow)) <= 1e-12 * scale
        np.testing.assert_array_equal(frq_c[i].numpy(),
                                      r.xc_incoherent_collapsed_frq)
        assert np.max(np.abs(slab[i].numpy() - r.refine_slab)) \
            <= 1e-12 * np.max(r.refine_slab)
        assert np.max(np.abs(sp_inc[i].numpy() - r.sp_incoherent)) \
            <= 1e-12 * np.max(r.sp_incoherent)


def test_scan_band_matches_tpu_package(band, jax_exact):
    got = tc.scan_band(band, F_SET, FS, _port_cfg(), device="cpu")
    assert [sorted(c.n_id_cell() for c in cl) for cl in got] == \
        [[277], [], [271]]
    assert len(got) == len(jax_exact)
    for g_list, r_list in zip(got, jax_exact):
        assert [_key(c) for c in g_list] == [_key(c) for c in r_list]
        for g, r in zip(g_list, r_list):
            assert g.fc_requested == r.fc_requested
            assert abs(g.frame_start - r.frame_start) < 1e-9
            assert abs(g.freq_fine - r.freq_fine) < 1e-8
            assert abs(g.freq_superfine - r.freq_superfine) < 1e-7
    (c277,), _, (c271,) = got
    assert (c277.n_ports, c277.sfn, c271.n_ports) == (2, 0, 1)
    assert c271.sfn in (4, 5)


def test_scan_band_chunks_match_the_unchunked_scan(band, jax_exact):
    chunked = tc.scan_band(band, F_SET, FS, _port_cfg(), device="cpu",
                           max_carriers_per_program=2)
    assert [[_key(c) for c in cl] for cl in chunked] == \
        [[_key(c) for c in cl] for cl in jax_exact]
    for g_list, r_list in zip(chunked, jax_exact):
        for g, r in zip(g_list, r_list):
            assert abs(g.freq_superfine - r.freq_superfine) < 1e-7


@pytest.mark.parametrize("fused", [True, False], ids=["v4", "v2"])
@pytest.mark.parametrize("adc", [False, True], ids=["bf16", "int8"])
def test_kernel_front_end_matches_tpu_package(band, adc, fused):
    """The kernel routes of both packages on the same chunk: the port's
    plain v4 (fused fold at the middle carrier's starts) or v2 (each
    carrier's exact fold) version against the Pallas kernel of the same
    route in interpret mode.  The collapsed power within 0.2% of its max
    and no argmax flip (the bar of tests/test_xcorr.py:125-131)."""
    caps = [adc_quantize(c) if adc else c for c, _, _ in band]
    cap, tmpl, starts, n_comb, _c = tc.plan_carrier_inputs(caps, FCS, F_SET,
                                                           FCS, FS)
    route = tc._plan_scan_bands(tmpl, starts, caps,
                                _port_cfg(corr_backend="pallas"), CPU)
    assert route.mid_starts is not None
    assert route.kern.precision == ("int8" if adc else "bf16")
    if not fused:
        # the route a chunk takes when the middle carrier's table does
        # not fit every carrier (v4_band_kv == 0)
        route = tc.BandRoute(route.kern)
    slab, pow_c, frq_c, sp_inc = tc._front_batch(torch.from_numpy(cap), tmpl,
                                                 starts, route, 2)

    jcap, jtmpl, jstarts, _n, _c = jc.plan_carrier_inputs(
        caps, FCS, F_SET, FCS, FS, 1, dtype=np.complex128)
    bands = jc._plan_scan_bands(jtmpl, jstarts, caps,
                                js.SearchConfig(corr_backend="pallas"),
                                force_v4=None if fused else False)
    # the v4 format stacks n_comb period bands of 512 rows
    assert (bands[0].shape[0] == n_comb * 512) == fused
    j_slab, j_pow, j_frq, j_sp = [np.asarray(x) for x in jc._front_sharded(
        jc.make_carrier_mesh(1), jcap, jtmpl, jstarts, 2, bands)]
    for i in range(len(caps)):
        assert np.max(np.abs(pow_c[i].numpy() - j_pow[i])) \
            <= 2e-3 * j_pow[i].max()
        peaks = j_pow[i].argmax(-1)
        np.testing.assert_array_equal(pow_c[i].numpy().argmax(-1), peaks)
        np.testing.assert_array_equal(frq_c[i].numpy()[[0, 1, 2], peaks],
                                      j_frq[i][[0, 1, 2], peaks])
        # every lag's hypothesis on the fused route; on the v2 route both
        # packages round the unfolded map to bf16 after sums in another
        # order, so a hypothesis tie off the peaks (the noise carrier has
        # one) may resolve either way
        if fused:
            np.testing.assert_array_equal(frq_c[i].numpy(), j_frq[i])
        np.testing.assert_allclose(sp_inc[i].numpy(), j_sp[i], rtol=1e-12)


@pytest.mark.parametrize("adc", [False, True], ids=["bf16", "int8"])
def test_scan_band_kernel_route_matches_tpu_package(band, adc):
    caps = [(adc_quantize(c) if adc else c, fc, fcp) for c, fc, fcp in band]
    ref = jc.scan_band(caps, F_SET, FS, js.SearchConfig(corr_backend="pallas"),
                       mesh=jc.make_carrier_mesh(1))
    got = tc.scan_band(caps, F_SET, FS, _port_cfg(corr_backend="pallas"),
                       device="cpu")
    assert [[_key(c) for c in cl] for cl in got] == \
        [[_key(c) for c in cl] for cl in ref]
    assert [sorted(c.n_id_cell() for c in cl) for cl in got] == \
        [[277], [], [271]]


def _band_peaks(band):
    """The TPU package's peak lists of every carrier, and their carrier
    indices."""
    peaks, carrier_of = [], []
    for i, (c, fc, _) in enumerate(band):
        r = js.xcorr_pss(c, F_SET, 2, fc, fc, FS, lean=True,
                         corr_backend="xla")
        z = js.compute_z_th1(r.sp_incoherent, r.n_comb_xc)
        p = js.peak_search(r.xc_incoherent_collapsed_pow,
                           r.xc_incoherent_collapsed_frq, z, F_SET, fc, fc,
                           None, 2, refine_slab=r.refine_slab)
        peaks += p
        carrier_of += [i] * len(p)
    return peaks, carrier_of


def test_batched_device_peak_loop_matches_tpu_package(band):
    """One peak loop over the three carriers (40 masked iterations in all)
    gives each carrier exactly the TPU package's per-carrier records."""
    maps = []
    for c, fc, _ in band:
        r = js.xcorr_pss(c, F_SET, 2, fc, fc, FS, lean=True,
                         corr_backend="xla")
        z_scale = js.compute_z_th1(np.float64(1.0), r.n_comb_xc, 2, 12)
        maps.append([np.array(r.xc_incoherent_collapsed_pow),
                     np.array(r.xc_incoherent_collapsed_frq),
                     np.array(r.refine_slab),
                     np.asarray(r.sp_incoherent) * z_scale])
    recs, ns = tpk.peak_search_device(
        *[torch.from_numpy(np.stack(m)) for m in zip(*maps)], 2)
    assert recs.shape == (3, tpk.PEAK_CAP, 4)
    for i, m in enumerate(maps):
        recs_j, n_j = jpk.peak_search_device_impl(
            *[jnp.asarray(x) for x in m], 2)
        assert int(ns[i]) == int(n_j)
        np.testing.assert_array_equal(recs[i].numpy(), np.asarray(recs_j))
    assert int(ns[0]) >= 1 and int(ns[2]) >= 1


def _port(cells):
    return [cell_from_fields(dataclasses.asdict(c)) for c in cells]


def test_cross_carrier_sss_and_decode_match_tpu_package(band):
    peaks, carrier_of = _band_peaks(band)
    assert set(carrier_of) >= {0, 2}
    stack = np.stack([c for c, _, _ in band])
    ref = jsd.sss_foe_batch_fused(peaks, None, 3.0, FS, capbuf_stack=stack,
                                  carrier_idx=carrier_of)
    got = tsd.sss_foe_batch_fused(_port(peaks), torch.from_numpy(stack),
                                  carrier_of, 3.0, FS)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.n_id_1, g.n_id_2, g.cp_type.value) == \
            (r.n_id_1, r.n_id_2, r.cp_type.value)
        if r.n_id_1 >= 0:
            assert abs(g.frame_start - r.frame_start) < 1e-9
            assert abs(g.freq_fine - r.freq_fine) < 1e-8

    kept = [(r, ci) for r, ci in zip(ref, carrier_of) if r.n_id_1 >= 0]
    assert {ci for _, ci in kept} == {0, 2}
    cells = [r for r, _ in kept]
    idx = [ci for _, ci in kept]
    ref_d = jdec.decode_back_half_batch_multi(cells, stack, idx, FS)
    got_d = tdec.decode_back_half_batch_multi(
        _port(cells), torch.from_numpy(stack), idx, FS)
    for g, r in zip(got_d, ref_d):
        assert (g.n_rb_dl, g.n_ports, g.sfn) == (r.n_rb_dl, r.n_ports, r.sfn)
        assert (g.phich_duration.value, g.phich_resource.value) == \
            (r.phich_duration.value, r.phich_resource.value)
        assert abs(g.freq_superfine - r.freq_superfine) < 1e-7
    assert sorted(g.n_id_cell() for g in got_d if g.n_rb_dl >= 0) == \
        [271, 277]


def test_cli_band_search_runs_the_serial_loop_on_the_cpu(capsys):
    assert cli.main(["search", "-s", "739e6", "-e", "739.1e6", "--sim",
                     "--device", "cpu", "-p", "5", "--sim-foff",
                     "1200"]) == 0
    out = capsys.readouterr().out
    assert out.count("Examining center frequency") == 2
    assert out.count("Detected a cell!") == 2       # a fresh capture each
    rows = [ln for ln in out.splitlines() if ln.startswith("277 ")]
    assert len(rows) == 1                            # dedup within 1 MHz


def test_cli_rejects_a_band_that_runs_backwards(capsys):
    assert cli.main(["search", "-s", "740e6", "-e", "739e6", "--sim",
                     "--device", "cpu"]) == 1
    assert "end frequency must be >= start frequency" in \
        capsys.readouterr().out


def test_scan_band_debug_exports_match_tpu_package(band, tmp_path):
    """With a debug dump active, each carrier's collapsed maps,
    sp_incoherent, Z_th1 and peak lists go to the dump in the TPU
    package's names and order, within 1e-8 of each array's largest
    value (the exact routes, complex128 on both sides)."""
    from lte_cell_scanner_tpu.utils import debug as jdebug
    from lte_cell_scanner_tpu.utils.itfile import read_itfile
    from lte_cell_scanner_tpu_torch.utils import debug as tdebug
    dumps = {}
    for name, mod, run in (
            ("port", tdebug, lambda: tc.scan_band(band, F_SET, FS,
                                                  _port_cfg(),
                                                  device="cpu")),
            ("tpu", jdebug, lambda: jc.scan_band(
                band, F_SET, FS, js.SearchConfig(),
                mesh=jc.make_carrier_mesh(1), dtype=np.complex128))):
        path = str(tmp_path / f"{name}.it")
        mod.set_dump(mod.DebugDump(path))
        try:
            run()
        finally:
            mod.set_dump(None)
        dumps[name] = read_itfile(path)
    got, want = dumps["port"], dumps["tpu"]
    assert list(got) == list(want)
    assert [k for k in got if k.startswith("Z_th1")] == \
        ["Z_th1", "Z_th1_1", "Z_th1_2"]
    assert "peak_ind" in got and "peak_n_id_2_1" in got
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= 1e-8 * max(np.abs(w).max(), 1e-300), k
