"""The port's front end (lte_cell_scanner_tpu_torch/models/xcorr.py,
models/peaks.py) against the TPU package on the CPU.

complex128 sim captures run through the TPU package's xcorr_pss (XLA
correlation) and the port's (exact correlation); the bf16 and int8 routes
run through the kernels' plain versions and hold the TPU package's
detection-grade bar against the exact route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.models import peaks as jpk
from lte_cell_scanner_tpu.models import search as js
from lte_cell_scanner_tpu.models import xcorr as jx
from lte_cell_scanner_tpu.sim import apply_freq_offset, awgn, create_dl_sig
from lte_cell_scanner_tpu_torch.models import peaks as tpk
from lte_cell_scanner_tpu_torch.models import xcorr as tx
from lte_cell_scanner_tpu_torch.sim.scenarios import adc_quantize

FS = 1.92e6
FC = 739e6
F_SET = np.array([-5e3, 0.0, 5e3])


def _sim(seed=3, n_ms=25, f_off=1500.0, snr_db=5.0):
    rng = np.random.default_rng(seed)
    sig = create_dl_sig(JCpType.NORMAL, n_ms, 0, 92, 1, 0.5, rng=rng,
                        n_ports=2)
    return awgn(apply_freq_offset(sig, f_off), snr_db, rng=rng)


@pytest.fixture(scope="module")
def capture():
    return _sim()


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - b)) / np.max(np.abs(a))


@pytest.mark.parametrize("lean", [False, True])
def test_xcorr_pss_matches_tpu_package(capture, lean):
    ref = jx.xcorr_pss(capture, F_SET, 2, FC, FC, FS, lean=lean,
                       corr_backend="xla")
    got = tx.xcorr_pss(capture, F_SET, 2, FC, FC, FS, lean=lean,
                       corr_backend="exact", device="cpu")
    assert (got.n_comb_xc, got.n_comb_sp) == (ref.n_comb_xc, ref.n_comb_sp)
    # both take their cumulative sums in their own order: 1e-12 of the max
    assert _rel(ref.sp_incoherent, got.sp_incoherent) < 1e-12
    assert _rel(ref.xc_incoherent_collapsed_pow,
                got.xc_incoherent_collapsed_pow) < 1e-8
    np.testing.assert_array_equal(ref.xc_incoherent_collapsed_frq,
                                  got.xc_incoherent_collapsed_frq)
    if lean:
        # the slab holds fold values at the collapsed argmax: the same
        # picks, values within summation-order rounding
        assert got.sp is None and got.xc_incoherent_single is None
        assert _rel(ref.refine_slab, got.refine_slab) < 1e-12
        np.testing.assert_array_equal(np.argmax(ref.refine_slab, axis=1),
                                      np.argmax(got.refine_slab, axis=1))
    else:
        assert _rel(ref.sp, got.sp) < 1e-12
        assert _rel(ref.xc_incoherent_single,
                    got.xc_incoherent_single) < 1e-8
        assert _rel(ref.xc_incoherent, got.xc_incoherent) < 1e-8


def test_keep_xc_returns_the_exact_correlation(capture):
    ref = jx.xcorr_pss(capture[:12000], F_SET, 2, FC, FC, FS, keep_xc=True,
                       corr_backend="xla")
    got = tx.xcorr_pss(capture[:12000], F_SET, 2, FC, FC, FS, keep_xc=True,
                       corr_backend="exact", device="cpu")
    assert got.xc.shape == np.asarray(ref.xc).shape
    assert _rel(ref.xc, got.xc) < 1e-12


def test_device_peak_loop_matches_tpu_package(capture):
    """The port's device loop, run on CPU tensors, gives exactly the TPU
    package's records and the host peak search's peak list."""
    r = jx.xcorr_pss(capture, F_SET, 2, FC, FC, FS, lean=True,
                     corr_backend="xla")
    z_scale = float(js.compute_z_th1(np.float64(1.0), r.n_comb_xc, 2, 12))
    pow_c = np.array(r.xc_incoherent_collapsed_pow)
    frq_c = np.array(r.xc_incoherent_collapsed_frq)
    slab = np.array(r.refine_slab)
    z = np.asarray(r.sp_incoherent) * z_scale
    recs_j, n_j = jpk.peak_search_device_impl(
        jnp.asarray(pow_c), jnp.asarray(frq_c), jnp.asarray(slab),
        jnp.asarray(z), 2)
    recs_t, n_t = tpk.peak_search_device(
        torch.from_numpy(pow_c)[None], torch.from_numpy(frq_c)[None],
        torch.from_numpy(slab)[None], torch.from_numpy(z)[None], 2)
    recs_t, n_t = recs_t[0], n_t[0]
    assert int(n_t) == int(n_j) >= 1
    np.testing.assert_array_equal(recs_t.numpy(), np.asarray(recs_j))

    host = tpk.peak_search(pow_c, frq_c, z, F_SET, FC, FC, None, 2,
                           refine_slab=slab)
    host_j = jpk.peak_search(pow_c, frq_c, z, F_SET, FC, FC, None, 2,
                             refine_slab=slab)
    dev = tpk.cells_from_peak_records(recs_t.numpy(), int(n_t), F_SET, FC,
                                      FC)
    key = [(c.n_id_2, c.ind, c.freq, c.pss_pow) for c in host]
    assert key == [(c.n_id_2, c.ind, c.freq, c.pss_pow) for c in host_j]
    assert key == [(c.n_id_2, c.ind, c.freq, c.pss_pow) for c in dev]


def test_device_peak_loop_ties_pick_the_first_maximum():
    pow_c = np.zeros((3, 9600))
    pow_c[2, 100] = pow_c[1, 5000] = pow_c[1, 7000] = 1.0
    frq_c = np.zeros((3, 9600), dtype=np.int64)
    slab = np.ones((3, 5, 9600))                  # all refinements tie
    z = np.full(9600, 0.5)
    recs_j, n_j = jpk.peak_search_device_impl(
        jnp.asarray(pow_c), jnp.asarray(frq_c), jnp.asarray(slab),
        jnp.asarray(z), 2)
    recs_t, n_t = tpk.peak_search_device(
        torch.from_numpy(pow_c)[None], torch.from_numpy(frq_c)[None],
        torch.from_numpy(slab)[None], torch.from_numpy(z)[None], 2)
    recs_t, n_t = recs_t[0], n_t[0]
    assert int(n_t) == int(n_j) == 3
    np.testing.assert_array_equal(recs_t.numpy(), np.asarray(recs_j))
    assert list(recs_t[:3, 3].numpy()) == [1.0, 1.0, 2.0]
    assert list(recs_t[:3, 1].numpy()) == [4998.0, 6998.0, 98.0]


@pytest.mark.parametrize("adc", [False, True], ids=["bf16", "int8"])
def test_kernel_routes_hold_detection_grade(capture, adc):
    """The bf16 (float capture) and int8 (ADC-grid capture) routes,
    through the kernels' plain versions, against the exact route: the
    TPU package's detection-grade bar (tests/test_xcorr.py)."""
    cap = adc_quantize(capture) if adc else capture
    ref = jx.xcorr_pss(cap, F_SET, 2, FC, FC, FS, lean=True,
                       corr_backend="xla")
    got = tx.xcorr_pss(cap, F_SET, 2, FC, FC, FS, lean=True,
                       corr_backend="kernel", device="cpu")
    a = got.xc_incoherent_collapsed_pow
    b = np.asarray(ref.xc_incoherent_collapsed_pow)
    assert np.max(np.abs(a - b)) < 2e-2 * b.max()
    same = got.xc_incoherent_collapsed_frq == \
        np.asarray(ref.xc_incoherent_collapsed_frq)
    assert same.mean() > 0.99
    np.testing.assert_allclose(got.sp_incoherent,
                               np.asarray(ref.sp_incoherent), rtol=1e-6)
    # and the detection itself: the same strongest peak
    assert np.argmax(a) == np.argmax(b)


def test_corr_backend_routing():
    cpu = torch.device("cpu")
    cuda = torch.device("cuda")
    assert not tx.use_kernel_corr("auto", cpu)
    assert tx.use_kernel_corr("auto", cuda)
    assert tx.use_kernel_corr("kernel", cpu)
    assert not tx.use_kernel_corr("exact", cuda)
    with pytest.raises(ValueError):
        tx.use_kernel_corr("xla", cpu)
