"""The port's correlation-power kernels (lte_cell_scanner_tpu_torch/ops/
corr_cuda.py) against the TPU package's v2 Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
run only on the card: tests/test_torch_cuda.py and chip_smoke.py hold them
against these same plain versions).  The Pallas kernels run in interpret
mode, as the TPU package's own tests run them.  Inputs are made with numpy
from fixed seeds and fed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.models import xcorr as jx
from lte_cell_scanner_tpu.ops import corr_pallas as jp
from lte_cell_scanner_tpu_torch.models import xcorr as tx
from lte_cell_scanner_tpu_torch.ops import corr_cuda as tc

FS = 1.92e6
FC = 739e6
CPU = torch.device("cpu")


def _templates(f_set):
    return jx.pss_templates(f_set, FC, FC, FS, np.complex64).reshape(-1, 137)


def _jax_v2(cap, g, n_t, precision):
    n_lags = cap.shape[0] - 136
    t_pad, n_tc, n_rows, n_rb = jp.plan_pallas_v2(n_t, n_lags)
    out = jp.corr_pow_core_v2(
        jnp.real(cap), jnp.imag(cap), g, n_lags, n_t, t_pad, n_tc, n_rows,
        n_rb, interpret=True, precision=precision, post="xla",
        out_dtype=jnp.bfloat16)
    return np.asarray(out.astype(jnp.float32)).astype(np.float64)


def _grid_capture(seed, n_cap, saturate_every=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=n_cap)
    y = rng.integers(0, 256, size=n_cap)
    if saturate_every:
        x[::saturate_every] = 255                 # k = +128
    return (((x - 127) + 1j * (y - 127)) / 128.0).astype(np.complex64)


def _bf16_ulps_apart(a, b):
    """Distance in bf16 steps between two non-negative bf16 arrays."""
    ia = torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
    ib = torch.from_numpy(np.ascontiguousarray(b, np.float32)) \
        .to(torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("n_f,n_half", [(3, 2), (5, 3)])
def test_bf16_plain_matches_pallas_v2(n_f, n_half):
    rng = np.random.default_rng(22 + n_f)
    n_cap = n_half * 9600 + 400
    cap = ((rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1) \
        .astype(np.complex64)
    tmpl = _templates(np.arange(n_f) * 5e3 - 5e3 * (n_f // 2))
    ref = _jax_v2(cap, jp.bands_v2_for_templates(tmpl, precision="bf16"),
                  tmpl.shape[0], "bf16")
    got = tc.corr_pow_bf16(
        tc.capture_planes_bf16(torch.from_numpy(cap)),
        tc.template_planes_bf16(tmpl, CPU), n_cap - 136)
    assert got.dtype == torch.bfloat16
    assert got.shape == ref.shape == (3 * n_f, n_cap - 136)
    g = got.float().numpy().astype(np.float64)
    # f32 sums taken in another order, both rounded to bf16: within one
    # bf16 step (2^-7 relative), or 1e-5 x the map's max where Re and Im
    # cancel
    tol = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(ref)) \
        + 1e-5 * ref.max()
    assert np.all(np.abs(g - ref) <= tol)
    assert np.mean(g == ref) > 0.9


@pytest.mark.parametrize("n_f,n_half", [(3, 2), (4, 3)])
def test_int8_plain_matches_pallas_v2(n_f, n_half):
    n_cap = n_half * 9600 + 400
    cap = _grid_capture(7 + n_f, n_cap)
    assert tc.is_adc_grid(cap) and jp.is_adc_grid(cap)
    tmpl = _templates(np.arange(n_f) * 5e3 - 5e3)
    g_i8, scale = jp.bands_v2_int8_for_templates(tmpl)
    ref = _jax_v2(cap, g_i8, tmpl.shape[0], "int8")
    taps, power_scale = tc.template_planes_int8(tmpl, CPU)
    assert power_scale == scale
    assert np.float32(power_scale).tobytes() == np.float32(scale).tobytes()
    got = tc.corr_pow_int8(tc.capture_planes_int8(torch.from_numpy(cap)),
                           taps, n_cap - 136)
    assert got.dtype == torch.bfloat16
    g = got.float().numpy().astype(np.float64)
    # exact integer sums on both sides; the squares may round differently
    # where the interpreter contracts re*re + im*im
    ulps = _bf16_ulps_apart(g, ref)
    assert np.mean(ulps == 0) >= 0.999
    assert ulps.max() <= 1


def test_int8_taps_equal_the_pallas_band_entries():
    """The port's int8 taps are exactly the nonzero entries of the TPU
    band matrix: column (chunk 0, Re half, c = 0, template t) holds
    Re taps in rows 0..136 and -Im taps in rows 256..392."""
    tmpl = _templates(np.array([-5e3, 0.0, 5e3]))
    g_i8, _scale = jp.bands_v2_int8_for_templates(tmpl)
    g = np.asarray(g_i8)
    taps, _ = tc.template_planes_int8(tmpl, CPU)
    taps = taps.numpy()
    for t in range(tmpl.shape[0]):
        np.testing.assert_array_equal(taps[0, t], g[:137, t])
        np.testing.assert_array_equal(taps[1, t], -g[256:256 + 137, t])


def test_int8_saturated_capture_clips_one_lsb():
    """A capture holding the +128 code: the int8 route clips it to 127,
    so its map is the exact integer correlation of the CLIPPED capture
    (rebuilt in numpy, rounded as the kernel rounds), and deviates by a
    bounded amount from the unclipped powers."""
    n_cap = 9600 + 400
    cap = _grid_capture(11, n_cap, saturate_every=37)
    assert tc.is_adc_grid(cap) and jp.is_adc_grid(cap)
    tmpl = _templates(np.array([0.0]))
    n_lags = n_cap - 136
    taps, scale = tc.template_planes_int8(tmpl, CPU)
    got = tc.corr_pow_int8(tc.capture_planes_int8(torch.from_numpy(cap)),
                           taps, n_lags)

    kx = np.clip(np.round(cap.real * 128), -127, 127).astype(np.int64)
    ky = np.clip(np.round(cap.imag * 128), -127, 127).astype(np.int64)
    s_g = 127.0 / float(np.max(np.abs(
        np.concatenate([tmpl.real.ravel(), tmpl.imag.ravel()]))))
    tre = np.clip(np.round(tmpl.real * s_g), -127, 127).astype(np.int64)
    tim = np.clip(np.round(tmpl.imag * s_g), -127, 127).astype(np.int64)
    win_r = np.lib.stride_tricks.sliding_window_view(kx, 137)[:n_lags]
    win_i = np.lib.stride_tricks.sliding_window_view(ky, 137)[:n_lags]
    re = (win_r @ tre[0] - win_i @ tim[0]).astype(np.float32)
    im = (win_r @ tim[0] + win_i @ tre[0]).astype(np.float32)
    exact = torch.from_numpy(re * re + im * im).to(torch.bfloat16)
    assert torch.equal(got[0], exact)

    xc = np.asarray(jx.correlate(jnp.asarray(cap.astype(np.complex128)),
                                 jnp.asarray(tmpl.astype(np.complex128))))
    unclipped = np.abs(xc[0, :n_lags]) ** 2
    dev = np.abs(got[0].float().numpy() * float(scale) - unclipped) \
        / unclipped.max()
    assert 0 < dev.max() < 2e-2


def test_is_adc_grid_agrees():
    rng = np.random.default_rng(6)
    grid = _grid_capture(6, 1000).astype(np.complex128)
    sat = grid.copy()
    sat[3] = 1.0 + 1j * sat[3].imag
    cases = [grid, grid + 3e-4, grid * 1.5, sat,
             rng.normal(size=100) + 1j * rng.normal(size=100)]
    got = [tc.is_adc_grid(c) for c in cases]
    assert got == [jp.is_adc_grid(c) for c in cases]
    assert got == [True, False, False, True, False]


def test_host_tables_equal_the_tpu_package():
    f_set = np.array([-10e3, -5e3, 0.0, 5e3, 10e3])
    for dtype in (np.complex128, np.complex64):
        a = tx.pss_templates(f_set, FC, FC - 1e3, FS, dtype)
        b = jx.pss_templates(f_set, FC, FC - 1e3, FS, dtype)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(
        tx.combine_start_indices(f_set, FC, FC, FS, 15),
        jx.combine_start_indices(f_set, FC, FC, FS, 15))
    np.testing.assert_array_equal(tx.round_i(np.array([-2.5, -0.5, 0.5, 2.5])),
                                  jx.round_i(np.array([-2.5, -0.5, 0.5, 2.5])))


def test_wrapper_rejects_bad_operands():
    cap = tc.capture_planes_bf16(torch.zeros(400, dtype=torch.complex64))
    taps = tc.template_planes_bf16(np.zeros((3, 137), np.complex64), CPU)
    with pytest.raises(TypeError):
        tc.corr_pow_int8(cap, taps, 264)
    with pytest.raises(ValueError):
        tc.corr_pow_bf16(cap, taps, 265)            # lags past the capture
    with pytest.raises(ValueError):
        tc.corr_pow_bf16(cap[:, ::2], taps, 64)      # not contiguous
    with pytest.raises(ValueError):
        tc.corr_pow_bf16(cap.to("meta"), taps.to("meta"), 264)  # no kernel
