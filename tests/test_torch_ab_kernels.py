"""The port's correlation A/B routes against the TPU package's Pallas
kernels: v1 (banded), v3 (in-kernel transpose), the sum, per-chunk and
int8 probes of tools/bench_corr_v2.py, the band-matrix interop, and the
"conv"/"fft" methods of the exact correlation.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
run only on the card: tests/test_torch_cuda.py and chip_smoke.py hold them
against these same plain versions).  The Pallas kernels run in interpret
mode, as the TPU package's own tests run them.  Inputs are made with numpy
from fixed seeds and fed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lte_cell_scanner_tpu.models import xcorr as jx
from lte_cell_scanner_tpu.ops import corr_pallas as jp
from lte_cell_scanner_tpu.ops.corr import correlate as jax_correlate
from lte_cell_scanner_tpu_torch import interop
from lte_cell_scanner_tpu_torch.models import xcorr as tx
from lte_cell_scanner_tpu_torch.ops import corr_cuda as tc
from lte_cell_scanner_tpu_torch.ops.corr import correlate as port_correlate

FS = 1.92e6
FC = 739e6
CPU = torch.device("cpu")
KV, W = jp.KV_V2, jp.W_V2


def _random_case(seed, n_t=5, n_cap=4096 + 136):
    """The capture and templates of tests/test_xcorr.py:109-115."""
    rng = np.random.default_rng(seed)
    cap = (rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) \
        .astype(np.complex64)
    tmpl = (rng.normal(size=(n_t, 137)) + 1j * rng.normal(size=(n_t, 137))) \
        .astype(np.complex64) / 137.0
    return cap, tmpl


def _templates(f_set):
    return jx.pss_templates(f_set, FC, FC, FS, np.complex64).reshape(-1, 137)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _x3(cap, n_rows, int8=False):
    """The probes' im2col rows of the zero-padded capture
    (tools/bench_corr_v2.py:214-224 and :366-379)."""
    n_ext = W * (n_rows + 2)
    planes = []
    for plane in (jnp.real(cap), jnp.imag(cap)):
        p = plane.astype(jnp.float32)
        if int8:
            p = jnp.clip(jnp.round(p * 128.0), -127, 127)
        p = jnp.concatenate([p, jnp.zeros(n_ext - p.shape[0], p.dtype)])
        a = p.reshape(n_rows + 2, W)
        planes.append(jnp.concatenate(
            [a[:-2], a[1:-1], a[2:, : KV - 2 * W]], axis=1))
    return jnp.concatenate(planes, axis=1).astype(
        jnp.int8 if int8 else jnp.bfloat16)


# ---------------------------------------------------------------------------
# v1: the banded Toeplitz kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,seed", [("f32", 3), ("bf16", 9)])
def test_v1_plain_matches_pallas_v1(precision, seed):
    cap, tmpl = _random_case(seed)
    n_lags = cap.shape[0] - 136
    ref = np.asarray(jp.correlate_pow_pallas(
        jnp.asarray(cap), tmpl, n_lags, interpret=True,
        precision=precision)).astype(np.float64)
    kern = tx.v1_operands(tmpl, precision, CPU)
    planes = tc.capture_planes_f32 if precision == "f32" \
        else tc.capture_planes_bf16
    cap_q = planes(torch.from_numpy(cap))
    if precision == "f32":
        got = tc.corr_pow_f32(cap_q, kern.taps, n_lags)
    else:
        got = tc.corr_pow_bf16(cap_q, kern.taps, n_lags, torch.float32)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    g = got.numpy().astype(np.float64)
    # the bars of tests/test_xcorr.py:122 (f32) and :195-198 (bf16) ...
    assert np.allclose(g, ref, atol=1e-3, rtol=1e-3)
    assert np.max(np.abs(g - ref)) < 2e-2 * ref.max()
    np.testing.assert_array_equal(g.argmax(axis=1), ref.argmax(axis=1))
    # ... and the gap measured on these inputs (2.7e-7 x max at f32,
    # 1.7e-7 at bf16: the same quantized operands, f32 sums taken in
    # another order)
    assert np.max(np.abs(g - ref)) < 1e-6 * ref.max()


def test_xcorr_core_v1_route_matches_tpu_package():
    """The port's v1 route of xcorr_core against the TPU package's
    _xcorr_core with f32 bands (the front end of tests/test_xcorr.py:
    201-237), at that test's bars.  The capture is complex64 data held
    as complex128 on both sides (the port's CPU working type): the kernel
    routes read it as f32 planes, and the fold and sp_est run in float64,
    so sp_incoherent does not carry the two packages' different f32
    cumulative-sum rounding (6e-6 relative at complex64)."""
    rng = np.random.default_rng(21)
    n_cap = 2 * 9600 + 400
    cap = ((rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap))
           .astype(np.complex64) * 0.1).astype(np.complex128)
    f_set = np.array([-5e3, 0.0, 5e3])
    tmpl = jx.pss_templates(f_set, FC, FC, FS, np.complex64)
    n_comb = (n_cap - 136 - 100) // 9600
    starts = jx.combine_start_indices(f_set, FC, FC, FS, n_comb)
    g_re, g_im = jp.bands_for_templates(tmpl, precision="f32")
    want = jx._xcorr_core(jnp.asarray(cap), jnp.asarray(tmpl),
                          jnp.asarray(starts), 2, False, True, g_re, g_im)

    kern = tx.v1_operands(tmpl.reshape(-1, 137), "f32", CPU)
    assert (kern.route, kern.precision, kern.out_dtype) == \
        ("v1", "f32", torch.float32)
    got = tx.xcorr_core(torch.from_numpy(cap), None,
                        torch.from_numpy(starts), 2, False, True, kern)
    assert len(got) == len(want) == 8
    for i in (0, 1, 4, 6):
        assert got[i] is None and want[i] is None
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-4, atol=1e-9)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                               rtol=1e-6)
    np.testing.assert_allclose(got[7].numpy(), np.asarray(want[7]),
                               rtol=2e-4, atol=1e-9)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_xcorr_core_exact_route_returns_the_tpu_package_tuple():
    """Not lean and keep_xc: every slot of the 8-tuple, exact route."""
    rng = np.random.default_rng(23)
    n_cap = 2 * 9600 + 400
    cap = (rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1
    f_set = np.array([-5e3, 0.0, 5e3])
    tmpl = jx.pss_templates(f_set, FC, FC, FS)
    starts = jx.combine_start_indices(f_set, FC, FC, FS, 1)
    want = jx._xcorr_core(jnp.asarray(cap), jnp.asarray(tmpl),
                          jnp.asarray(starts), 2, True, False)
    got = tx.xcorr_core(torch.from_numpy(cap), torch.from_numpy(tmpl),
                        torch.from_numpy(starts), 2, True, False)
    assert got[7] is None and want[7] is None
    for i in range(7):
        w = np.asarray(want[i])
        np.testing.assert_allclose(got[i].numpy(), w,
                                   atol=1e-12 * np.abs(w).max())


# ---------------------------------------------------------------------------
# v3: tc-major bands and the in-kernel transpose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32out", "bf16out"])
def test_v3_plain_matches_pallas_v3(out_dtype):
    """The first CPU check of _corr_kernel_v3: no TPU-package test runs
    it.  Interpret mode runs its in-kernel transpose on the CPU."""
    rng = np.random.default_rng(31)
    n_cap = 2 * 9600 + 400
    cap = ((rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1) \
        .astype(np.complex64)
    tmpl = _templates(np.array([-5e3, 0.0, 5e3]))
    n_t, n_lags = tmpl.shape[0], n_cap - 136
    g = jp.bands_v2_for_templates(tmpl, precision="bf16", tc_major=True)
    t_pad, n_tc, n_rows, n_rb = jp.plan_pallas_v2(n_t, n_lags)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = jp.corr_pow_core_v2(
        jnp.real(cap), jnp.imag(cap), g, n_lags, n_t, t_pad, n_tc, n_rows,
        n_rb, interpret=True, precision="bf16", post="kernel",
        out_dtype=jdt)
    ref = _f32(ref).astype(np.float64)

    kern = tx.v3_operands(tmpl, CPU, out_dtype)
    got = tc.corr_pow_bf16(tc.capture_planes_bf16(torch.from_numpy(cap)),
                           kern.taps, n_lags, kern.out_dtype)
    assert got.dtype == out_dtype and got.shape == ref.shape
    gf = got.float().numpy().astype(np.float64)
    if out_dtype == torch.float32:
        # f32 sums of the same bf16 operands in another order
        assert np.max(np.abs(gf - ref)) < 1e-6 * ref.max()
    else:
        # both rounded once to bf16: within one bf16 step
        tol = 2.0 ** -7 * np.maximum(np.abs(gf), np.abs(ref)) \
            + 1e-5 * ref.max()
        assert np.all(np.abs(gf - ref) <= tol)
        assert np.mean(gf == ref) > 0.9


def test_kernel_operands_admit_only_the_tpu_routes():
    taps = tc.template_planes_bf16(_templates(np.array([0.0])), CPU)
    assert tx.KernelOperands("bf16", taps, None).route == "v2"
    with pytest.raises(ValueError):
        tx.KernelOperands("bf16", taps, None, torch.bfloat16, "v1")
    with pytest.raises(ValueError):
        tx.KernelOperands("int8", taps, 1.0, torch.float32, "v3")
    with pytest.raises(ValueError):
        tx.KernelOperands("f32", taps, None, torch.bfloat16)
    assert tx.v3_operands(_templates(np.array([0.0])), CPU,
                          torch.bfloat16).out_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The probes of tools/bench_corr_v2.py, re-created in interpret mode
# ---------------------------------------------------------------------------

def _pallas_sum_probe(cap, tmpl):
    """tools/bench_corr_v2.py:199-240 at rows_per_block 128, t_chunk 16,
    without the roll and the final jnp.sum: the probe's [8 n_rb, 128 n_tc]
    output."""
    n_t, n_lags = tmpl.shape[0], cap.shape[0] - 136
    g2 = jp.bands_v2_for_templates(tmpl, precision="bf16", t_chunk=16)
    t_pad, n_tc, n_rows, n_rb = jp.plan_pallas_v2(n_t, n_lags,
                                                  rows_per_block=128,
                                                  t_chunk=16)

    # kernel body verbatim from tools/bench_corr_v2.py:205-212
    def _sum_kernel(x_ref, g_ref, out_ref):
        acc = jnp.dot(x_ref[:], g_ref[:],
                      preferred_element_type=jnp.float32)
        h = acc.shape[1] // 2
        xr = acc[:, :h]
        xi = acc[:, h:]
        s = jnp.sum(xr * xr + xi * xi, axis=0, keepdims=True)
        out_ref[:] = jnp.broadcast_to(s[:, :128], (8, 128))

    # grid and BlockSpecs from tools/bench_corr_v2.py:225-239
    return pl.pallas_call(
        _sum_kernel,
        grid=(n_tc, n_rb),
        in_specs=[
            pl.BlockSpec((128, 2 * KV), lambda j, i: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((2 * KV, 2 * W * 16), lambda j, i: (0, j),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((8, 128), lambda j, i: (i, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8 * n_rb, 128 * n_tc), jnp.float32),
        interpret=True,
    )(_x3(jnp.asarray(cap), n_rows), g2)


@pytest.mark.parametrize("n_f,n_cap", [(3, 9600 + 400), (7, 2 * 9600 + 777)])
def test_sum_probe_plain_matches_pallas(n_f, n_cap):
    """T = 9 and 21 templates (one and two chunks, padded); one and two
    row blocks, the second past the capture's end."""
    rng = np.random.default_rng(40 + n_f)
    cap = ((rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1) \
        .astype(np.complex64)
    tmpl = _templates(np.arange(n_f) * 5e3 - 5e3 * (n_f // 2))
    out = np.asarray(_pallas_sum_probe(cap, tmpl))
    n_rb, n_tc = out.shape[0] // 8, out.shape[1] // 128
    # every row of each (8, 128) tile holds the same sums ...
    tiles = out.reshape(n_rb, 8, n_tc, 128)
    np.testing.assert_array_equal(tiles, np.broadcast_to(
        tiles[:, :1], tiles.shape))
    # ... whose lanes are the c-major (c, tc) columns c < 8
    ref = tiles[:, 0].reshape(n_rb, n_tc, 8, 16).astype(np.float64)

    got = tc.corr_pow_sum_bf16(
        tc.capture_planes_bf16(torch.from_numpy(cap)),
        tc.template_planes_bf16(tmpl, CPU), n_cap - 136)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tc.sum_shape(tmpl.shape[0], n_cap - 136) \
        == (n_rb, n_tc, 8, 16)
    g = got.numpy().astype(np.float64)
    assert np.all(g[:, -1, :, tmpl.shape[0] % 16 or 16:] == 0)  # zero taps
    np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-5 * ref.max())


def _pallas_int8_probe(cap, tmpl, m_i8):
    """tools/bench_corr_v2.py:343-395 at rows_per_block m_i8, without the
    roll and the final jnp.sum: the probe's [n_rows, 120 t_pad] bf16 map
    and its power scale inv."""
    n_t, n_lags = tmpl.shape[0], cap.shape[0] - 136
    tc_ = 16
    t_pad, n_tc, n_rows, n_rb = jp.plan_pallas_v2(n_t, n_lags,
                                                  rows_per_block=m_i8,
                                                  t_chunk=tc_)
    g_f32 = jp._im2col_bands(tmpl.astype(np.complex64), t_pad, n_tc, tc_)
    s_g = 127.0 / np.max(np.abs(g_f32))
    g_i8 = jnp.asarray(np.clip(np.round(g_f32 * s_g), -127, 127)
                       .astype(np.int8))
    inv = np.float32(1.0 / (128.0 * s_g)) ** 2
    n_cols = 2 * W * tc_

    # kernel body verbatim from tools/bench_corr_v2.py:355-364
    def _kern_i8(x_ref, g_ref, out_ref):
        acc = jax.lax.dot_general(
            x_ref[:], g_ref[:],
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        h = acc.shape[1] // 2
        xr = acc[:, :h].astype(jnp.float32)
        xi = acc[:, h:].astype(jnp.float32)
        out_ref[:] = ((xr * xr + xi * xi) * inv).astype(
            jnp.bfloat16)

    # grid and BlockSpecs from tools/bench_corr_v2.py:380-394
    out = pl.pallas_call(
        _kern_i8,
        grid=(n_tc, n_rb),
        in_specs=[
            pl.BlockSpec((m_i8, 2 * KV), lambda j, i: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((2 * KV, n_cols), lambda j, i: (0, j),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((m_i8, W * tc_),
                               lambda j, i: (i, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_rows, W * t_pad),
                                       jnp.bfloat16),
        interpret=True,
    )(_x3(jnp.asarray(cap), n_rows, int8=True), g_i8)
    # [rows, (j, c, tc)] c-major -> [template, lag], as corr_pow_core_v2
    out = _f32(out).reshape(n_rows, n_tc, W, tc_).transpose(1, 3, 0, 2)
    return out.reshape(t_pad, n_rows * W)[:n_t, :n_lags], inv


@pytest.mark.parametrize("n_f,m_i8", [(3, 128), (4, 64)])
def test_int8_probe_plain_matches_pallas(n_f, m_i8):
    n_cap = 2 * 9600 + 400
    rng = np.random.default_rng(50 + n_f)
    x = rng.integers(0, 256, size=(2, n_cap))
    cap = (((x[0] - 127) + 1j * (x[1] - 127)) / 128.0).astype(np.complex64)
    tmpl = _templates(np.arange(n_f) * 5e3 - 5e3)
    ref, inv = _pallas_int8_probe(cap, tmpl, m_i8)

    taps, _scale = tc.template_planes_int8(tmpl, CPU)
    assert tc.probe_inv(tmpl).tobytes() == np.float32(inv).tobytes()
    got = tc.corr_pow_int8_scaled(
        tc.capture_planes_int8(torch.from_numpy(cap)), taps, n_cap - 136,
        inv)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    ia = got.view(torch.int16).numpy().astype(np.int64)
    ib = torch.from_numpy(np.ascontiguousarray(ref)).to(torch.bfloat16) \
        .view(torch.int16).numpy().astype(np.int64)
    ulps = np.abs(ia - ib)
    # exact integer sums on both sides; the interpreter may contract
    # re*re + im*im into an FMA (ROADMAP Queue 3)
    assert np.mean(ulps == 0) >= 0.999
    assert ulps.max() <= 1


def test_int8_scaled_is_the_unscaled_map_times_the_scale():
    """Plain versions: the scaled map is the unscaled f32 power times inv,
    rounded once to bf16 (the unscaled map is rounded to bf16 itself, so
    the two agree within one bf16 step)."""
    cap = torch.from_numpy(np.random.default_rng(2).integers(
        -127, 128, size=(2, 3000)).astype(np.int8))
    taps, scale = tc.template_planes_int8(_templates(np.array([0.0, 5e3])),
                                          CPU)
    scaled = tc.corr_pow_int8_scaled(cap, taps, 2864, scale).double()
    unscaled = tc.corr_pow_int8(cap, taps, 2864).double() * float(scale)
    assert float((scaled - unscaled).abs().max()) \
        <= 2.0 ** -7 * float(scaled.max())


# ---------------------------------------------------------------------------
# Per-chunk launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_chunk", [16, 5])
def test_per_chunk_map_equals_one_launch(t_chunk):
    rng = np.random.default_rng(60)
    n_cap = 9600 + 400
    cap = tc.capture_planes_bf16(torch.from_numpy(
        (rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1))
    taps = tc.template_planes_bf16(
        _templates(np.arange(7) * 5e3 - 15e3), CPU)             # T = 21
    got = tc.corr_pow_bf16_per_chunk(cap, taps, n_cap - 136, t_chunk)
    want = tc.corr_pow_bf16(cap, taps, n_cap - 136)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ---------------------------------------------------------------------------
# Interop: the TPU package's band matrices -> the port's template planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_taps_from_v1_bands_equal_the_port_planes(precision):
    tmpl = _templates(np.arange(7) * 5e3 - 15e3)                # T = 21
    g_re, g_im = jp.bands_for_templates(tmpl, precision=precision)
    taps = interop.taps_from_bands(_f32(g_re), _f32(g_im))
    assert taps.dtype == torch.float32 and taps.shape == (2, 32, 137)
    planes = tc.template_planes_f32 if precision == "f32" \
        else tc.template_planes_bf16
    want = planes(tmpl, CPU).float()
    assert torch.equal(taps[:, :21], want)
    assert not taps[:, 21:].any()


@pytest.mark.parametrize("kind", ["f32", "bf16", "bf16_tc_major", "int8"])
def test_taps_from_v2_bands_equal_the_port_planes(kind):
    tmpl = _templates(np.arange(7) * 5e3 - 15e3)                # T = 21
    tc_major = kind.endswith("tc_major")
    if kind == "int8":
        g, _scale = jp.bands_v2_int8_for_templates(tmpl)
        g = np.asarray(g)
        want, _ = tc.template_planes_int8(tmpl, CPU)
    else:
        prec = kind.split("_")[0]
        g = _f32(jp.bands_v2_for_templates(tmpl, precision=prec,
                                           tc_major=tc_major))
        planes = tc.template_planes_f32 if prec == "f32" \
            else tc.template_planes_bf16
        want = planes(tmpl, CPU)
    taps = interop.taps_from_v2_bands(g, 21, tc_major=tc_major)
    assert taps.dtype == (torch.int8 if kind == "int8" else torch.float32)
    assert taps.shape == (2, 21, 137)
    assert torch.equal(taps, want.to(taps.dtype))


# ---------------------------------------------------------------------------
# The exact correlation's "conv" and "fft" methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["dot", "conv", "fft"])
def test_correlate_methods_match_tpu_package(method):
    rng = np.random.default_rng(70)
    n_cap = 3000
    cap = rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)
    tmpl = jx.pss_templates(np.array([-5e3, 0.0, 5e3]), FC, FC,
                            FS).reshape(-1, 137)
    want = np.asarray(jax_correlate(jnp.asarray(cap), jnp.asarray(tmpl),
                                    method=method))
    got = port_correlate(torch.from_numpy(cap), torch.from_numpy(tmpl),
                         method)
    assert got.dtype == torch.complex128 and got.shape == want.shape
    err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert err < 1e-10
    with pytest.raises(ValueError):
        port_correlate(torch.from_numpy(cap), torch.from_numpy(tmpl), "x")
