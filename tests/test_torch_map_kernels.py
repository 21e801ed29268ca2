"""The operands of the port's tensor-core map kernels (pss_corr_bf16,
pss_corr_bf16_f32out, pss_corr_int8 and pss_corr_int8_scaled in
lte_cell_scanner_tpu_torch/csrc/pss_corr.cu) on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain versions there).  Here the
kernels' arithmetic is emulated in float64 on their own operands -- the
Hankel matrix read from ``capture_words`` times ``pack_map_taps`` -- with
each kernel's epilogue, and held against the plain versions, which
tests/test_torch_corr_kernels.py and tests/test_torch_ab_kernels.py hold
against the TPU package's Pallas kernels in interpret mode; two cases
here also meet the Pallas int8 v2 kernel and the v3 kernel directly.
Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.models import xcorr as jx
from lte_cell_scanner_tpu.ops import corr_pallas as jp
from lte_cell_scanner_tpu_torch.models import xcorr as tx
from lte_cell_scanner_tpu_torch.ops import corr_cuda as tc
from lte_cell_scanner_tpu_torch.ops import corr_fold_cuda as tf

FS = 1.92e6
FC = 739e6
CPU = torch.device("cpu")

# (T, n_cap): one template on the smallest capture (6 lags), T not a
# multiple of the 4 templates of a column group or of a block's 32, and
# the production T = 93 (+-100 ppm at 739 MHz); every n_lags ragged
# against the 256-lag tile
SHAPES = [(1, 137 + 5), (3, 1000 + 37), (5, 9600 + 401), (16, 2000 + 3),
          (93, 2 * 256 + 199)]


def _templates(n_t):
    n_f = -(-n_t // 3)
    f_set = np.arange(n_f) * 5e3 - 5e3 * (n_f // 2)
    return tx.pss_templates(f_set, FC, FC, FS, np.complex64) \
        .reshape(-1, 137)[:n_t]


def _grid_capture(seed, n_cap):
    """An 8-bit ADC-grid capture with the saturated +128 code on every
    53rd real sample and on the last one."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=n_cap)
    y = rng.integers(0, 256, size=n_cap)
    x[::53] = 255
    x[-1] = 255
    return ((x - 127) + 1j * (y - 127)) / 128.0


def _operands(precision, n_t, n_cap, seed):
    tmpl = _templates(n_t)
    if precision == "int8":
        cap = _grid_capture(seed, n_cap)
        assert tc.is_adc_grid(cap)
        taps, _scale = tc.template_planes_int8(tmpl, CPU)
        return tc.capture_planes_int8(torch.from_numpy(cap)), taps
    rng = np.random.default_rng(seed)
    cap = 0.1 * (rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap))
    return (tc.capture_planes_bf16(torch.from_numpy(cap)),
            tc.template_planes_bf16(tmpl, CPU))


def _hankel_map(words, packed, n_t, n_lags, out_dtype=torch.bfloat16,
                inv=None):
    """The map kernels' arithmetic on their own operands, in float64: the
    Hankel matrix A[l, 2k + c] read from the staged words at sample l + k
    (word l + k + 4; bf16: one word per tap, int8: one word per pair of
    taps), zero past the words, times the packed B [288, 8 groups]; then
    Re and Im to f32 and the kernels' epilogues: the power re*re + im*im
    as separately rounded f32 operations, times the f32 ``inv`` when given
    (the scaled int8 map), stored as ``out_dtype`` (bf16 RNE or f32)."""
    n_w, per_word = words.shape
    step = per_word // 2                     # samples per word
    pad = torch.zeros((max(n_w, n_lags + 4 + tc.TAPS_PAD), per_word),
                      dtype=torch.float64)
    pad[:n_w] = words.double()
    hank = pad[4:].unfold(0, tc.TAPS_PAD, 1)[..., ::step] \
        .permute(0, 2, 1).reshape(-1, 2 * tc.TAPS_PAD)[:n_lags]
    ab = hank @ packed.double().reshape(-1, 2 * tc.TAPS_PAD).T
    re = ab[:, 0::2][:, :n_t].T.float()      # column 2t: Re of template t
    im = ab[:, 1::2][:, :n_t].T.float()
    p = re * re + im * im
    if inv is not None:
        p = p * torch.tensor(np.float32(inv))
    return p.to(out_dtype)


@pytest.mark.parametrize("n_t,n_cap", SHAPES)
def test_int8_hankel_product_is_bit_equal_to_the_plain_version(n_t, n_cap):
    """The int8 sums are exact in the tensor cores, so the packed
    operands with the kernel's epilogue give corr_pow_int8_plain bit for
    bit, the last lag (n_cap - 137, whose pair word reaches one sample
    past the capture) and the saturated codes included."""
    cap, taps = _operands("int8", n_t, n_cap, 30 + n_t)
    n_lags = n_cap - 136
    words = tc.capture_words(cap[None])[0]
    got = _hankel_map(words, tc.pack_map_taps(taps), n_t, n_lags)
    ref = tc.corr_pow_int8_plain(cap, taps, n_lags)
    assert got.shape == ref.shape == (n_t, n_lags)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    assert bool(ref[:, -1].float().gt(0).all())


@pytest.mark.parametrize("n_t,n_cap", SHAPES)
def test_bf16_hankel_product_is_within_one_step_of_the_plain_version(
        n_t, n_cap):
    """Exact products of the bf16 operands summed in another order (f32
    in the kernel, float64 here, f32 in the plain version), each rounded
    once to bf16: within one bf16 step, or 1e-5 x the map's max where Re
    and Im cancel."""
    cap, taps = _operands("bf16", n_t, n_cap, 40 + n_t)
    n_lags = n_cap - 136
    words = tc.capture_words(cap[None])[0]
    got = _hankel_map(words, tc.pack_map_taps(taps), n_t, n_lags).float()
    ref = tc.corr_pow_bf16_plain(cap, taps, n_lags).float()
    tol = 2.0 ** -7 * torch.maximum(got.abs(), ref.abs()) \
        + 1e-5 * float(ref.max())
    assert bool(((got - ref).abs() <= tol).all())
    assert float((got == ref).double().mean()) > 0.9


@pytest.mark.parametrize("n_t,n_cap", SHAPES)
def test_f32_hankel_product_is_within_1e6_of_the_plain_version(n_t, n_cap):
    """pss_corr_bf16_f32out: exact products of the bf16 operands summed in
    another order (f32 in mma order in the kernel, float64 here, f32 in
    the plain version), stored as f32: within 1e-6 x the map's max."""
    cap, taps = _operands("bf16", n_t, n_cap, 50 + n_t)
    n_lags = n_cap - 136
    words = tc.capture_words(cap[None])[0]
    got = _hankel_map(words, tc.pack_map_taps(taps), n_t, n_lags,
                      torch.float32)
    ref = tc.corr_pow_f32_plain(cap, taps, n_lags)
    assert got.dtype == ref.dtype == torch.float32
    assert got.shape == ref.shape == (n_t, n_lags)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.max())


@pytest.mark.parametrize("n_t,n_cap", SHAPES)
def test_int8_scaled_hankel_product_is_bit_equal_to_the_plain_version(
        n_t, n_cap):
    """pss_corr_int8_scaled: the exact int8 sums, the power and the
    product with the probe's f32 scale each rounded once, then bf16: the
    plain version bit for bit, saturated codes and the last lag
    included."""
    cap, taps = _operands("int8", n_t, n_cap, 60 + n_t)
    inv = tc.probe_inv(_templates(n_t))
    n_lags = n_cap - 136
    words = tc.capture_words(cap[None])[0]
    got = _hankel_map(words, tc.pack_map_taps(taps), n_t, n_lags, inv=inv)
    ref = tc.corr_pow_int8_scaled_plain(cap, taps, n_lags, inv)
    assert got.shape == ref.shape == (n_t, n_lags)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    assert bool(ref[:, -1].float().gt(0).all())


def test_f32_hankel_product_meets_the_pallas_v3_kernel():
    """The emulated f32 map against the TPU package's _corr_kernel_v3
    (post="kernel", f32 map) in interpret mode on the same bf16 operands
    (the v3 route's packed taps, KernelOperands.packed): f32 sums in
    another order, within 1e-6 x the map's max."""
    n_cap = 2 * 9600 + 400
    rng = np.random.default_rng(11)
    cap = ((rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1) \
        .astype(np.complex64)
    tmpl = _templates(9).astype(np.complex64)
    n_lags = n_cap - 136
    g = jp.bands_v2_for_templates(tmpl, precision="bf16", tc_major=True)
    t_pad, n_tc, n_rows, n_rb = jp.plan_pallas_v2(9, n_lags)
    ref = jp.corr_pow_core_v2(
        jnp.real(cap), jnp.imag(cap), g, n_lags, 9, t_pad, n_tc, n_rows,
        n_rb, interpret=True, precision="bf16", post="kernel",
        out_dtype=jnp.float32)
    ref = torch.from_numpy(np.array(ref, dtype=np.float32))
    kern = tx.v3_operands(tmpl, CPU, torch.float32)
    planes = tc.capture_planes_bf16(torch.from_numpy(cap))
    got = _hankel_map(tc.capture_words(planes[None])[0], kern.packed, 9,
                      n_lags, torch.float32)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.max())


def test_int8_hankel_product_meets_the_pallas_v2_kernel():
    """The emulated int8 kernel against the TPU package's
    _corr_kernel_v2_int8 in interpret mode on the same ADC-grid capture:
    exact integer sums on both sides; the squares may round one bf16 step
    apart where the interpreter contracts re*re + im*im (ROADMAP Queue 3),
    at most 0.1% of the entries."""
    n_cap = 2 * 9600 + 400
    cap = _grid_capture(9, n_cap).astype(np.complex64)
    tmpl = _templates(9).astype(np.complex64)
    g_i8, _scale = jp.bands_v2_int8_for_templates(tmpl)
    n_lags = n_cap - 136
    t_pad, n_tc, n_rows, n_rb = jp.plan_pallas_v2(9, n_lags)
    ref = jp.corr_pow_core_v2(
        jnp.real(cap), jnp.imag(cap), g_i8, n_lags, 9, t_pad, n_tc, n_rows,
        n_rb, interpret=True, precision="int8", post="xla",
        out_dtype=jnp.bfloat16)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))) \
        .to(torch.bfloat16).view(torch.int16).long()
    planes = tc.capture_planes_int8(torch.from_numpy(cap))
    taps, _ = tc.template_planes_int8(tmpl, CPU)
    got = _hankel_map(tc.capture_words(planes[None])[0],
                      tc.pack_map_taps(taps), 9, n_lags)
    ulps = (got.view(torch.int16).long() - ref).abs()
    assert float((ulps == 0).double().mean()) >= 0.999
    assert int(ulps.max()) <= 1


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("n_t", [1, 5, 93])
def test_pack_map_taps_layout(precision, n_t):
    """[ceil(T / 4), 8, 288] of the taps' type: template 4n + q in
    columns 2q (Re) and 2q + 1 (Im) of group n, K index 2k + c; zero at
    taps 137-143 and in the columns past T; -Im exact in int8."""
    _cap, taps = _operands(precision, n_t, 200, 1)
    b = tc.pack_map_taps(taps)
    n_g = -(-n_t // 4)
    assert b.dtype == taps.dtype and b.is_contiguous()
    assert b.shape == (n_g, 8, 2 * tc.TAPS_PAD)
    cols = b.reshape(n_g * 4, 2, tc.TAPS_PAD, 2)     # [t, re/im col, k, c]
    assert not cols[n_t:].any()
    assert not cols[:, :, 137:].any()
    tr, ti = taps[0], taps[1]
    assert torch.equal(cols[:n_t, 0, :137, 0], tr)
    assert torch.equal(cols[:n_t, 0, :137, 1], -ti)
    assert torch.equal(cols[:n_t, 1, :137, 0], ti)
    assert torch.equal(cols[:n_t, 1, :137, 1], tr)
    if precision == "int8":
        assert int(ti.abs().max()) <= 127
        assert torch.equal(cols[:n_t, 0, :137, 1].int(), -ti.int())


def test_capture_words_are_shared_with_the_fold_kernels():
    assert tf.capture_words is tc.capture_words
    assert tf.TAPS_PAD == tc.TAPS_PAD == 144
    cap = tc.capture_planes_int8(torch.from_numpy(_grid_capture(2, 11)))
    words = tc.capture_words(cap[None])[0]
    # 4 guard words, 11 samples, zeros up to 16 words; int8 word j holds
    # samples j - 4 and j - 3
    assert words.shape == (16, 4)
    assert not words[:3].any() and torch.equal(words[3, 2:], cap[:, 0])
    assert torch.equal(words[4:14, :2], cap[:, :10].T)
    assert torch.equal(words[4:14, 2:], cap[:, 1:11].T)
    assert torch.equal(words[14, :2], cap[:, 10]) and not words[14, 2:].any()


def test_kernel_operands_pack_the_map_taps_once():
    """KernelOperands packs the taps of every map of bf16 or int8
    operands (the v2 routes, v1 with bf16 bands, v3 with either map) when
    it is made; f32 operands keep their planes.  On the CPU the wrappers
    check the packed taps and return the plain version either way."""
    cap, taps = _operands("int8", 5, 700, 3)
    kern = tx.KernelOperands("int8", taps, 1.0)
    assert torch.equal(kern.packed, tc.pack_map_taps(taps))
    assert torch.equal(tc.corr_pow_int8(cap, taps, 564, kern.packed),
                       tc.corr_pow_int8(cap, taps, 564))
    inv = tc.probe_inv(_templates(5))
    assert torch.equal(
        tc.corr_pow_int8_scaled(cap, taps, 564, inv, kern.packed),
        tc.corr_pow_int8_scaled(cap, taps, 564, inv))
    cap_b, taps_b = _operands("bf16", 5, 700, 3)
    assert tx.KernelOperands("bf16", taps_b, None).packed.dtype \
        == torch.bfloat16
    kern_f = tx.KernelOperands("bf16", taps_b, None, torch.float32)
    assert torch.equal(kern_f.packed, tc.pack_map_taps(taps_b))
    assert torch.equal(
        tc.corr_pow_bf16(cap_b, taps_b, 564, torch.float32, kern_f.packed),
        tc.corr_pow_bf16(cap_b, taps_b, 564, torch.float32))
    taps_f = tc.template_planes_f32(_templates(5), CPU)
    assert tx.KernelOperands("f32", taps_f, None, torch.float32).packed \
        is None
    with pytest.raises(ValueError):          # packed taps of another T
        tc.corr_pow_int8(cap, taps, 564, tc.pack_map_taps(taps[:, :4]))
    with pytest.raises(ValueError):          # of another type
        tc.corr_pow_bf16(cap_b, taps_b, 564, packed=kern.packed)
    with pytest.raises(ValueError):          # the f32 map, another T
        tc.corr_pow_bf16(cap_b, taps_b, 564, torch.float32,
                         tc.pack_map_taps(taps_b[:, :4]))
    with pytest.raises(ValueError):          # the scaled map, another type
        tc.corr_pow_int8_scaled(cap, taps, 564, inv, kern_f.packed)


def test_a_library_older_than_a_shared_header_is_rebuilt(tmp_path,
                                                         monkeypatch):
    """Both kernel sources include csrc/hankel_mma.cuh, so a library
    older than any header beside its source is stale, as one older than
    the source itself is."""
    import os

    from lte_cell_scanner_tpu_torch import cuda_build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, hdr = csrc / "k.cu", csrc / "h.cuh"
    src.write_text("")
    hdr.write_text("")
    monkeypatch.setattr(cuda_build, "SOURCES", {"k": src})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    assert cuda_build._stale("k")                    # no library yet
    lib = cuda_build.library_path("k")
    lib.parent.mkdir()
    lib.write_text("")
    for path, t in ((src, 100), (hdr, 100), (lib, 200)):
        os.utime(path, (t, t))
    assert not cuda_build._stale("k")
    os.utime(hdr, (300, 300))
    assert cuda_build._stale("k")
    os.utime(hdr, (100, 100))
    os.utime(src, (300, 300))
    assert cuda_build._stale("k")
