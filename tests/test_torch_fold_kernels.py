"""The port's fused correlation-plus-fold kernels (lte_cell_scanner_tpu_torch/
ops/corr_fold_cuda.py) against the TPU package's v4 Pallas kernels, and
the v4 gate against the TPU package's.

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
from lte_cell_scanner_tpu.models.search import default_f_search_set
from lte_cell_scanner_tpu.ops import corr_pallas as jp
from lte_cell_scanner_tpu.parallel import carriers as jc
from lte_cell_scanner_tpu_torch.ops import corr_cuda as tc
from lte_cell_scanner_tpu_torch.ops import corr_fold_cuda as tf
from lte_cell_scanner_tpu_torch.parallel import carriers as tcar

FS = 1.92e6
FC = 739e6
CPU = torch.device("cpu")


def _templates(f_set):
    return jx.pss_templates(f_set, FC, FC, FS, np.complex64).reshape(-1, 137)


def _jax_v4(caps, g, n_comb, n_t, precision):
    t_pad, n_tc = jp.plan_pallas_v4(n_t)
    out = jp.corr_fold_core_v4(jnp.asarray(caps.real), jnp.asarray(caps.imag),
                               g, n_comb, n_t, t_pad, n_tc, interpret=True,
                               precision=precision)
    return np.asarray(out)


def _grid_band(seed, n_c, n_cap):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 255, size=(n_c, n_cap))
    y = rng.integers(0, 255, size=(n_c, n_cap))
    return (((x - 127) + 1j * (y - 127)) / 128.0).astype(np.complex64)


def _starts(case, n_cap):
    """(f_set, starts): a +-75 kHz grid with real deltas of both signs,
    or a synthetic +-60 delta table that needs the TPU's wide window."""
    n_comb = (n_cap - 136 - 100) // 9600
    if case == "grid":
        f_set = np.arange(-75e3, 75e3 + 1, 25e3)
        starts = jx.combine_start_indices(f_set, FC, FC, FS, n_comb)
        d = jp.delta_table(starts)
        assert d.min() < 0 < d.max()
        assert jp.v4_kv_for(starts) == jp.KV_V2
        return f_set, starts
    rng = np.random.default_rng(5)
    f_set = np.arange(-10e3, 10e3 + 1, 5e3)
    deltas = rng.integers(-60, 61, size=(len(f_set), n_comb))
    deltas[:, 0] = 0          # as in reality: delta(t, 0) = 0
    starts = 9600 * np.arange(n_comb)[None, :] + deltas
    assert jp.v4_kv_for(starts) == jp.KV_V4_WIDE
    return f_set, starts


@pytest.mark.parametrize("case", ["grid", "wide"])
def test_bf16_plain_matches_pallas_v4(case):
    rng = np.random.default_rng(0)
    n_cap = 3 * 9600 + 400
    cap = ((rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1) \
        .astype(np.complex64)
    f_set, starts = _starts(case, n_cap)
    tmpl = _templates(f_set)
    g = jp.bands_v4_for_templates(tmpl, starts, precision="bf16")
    ref = _jax_v4(cap[None], g, starts.shape[1], tmpl.shape[0], "bf16")
    got = tf.corr_fold_bf16(
        tc.capture_planes_bf16(torch.from_numpy(cap[None])),
        tc.template_planes_bf16(tmpl, CPU),
        torch.from_numpy(starts.astype(np.int32)))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (1, tmpl.shape[0], 9600)
    # f32 sums of exact bf16 products, taken in another order
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5 * ref.max()


def test_int8_plain_matches_pallas_v4_on_five_carriers():
    n_c, n_cap = 5, 2 * 9600 + 400
    caps = _grid_band(1, n_c, n_cap)
    assert all(tc.is_adc_grid(c) for c in caps)
    f_set = np.arange(-10e3, 10e3 + 1, 5e3)
    n_comb = (n_cap - 136 - 100) // 9600
    starts = jx.combine_start_indices(f_set, FC, FC, FS, n_comb)
    tmpl = _templates(f_set)
    g_i8, scale = jp.bands_v4_for_templates(tmpl, starts, precision="int8")
    ref = _jax_v4(caps, g_i8, n_comb, tmpl.shape[0], "int8")
    taps, power_scale = tc.template_planes_int8(tmpl, CPU)
    assert np.float32(power_scale).tobytes() == np.float32(scale).tobytes()
    got = tf.corr_fold_int8(tc.capture_planes_int8(torch.from_numpy(caps)),
                            taps, torch.from_numpy(starts.astype(np.int32)))
    assert got.shape == ref.shape == (n_c, tmpl.shape[0], 9600)
    got = got.numpy()
    # exact integer sums on both sides, and the interpreter's contracted
    # re*re + im*im is the port's fma(re, re, im*im)
    assert np.mean(got == ref) >= 0.999
    assert np.max(np.abs(got - ref)) <= 1e-6 * ref.max()


def test_int8_taps_equal_the_pallas_v4_band_entries():
    """Period 0 of the TPU's v4 int8 band matrix: column (chunk j, Re
    half, lag c = 0, template tc) holds the Re taps in rows B .. B+136 and
    the -Im taps in rows kv+B .. kv+B+136, and nothing else."""
    f_set = np.arange(-10e3, 10e3 + 1, 5e3)
    starts = jx.combine_start_indices(f_set, FC, FC, FS, 2)
    tmpl = _templates(f_set)
    g_i8, _scale = jp.bands_v4_for_templates(tmpl, starts, precision="int8")
    kv = jp.KV_V2
    b = jp.v4_back_shift(kv)
    g0 = np.asarray(g_i8).reshape(2, 2 * kv, -1)[0]
    taps, _ = tc.template_planes_int8(tmpl, CPU)
    taps = taps.numpy()
    for t in range(tmpl.shape[0]):
        j, t_c = divmod(t, 16)
        col = g0[:, j * 2 * jp.W_V4 * 16 + t_c]
        np.testing.assert_array_equal(taps[0, t], col[b: b + 137])
        np.testing.assert_array_equal(taps[1, t], -col[kv + b: kv + b + 137])
        rest = np.concatenate([col[:b], col[b + 137: kv + b],
                               col[kv + b + 137:]])
        assert not rest.any()


def _hankel_fold(words, packed, starts):
    """The CUDA kernel's arithmetic on its own operands, in float64: for
    each carrier, hypothesis f and period m, the Hankel matrix A[l, 2k + c]
    read from the staged words at sample s[f, m] + l + k (word s + 4; bf16:
    one word per tap, int8: one word per pair of taps) times the packed B
    [288, 8]; then each period's power fma(re, re, im * im) and the f32
    fold in period order."""
    n_c, n_w, per_word = words.shape
    n_f, n_comb = starts.shape
    step = per_word // 2                     # samples per word
    lo = min(0, int(starts.min()))
    hi = int(starts.max()) + 9600 + tf.TAPS_PAD
    # the kernel reads zeros outside the staged words
    pad = torch.zeros((n_c, max(hi + 4, n_w) - lo, per_word),
                      dtype=torch.float64)
    pad[:, -lo: n_w - lo] = words.double()
    b = packed.double()
    out = torch.zeros((n_c, 3 * n_f, 9600), dtype=torch.float32)
    for c in range(n_c):
        hank = pad[c].unfold(0, tf.TAPS_PAD, 1)[..., ::step] \
            .permute(0, 2, 1).reshape(-1, 2 * tf.TAPS_PAD)
        for f in range(n_f):
            for m in range(n_comb):
                row = int(starts[f, m]) + 4 - lo
                ab = hank[row: row + 9600] @ b[f].T          # [9600, 8]
                re = ab[:, 0:6:2].float().T
                im = ab[:, 1:6:2].float().T
                p = (re.double() * re.double() + (im * im).double()).float()
                out[c, f::n_f] += p
    return out


@pytest.mark.parametrize("case", ["grid", "wide"])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_packed_operands_reproduce_the_plain_fold(precision, case):
    """pack_fold_taps and capture_words are what the CUDA kernel reads:
    the Hankel product of the two in float64, with the kernel's epilogue
    and fold, equals the int8 plain version and is within 1e-6 x max of
    the bf16 one."""
    n_cap = 3 * 9600 + 400
    f_set, starts = _starts(case, n_cap)
    tmpl = _templates(f_set)
    st = torch.from_numpy(starts.astype(np.int32))
    if precision == "int8":
        cap = tc.capture_planes_int8(torch.from_numpy(_grid_band(3, 2, n_cap)))
        taps, _scale = tc.template_planes_int8(tmpl, CPU)
        ref = tf.corr_fold_int8_plain(cap, taps, st)
    else:
        rng = np.random.default_rng(4)
        x = 0.1 * (rng.normal(size=(2, n_cap))
                   + 1j * rng.normal(size=(2, n_cap)))
        cap = tc.capture_planes_bf16(torch.from_numpy(x))
        taps = tc.template_planes_bf16(tmpl, CPU)
        ref = tf.corr_fold_bf16_plain(cap, taps, st)
    words = tf.capture_words(cap)
    packed = tf.pack_fold_taps(taps)
    assert packed.dtype == taps.dtype
    assert packed.shape == (len(f_set), 8, 2 * tf.TAPS_PAD)
    assert not packed[:, 6:].any() and not packed[..., 2 * 137:].any()
    assert words.dtype == cap.dtype and words.shape[1] % 4 == 0
    assert words.shape[1] >= n_cap + 4
    assert words.shape[2] == (4 if precision == "int8" else 2)
    got = _hankel_fold(words, packed, starts)
    if precision == "int8":
        assert torch.equal(got, ref)
    else:
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.max())


def test_span_capacity_follows_the_kernel_block():
    """Words a block stages: 402 at zero spread (256 lags, 143 taps, 3
    words of alignment), plus the widest start spread within any 4
    consecutive hypotheses, in whole 16-byte chunks, up to 4096; past it
    the wrapper raises before any launch."""
    base = 9600 * np.arange(3)[None, :].repeat(9, axis=0)
    assert tf._span_capacity(torch.from_numpy(base.astype(np.int32))) == 404
    spread = base.copy()
    spread[4, 1] += 50          # second block of hypotheses
    spread[8, 2] -= 7           # a block of one (n_f = 9)
    assert tf._span_capacity(torch.from_numpy(spread.astype(np.int32))) == 452
    limit = tf._SPAN_MAX - tf._SPAN_BASE
    spread[5, 2] += limit
    assert tf._span_capacity(torch.from_numpy(spread.astype(np.int32))) \
        == tf._SPAN_MAX
    spread[5, 2] += 1
    with pytest.raises(ValueError):
        tf._span_capacity(torch.from_numpy(spread.astype(np.int32)))


@pytest.mark.parametrize("ms,ppm,kv", [(80, 100.0, 256), (160, 200.0, 384),
                                       (320, 300.0, 0)])
def test_v4_gate_matches_tpu_package(ms, ppm, kv):
    f_set = default_f_search_set(FC, ppm)
    n_comb = (ms * 1920 - 136 - 100) // 9600
    tables = np.stack([jx.combine_start_indices(f_set, f, f, FS, n_comb)
                       for f in (FC, FC + 1e5)])
    mid = tables[1]
    np.testing.assert_array_equal(tf.delta_table(mid), jp.delta_table(mid))
    for k in (tf.KV_V2, tf.KV_V4_WIDE):
        assert tf.v4_back_shift(k) == jp.v4_back_shift(k)
        assert tf.v4_applicable(mid, k) == jp.v4_applicable(mid, 0, k)
    assert (tf.v4_kv_for(mid) or 0) == (jp.v4_kv_for(mid) or 0) == kv
    assert tcar.v4_band_kv(tables) == jc.v4_band_kv(tables) == kv


def test_ten_mhz_band_mid_table_within_one_sample():
    f_set = default_f_search_set(FC, 100.0)
    n_comb = (153600 - 136 - 100) // 9600
    tables = np.stack([jx.combine_start_indices(f_set, f, f, FS, n_comb)
                       for f in FC + 1e5 * np.arange(101)])
    mid = tables[len(tables) // 2]
    assert np.max(np.abs(tables - mid[None])) == 1
    assert tcar.v4_band_kv(tables) == jc.v4_band_kv(tables) == 256
    # a chunk whose edge starts drift further than one sample from the
    # middle table takes the v2 route
    far = tables.copy()
    far[0, :, -1] += 2
    assert tcar.v4_band_kv(far) == jc.v4_band_kv(far) == 0


def test_wrappers_reject_bad_operands():
    cap = tc.capture_planes_bf16(torch.zeros((2, 20000), dtype=torch.complex64))
    taps = tc.template_planes_bf16(np.zeros((6, 137), np.complex64), CPU)
    starts = torch.tensor([[0, 9600], [1, 9601]], dtype=torch.int32)
    assert tf.corr_fold_bf16(cap, taps, starts).shape == (2, 6, 9600)
    with pytest.raises(TypeError):
        tf.corr_fold_int8(cap, taps, starts)
    with pytest.raises(TypeError):
        tf.corr_fold_bf16(cap, taps, starts.long())
    with pytest.raises(ValueError):
        tf.corr_fold_bf16(cap[0], taps, starts)              # no carrier axis
    with pytest.raises(ValueError):
        tf.corr_fold_bf16(cap, taps[:, :5], starts)          # T != 3 n_f
    with pytest.raises(ValueError):
        tf.corr_fold_bf16(cap[:, :, ::2], taps, starts)      # not contiguous
    with pytest.raises(ValueError):
        tf.corr_fold_bf16(cap.to("meta"), taps.to("meta"),
                          starts.to("meta"))                  # no kernel
