"""The operands of the port's tensor-core map kernels (pss_corr_bf16,
pss_corr_bf16_f32out, pss_corr_int8 and pss_corr_int8_scaled in
lte_cell_scanner_tpu_torch/csrc/pss_corr.cu) and of the sum probe
(pss_corr_sum_bf16, the same product with its sums kept in registers) on
the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain versions there).  Here the
kernels' arithmetic is emulated in float64 on their own operands -- the
Hankel matrix read from ``capture_words`` times ``pack_map_taps`` -- with
each kernel's epilogue, and held against the plain versions, which
tests/test_torch_corr_kernels.py and tests/test_torch_ab_kernels.py hold
against the TPU package's Pallas kernels in interpret mode; three cases
here also meet the Pallas int8 v2 kernel, the v3 kernel and the sum probe
of tools/bench_corr_v2.py directly.  Inputs are made with numpy from fixed
seeds.
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


def _hankel_sums(words, packed, n_t, n_lags):
    """The sum probe's arithmetic on its own operands: the f32 power of
    _hankel_map at every lag of whole row blocks (the capture zero past
    its words), then, by the kernel's own rule, lag l kept when l % 120 <
    8 and added to entry c = l % 8 of its row block, summed in float64."""
    n_rb = -(-n_lags // tc.SUM_BLOCK_LAGS)
    p = _hankel_map(words, packed, n_t, n_rb * tc.SUM_BLOCK_LAGS,
                    torch.float32)
    lag = torch.arange(p.shape[1])
    kept = lag[lag % tc.SUM_ROW_LAGS < tc.SUM_COLS]
    t = torch.arange(n_t)[:, None].expand(-1, kept.numel())
    rb, c = (kept // tc.SUM_BLOCK_LAGS).expand_as(t), (kept % 8).expand_as(t)
    sums = torch.zeros(tc.sum_shape(n_t, n_lags), dtype=torch.float64)
    sums.index_put_((rb, t // tc.SUM_T_CHUNK, c, t % tc.SUM_T_CHUNK),
                    p[:, kept].double(), accumulate=True)
    return sums


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


# the map shapes (one row block) and two row blocks with a ragged third,
# T = 21 (two chunks of 16, the second padded; not a multiple of a block's
# 32 templates)
SUM_SHAPES = SHAPES + [(21, 2 * 15360 + 777)]


@pytest.mark.parametrize("n_t,n_cap", SUM_SHAPES)
def test_sum_hankel_product_is_within_1e5_of_the_plain_version(n_t, n_cap):
    """pss_corr_sum_bf16: the exact products of the bf16 operands, the f32
    power of every kept lag, summed in another order (f32 in registers
    and atomics in the kernel, float64 here, f32 in the plain version):
    within 1e-5 of the largest sum; the lags past the capture add
    nothing, the chunk's padded templates are zero."""
    cap, taps = _operands("bf16", n_t, n_cap, 70 + n_t)
    n_lags = n_cap - 136
    words = tc.capture_words(cap[None])[0]
    got = _hankel_sums(words, tc.pack_map_taps(taps), n_t, n_lags)
    ref = tc.corr_pow_sum_bf16_plain(cap, taps, n_lags).double()
    assert got.shape == ref.shape == tc.sum_shape(n_t, n_lags)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.max())
    by_t = got.permute(0, 2, 1, 3).reshape(got.shape[0], tc.SUM_COLS, -1)
    assert not by_t[..., n_t:].any()
    assert bool(by_t[..., :n_t].gt(0).all())


def _x3(cap, n_rows):
    """The sum probe's bf16 im2col rows of the zero-padded capture
    (tools/bench_corr_v2.py:214-224)."""
    kv, w = jp.KV_V2, jp.W_V2
    planes = []
    for plane in (jnp.real(cap), jnp.imag(cap)):
        p = plane.astype(jnp.float32)
        p = jnp.concatenate([p, jnp.zeros(w * (n_rows + 2) - p.shape[0],
                                          p.dtype)])
        a = p.reshape(n_rows + 2, w)
        planes.append(jnp.concatenate([a[:-2], a[1:-1], a[2:, : kv - 2 * w]],
                                      axis=1))
    return jnp.concatenate(planes, axis=1).astype(jnp.bfloat16)


def _pallas_sum_probe(cap, tmpl):
    """tools/bench_corr_v2.py:199-240 at rows_per_block 128, t_chunk 16,
    without the roll and the final jnp.sum, in interpret mode: the
    probe's sums [n_rb, n_tc, 8, 16] (row 0 of each (8, 128) output tile,
    whose 8 rows are equal)."""
    kv, w = jp.KV_V2, jp.W_V2
    n_t, n_lags = tmpl.shape[0], cap.shape[0] - 136
    g2 = jp.bands_v2_for_templates(tmpl, precision="bf16", t_chunk=16)
    _t_pad, n_tc, n_rows, n_rb = jp.plan_pallas_v2(n_t, n_lags,
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
    out = pl.pallas_call(
        _sum_kernel,
        grid=(n_tc, n_rb),
        in_specs=[
            pl.BlockSpec((128, 2 * kv), lambda j, i: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((2 * kv, 2 * w * 16), lambda j, i: (0, j),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((8, 128), lambda j, i: (i, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8 * n_rb, 128 * n_tc), jnp.float32),
        interpret=True,
    )(_x3(jnp.asarray(cap), n_rows), g2)
    tiles = np.asarray(out).reshape(n_rb, 8, n_tc, 128)
    return tiles[:, 0].reshape(n_rb, n_tc, 8, 16)


def test_sum_hankel_product_meets_the_pallas_sum_probe():
    """The emulated sum probe against the TPU package's probe kernel in
    interpret mode on the same capture and templates: T = 21 (two chunks),
    two row blocks, the second past the capture's end; f32 sums of the
    same bf16 products in other orders, within 1e-5 of the largest sum."""
    n_cap = 2 * 9600 + 777
    rng = np.random.default_rng(17)
    cap = ((rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1) \
        .astype(np.complex64)
    tmpl = _templates(21).astype(np.complex64)
    ref = _pallas_sum_probe(cap, tmpl).astype(np.float64)
    planes = tc.capture_planes_bf16(torch.from_numpy(cap))
    taps = tc.template_planes_bf16(tmpl, CPU)
    got = _hankel_sums(tc.capture_words(planes[None])[0],
                       tc.pack_map_taps(taps), 21, n_cap - 136).numpy()
    assert got.shape == ref.shape == (2, 2, 8, 16)
    assert np.max(np.abs(got - ref)) <= 1e-5 * ref.max()


def test_sum_probe_geometry():
    """What the sum kernel's register epilogue rests on: a 256-lag tile
    lies in one row block, and lane (g, q) of the m16n8 accumulator holds
    only lags = g (mod 8) of a tile starting at a multiple of 8, so every
    lag it keeps (l % 120 < 8) has c = g.  On the CPU the wrapper gives
    the same S with and without the taps packed, and refuses a malformed
    packing."""
    assert tc.SUM_BLOCK_LAGS % tc.MAP_TILE_LAGS == 0
    assert tc.SUM_ROW_LAGS % 8 == 0 and tc.MAP_TILE_LAGS % 8 == 0
    assert tc.SUM_COLS == 8
    lag = torch.arange(2 * tc.SUM_BLOCK_LAGS)
    kept = lag[lag % tc.SUM_ROW_LAGS < tc.SUM_COLS]
    assert torch.equal(kept % tc.SUM_ROW_LAGS, kept % 8)
    tile = lag // tc.MAP_TILE_LAGS
    assert torch.equal(tile * tc.MAP_TILE_LAGS // tc.SUM_BLOCK_LAGS,
                       lag // tc.SUM_BLOCK_LAGS)

    cap, taps = _operands("bf16", 21, 2000, 5)
    want = tc.corr_pow_sum_bf16(cap, taps, 1864)
    assert torch.equal(tc.corr_pow_sum_bf16(cap, taps, 1864,
                                            tc.pack_map_taps(taps)), want)
    with pytest.raises(ValueError):          # packed taps of another T
        tc.corr_pow_sum_bf16(cap, taps, 1864, tc.pack_map_taps(taps[:, :20]))
    with pytest.raises(ValueError):          # of another type
        tc.corr_pow_sum_bf16(cap, taps, 1864,
                             tc.pack_map_taps(taps).float())
    with pytest.raises(ValueError):          # not contiguous
        tc.corr_pow_sum_bf16(cap, taps, 1864,
                             tc.pack_map_taps(taps).transpose(1, 2))


@pytest.mark.parametrize("grid_x", [1, 7, 44, 600])
def test_sum_atomics_follow_the_walk(grid_x):
    """sum_atomics counts one flush per lane of each template and per row
    block that a block's run of tiles touches: one run per row block at
    one block, one per tile at one tile per block, and in between the
    runs that cross a row-block boundary twice."""
    n_lags = 10 * tc.SUM_BLOCK_LAGS
    n_tiles = n_lags // tc.MAP_TILE_LAGS
    per_block = tc.SUM_BLOCK_LAGS // tc.MAP_TILE_LAGS
    touched = sum(len({k // per_block for k in range(n_tiles * x // grid_x,
                                                      n_tiles * (x + 1)
                                                      // grid_x)})
                  for x in range(grid_x))
    assert tc.sum_atomics(93, n_lags, grid_x) == 8 * 93 * touched
    assert tc.sum_atomics(93, n_lags, 1) == 8 * 93 * 10
    assert tc.sum_atomics(93, n_lags, n_tiles) == 8 * 93 * n_tiles


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
