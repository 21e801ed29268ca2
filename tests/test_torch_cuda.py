"""The port's CUDA kernels on the card, against their plain versions.

Each test needs a CUDA device and skips without one.  This file imports
neither JAX nor the TPU package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu_torch.models.search import (SearchConfig,
                                                      cell_search,
                                                      default_f_search_set)
from lte_cell_scanner_tpu_torch.models.xcorr import (combine_start_indices,
                                                     pss_templates)
from lte_cell_scanner_tpu_torch.ops import corr_cuda, corr_fold_cuda
from lte_cell_scanner_tpu_torch.parallel.carriers import scan_band
from lte_cell_scanner_tpu_torch.sim.scenarios import (BAND_CELL_CARRIERS,
                                                      TWO_CELL_TRUTH,
                                                      adc_quantize,
                                                      band_captures,
                                                      two_cell_capture)

FS = 1.92e6
FC = 739e6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launched():
    """The kernels launched since the last reset, with their counts."""
    return {k: v for k, v in corr_cuda.LAUNCHES.items() if v}


def _operands(precision, n_f, n_cap, seed, device):
    rng = np.random.default_rng(seed)
    tmpl = pss_templates(np.arange(n_f) * 5e3, FC, FC, FS).reshape(-1, 137)
    if precision == "f32":
        cap = torch.from_numpy(0.1 * (rng.normal(size=n_cap) + 1j
                                      * rng.normal(size=n_cap))).to(device)
        return (corr_cuda.capture_planes_f32(cap),
                corr_cuda.template_planes_f32(tmpl, device))
    if precision == "int8":
        codes = rng.integers(0, 256, size=(2, n_cap))
        codes[0, ::53] = 255                      # saturated +128 codes
        cap = torch.from_numpy((codes[0] - 127 + 1j * (codes[1] - 127))
                               / 128.0).to(device)
        taps, _scale = corr_cuda.template_planes_int8(tmpl, device)
        return corr_cuda.capture_planes_int8(cap), taps
    cap = torch.from_numpy(0.1 * (rng.normal(size=n_cap)
                                  + 1j * rng.normal(size=n_cap))).to(device)
    return (corr_cuda.capture_planes_bf16(cap),
            corr_cuda.template_planes_bf16(tmpl, device))


def _map_operands(precision, n_t, n_cap, seed, device):
    """_operands with T = n_t templates: the first n_t of the 3 n_f
    templates of n_f = ceil(n_t / 3) hypotheses."""
    cap, taps = _operands(precision, -(-n_t // 3), n_cap, seed, device)
    return cap, taps[:, :n_t].contiguous()


# the tensor-core map kernels: ragged lag tiles (n_lags not a multiple of
# 256, and 6 lags), T not a multiple of a column group's 4 templates or a
# block's 32, the production T = 93, and the full width (one 80 ms
# capture at T = 93)
MAP_SHAPES = [(3, 137 + 5), (9, 9600 + 401), (21, 2 * 9600 + 777),
              (5, 9600 + 401), (16, 2 * 9600 + 777), (93, 2 * 9600 + 777),
              (93, 153600)]


@pytest.mark.parametrize("n_t,n_cap", MAP_SHAPES)
def test_bf16_kernel_matches_its_plain_version(cuda, n_t, n_cap):
    cap, taps = _map_operands("bf16", n_t, n_cap, 1 + n_t, cuda)
    n_lags = n_cap - 136
    before = corr_cuda.LAUNCHES["pss_corr_bf16"]
    got = corr_cuda.corr_pow_bf16(cap, taps, n_lags)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES["pss_corr_bf16"] == before + 1
    ref = corr_cuda.corr_pow_bf16_plain(cap, taps, n_lags)
    g, r = got.float(), ref.float()
    # f32 sums in another order, each rounded once to bf16: one bf16 step
    tol = 2.0 ** -7 * torch.maximum(g.abs(), r.abs()) + 1e-5 * r.max()
    assert bool(((g - r).abs() <= tol).all())


@pytest.mark.parametrize("n_t,n_cap", MAP_SHAPES)
def test_int8_kernel_is_bit_equal_to_its_plain_version(cuda, n_t, n_cap):
    cap, taps = _map_operands("int8", n_t, n_cap, 2 + n_t, cuda)
    n_lags = n_cap - 136
    got = corr_cuda.corr_pow_int8(cap, taps, n_lags)
    ref = corr_cuda.corr_pow_int8_plain(cap, taps, n_lags)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("adc", [False, True], ids=["bf16", "int8"])
def test_packed_taps_of_kernel_operands_give_the_same_map(cuda, adc):
    """The main path's operands (KernelOperands packs the taps once) and
    the wrapper's own packing: the same map, bit for bit, at full width."""
    from lte_cell_scanner_tpu_torch.models.xcorr import _front_staging
    cap = two_cell_capture()
    if adc:
        cap = adc_quantize(cap)
    cap_t, _tmpl, _starts, kern, _n = _front_staging(
        cap, default_f_search_set(FC, 100.0), FC, FC, FS, "auto", cuda, None,
        True)
    assert kern.precision == ("int8" if adc else "bf16")
    n_lags = cap_t.shape[0] - 136
    if adc:
        planes = corr_cuda.capture_planes_int8(cap_t)
        name, wrapper = "pss_corr_int8", corr_cuda.corr_pow_int8
    else:
        planes = corr_cuda.capture_planes_bf16(cap_t)
        name, wrapper = "pss_corr_bf16", corr_cuda.corr_pow_bf16
    corr_cuda.reset_launch_counts()
    got = wrapper(planes, kern.taps, n_lags, packed=kern.packed)
    want = wrapper(planes, kern.taps, n_lags)
    torch.cuda.synchronize()
    assert _launched() == {name: 2}
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("adc", [False, True],
                         ids=["bf16_f32out", "int8_scaled"])
def test_packed_taps_of_kernel_operands_give_the_same_f32_and_scaled_maps(
        cuda, adc):
    """The f32 map of the v1 route's operands and the int8 probe's scaled
    map: KernelOperands' packed taps and the wrapper's own packing give
    the same map, bit for bit, at full width."""
    from lte_cell_scanner_tpu_torch.models.xcorr import (_front_staging,
                                                         v1_operands)
    cap = two_cell_capture()
    if adc:
        cap = adc_quantize(cap)
    cap_t, tmpl, _starts, kern, _n = _front_staging(
        cap, default_f_search_set(FC, 100.0), FC, FC, FS, "auto", cuda, None,
        True)
    n_lags = cap_t.shape[0] - 136
    tmpl = tmpl.reshape(-1, 137).cpu().numpy()
    if adc:
        planes = corr_cuda.capture_planes_int8(cap_t)
        inv = corr_cuda.probe_inv(tmpl)
        name, bits = "pss_corr_int8_scaled", torch.int16

        def run(packed):
            return corr_cuda.corr_pow_int8_scaled(planes, kern.taps, n_lags,
                                                  inv, packed)
    else:
        kern = v1_operands(tmpl, "bf16", cuda)
        planes = corr_cuda.capture_planes_bf16(cap_t)
        name, bits = "pss_corr_bf16_f32out", torch.int32

        def run(packed):
            return corr_cuda.corr_pow_bf16(planes, kern.taps, n_lags,
                                           torch.float32, packed)
    corr_cuda.reset_launch_counts()
    got = run(kern.packed)
    want = run(None)
    torch.cuda.synchronize()
    assert _launched() == {name: 2}
    assert torch.equal(got.view(bits), want.view(bits))


RAGGED = [(1, 137 + 5), (3, 9600 + 401), (7, 2 * 9600 + 777)]
# pss_corr_f32 on the CUDA cores at the ragged shapes; the tensor-core
# pss_corr_bf16_f32out at the map kernels' shapes and full width
F32_MAP_CASES = [("f32", 3 * n_f, n_cap) for n_f, n_cap in RAGGED] \
    + [("bf16", n_t, n_cap) for n_t, n_cap in MAP_SHAPES]


@pytest.mark.parametrize("precision,n_t,n_cap", F32_MAP_CASES)
def test_f32_map_kernels_match_their_plain_version(cuda, precision, n_t,
                                                   n_cap):
    """pss_corr_f32 and pss_corr_bf16_f32out: f32 sums of the same
    operands in another order, within 1e-5 x the map's max."""
    cap, taps = _map_operands(precision, n_t, n_cap, 5 + n_t, cuda)
    n_lags = n_cap - 136
    corr_cuda.reset_launch_counts()
    if precision == "f32":
        got = corr_cuda.corr_pow_f32(cap, taps, n_lags)
        name = "pss_corr_f32"
    else:
        got = corr_cuda.corr_pow_bf16(cap, taps, n_lags, torch.float32)
        name = "pss_corr_bf16_f32out"
    torch.cuda.synchronize()
    assert _launched() == {name: 1}
    ref = corr_cuda.corr_pow_f32_plain(cap, taps, n_lags)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.max())


@pytest.mark.parametrize("n_t,n_cap", MAP_SHAPES)
def test_int8_scaled_kernel_is_bit_equal_to_its_plain_version(cuda, n_t,
                                                              n_cap):
    cap, taps = _map_operands("int8", n_t, n_cap, 8 + n_t, cuda)
    inv = corr_cuda.probe_inv(pss_templates(
        np.arange(-(-n_t // 3)) * 5e3, FC, FC, FS).reshape(-1, 137))
    corr_cuda.reset_launch_counts()
    got = corr_cuda.corr_pow_int8_scaled(cap, taps, n_cap - 136, inv)
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_int8_scaled": 1}
    ref = corr_cuda.corr_pow_int8_scaled_plain(cap, taps, n_cap - 136, inv)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("n_t,n_cap", MAP_SHAPES)
def test_sum_kernel_matches_its_plain_version(cuda, n_t, n_cap):
    """pss_corr_sum_bf16 on the tensor cores, one launch and no other, at
    the ragged shapes, T = 5, 16, 93 and full width: f32 powers of the
    kept lags summed in another order (and flushed by atomics in an order
    that varies between runs), within 1e-5 of the largest sum."""
    cap, taps = _map_operands("bf16", n_t, n_cap, 9 + n_t, cuda)
    corr_cuda.reset_launch_counts()
    got = corr_cuda.corr_pow_sum_bf16(cap, taps, n_cap - 136)
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_sum_bf16": 1}
    ref = corr_cuda.corr_pow_sum_bf16_plain(cap, taps, n_cap - 136)
    assert got.shape == ref.shape == corr_cuda.sum_shape(n_t, n_cap - 136)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_packed_taps_of_kernel_operands_give_the_same_sums(cuda):
    """The sum probe on the main path's bf16 operands at full width:
    KernelOperands' packed taps and the wrapper's own packing give S
    within 1e-6 of the largest sum (the atomics' order varies)."""
    from lte_cell_scanner_tpu_torch.models.xcorr import _front_staging
    cap_t, _tmpl, _starts, kern, _n = _front_staging(
        two_cell_capture(), default_f_search_set(FC, 100.0), FC, FC, FS,
        "auto", cuda, None, True)
    assert kern.precision == "bf16"
    planes = corr_cuda.capture_planes_bf16(cap_t)
    n_lags = cap_t.shape[0] - 136
    corr_cuda.reset_launch_counts()
    got = corr_cuda.corr_pow_sum_bf16(planes, kern.taps, n_lags, kern.packed)
    want = corr_cuda.corr_pow_sum_bf16(planes, kern.taps, n_lags)
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_sum_bf16": 2}
    assert float((got - want).abs().max()) <= 1e-6 * float(want.max())


@pytest.mark.parametrize("t_chunk", [16, 5])
def test_per_chunk_launches_equal_one_launch(cuda, t_chunk):
    cap, taps = _operands("bf16", 7, 2 * 9600 + 777, 12, cuda)   # T = 21
    corr_cuda.reset_launch_counts()
    got = corr_cuda.corr_pow_bf16_per_chunk(cap, taps, 2 * 9600 + 641,
                                            t_chunk)
    want = corr_cuda.corr_pow_bf16(cap, taps, 2 * 9600 + 641)
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_bf16_per_chunk": -(-21 // t_chunk),
                           "pss_corr_bf16": 1}
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_xcorr_core_v1_route_launches_one_kernel(cuda):
    """The v1 route of xcorr_core on the two-cell capture: one launch of
    pss_corr_bf16_f32out and nothing else; the strongest peak where the
    production route puts it."""
    from lte_cell_scanner_tpu_torch.models.xcorr import (_front_staging,
                                                         v1_operands,
                                                         xcorr_core)
    cap = two_cell_capture()
    f_set = default_f_search_set(FC, 100.0)
    cap_t, tmpl, starts, kern, _n = _front_staging(
        cap, f_set, FC, FC, FS, "auto", cuda, None, True)
    v1 = v1_operands(tmpl.reshape(-1, 137).cpu().numpy(), "bf16", cuda)
    corr_cuda.reset_launch_counts()
    got = xcorr_core(cap_t, None, starts, 2, False, True, v1)
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_bf16_f32out": 1}
    want = xcorr_core(cap_t, None, starts, 2, False, True, kern)
    assert int(got[2].argmax()) == int(want[2].argmax())
    assert float((got[2] - want[2]).abs().max()) < 2e-2 * float(
        want[2].max())


def test_wrapper_raises_instead_of_falling_back(cuda):
    cap, taps = _operands("bf16", 1, 400, 0, cuda)
    with pytest.raises(ValueError):
        corr_cuda.corr_pow_bf16(cap, taps.cpu(), 264)
    with pytest.raises(TypeError):
        corr_cuda.corr_pow_int8(cap, taps, 264)


@pytest.mark.parametrize("adc", [False, True], ids=["bf16", "int8"])
def test_cell_search_decodes_both_cells_on_the_card(cuda, adc):
    cap = two_cell_capture()
    if adc:
        cap = adc_quantize(cap)
    name = "pss_corr_int8" if adc else "pss_corr_bf16"
    corr_cuda.reset_launch_counts()
    cells = cell_search(cap, default_f_search_set(FC, 100.0), FC, FC, FS,
                        SearchConfig(), device=cuda)
    assert corr_cuda.LAUNCHES[name] >= 1
    assert sorted(c.n_id_cell() for c in cells) == sorted(TWO_CELL_TRUTH)
    for c in cells:
        assert (c.n_rb_dl, c.n_ports) == (6, 2)


def test_saturated_peak_records_fall_back_on_the_card(cuda, monkeypatch):
    """When the device peak loop fills its record buffer, cell_search
    reruns the front end with the unbounded host peak search -- still
    through the kernel -- and finds the same cells."""
    from lte_cell_scanner_tpu_torch.models import search

    cap = two_cell_capture()
    f_set = default_f_search_set(FC, 100.0)
    want = cell_search(cap, f_set, FC, FC, FS, device=cuda)
    monkeypatch.setattr(search, "PEAK_CAP", 1)
    corr_cuda.reset_launch_counts()
    got = cell_search(cap, f_set, FC, FC, FS, device=cuda)
    assert corr_cuda.LAUNCHES["pss_corr_bf16"] == 2
    assert [(c.n_id_cell(), c.ind, c.sfn) for c in got] == \
        [(c.n_id_cell(), c.ind, c.sfn) for c in want]
    for g, w in zip(got, want):
        assert abs(g.freq_superfine - w.freq_superfine) < 1e-3


def _fold_operands(precision, case, n_c, device):
    """C captures of 3 x 9600 + 400 samples with a fold-start table: the
    +-75 kHz grid (real deltas of both signs, T = 21), a synthetic +-60
    table (the TPU's wide window, T = 15), the production +-100 ppm grid
    at 739 MHz (T = 93, n_f = 31 not a multiple of the block's 4
    hypotheses), or a table whose start spread within one block of
    hypotheses is the widest the kernel stages (T = 15), with starts
    before the capture and reads past its end."""
    rng = np.random.default_rng(7 + n_c)
    n_cap = 3 * 9600 + 400
    if case == "grid":
        f_set = np.arange(-75e3, 75e3 + 1, 25e3)
        starts = combine_start_indices(f_set, FC, FC, FS, 3)
        assert starts.min() == 0 and (starts - 9600 * np.arange(3)).min() < 0
    elif case == "production":
        f_set = default_f_search_set(FC, 100.0)
        starts = combine_start_indices(f_set, FC, FC, FS, 3)
    elif case == "limit":
        f_set = np.arange(-10e3, 10e3 + 1, 5e3)
        starts = 9600 * np.arange(3)[None, :].repeat(len(f_set), axis=0)
        starts[0, 0] = -40
        starts[1, 1] += corr_fold_cuda._SPAN_MAX - corr_fold_cuda._SPAN_BASE
        starts[3, 2] += 300
    else:
        f_set = np.arange(-10e3, 10e3 + 1, 5e3)
        deltas = rng.integers(-60, 61, size=(len(f_set), 3))
        deltas[:, 0] = 0
        starts = 9600 * np.arange(3)[None, :] + deltas
    starts = torch.from_numpy(starts.astype(np.int32)).to(device)
    tmpl = pss_templates(f_set, FC, FC, FS).reshape(-1, 137)
    if precision == "int8":
        codes = rng.integers(0, 256, size=(n_c, 2, n_cap))
        cap = torch.from_numpy((codes[:, 0] - 127 + 1j * (codes[:, 1] - 127))
                               / 128.0).to(device)
        taps, _scale = corr_cuda.template_planes_int8(tmpl, device)
        return corr_cuda.capture_planes_int8(cap), taps, starts
    cap = torch.from_numpy(0.1 * (rng.normal(size=(n_c, n_cap))
                                  + 1j * rng.normal(size=(n_c, n_cap))))
    return (corr_cuda.capture_planes_bf16(cap.to(device)),
            corr_cuda.template_planes_bf16(tmpl, device), starts)


# ragged carrier counts (1 and 37: the band's second chunk), T = 21, 15
# and 93 (not multiples of the kernel's 12 templates per block or of the
# TPU's 16), deltas of both signs, +-60, and the widest staged spread
FOLD_CASES = [("grid", 3), ("wide", 5), ("production", 1),
              ("production", 37), ("limit", 2)]


@pytest.mark.parametrize("case,n_c", FOLD_CASES)
def test_bf16_fold_kernel_matches_its_plain_version(cuda, case, n_c):
    cap, taps, starts = _fold_operands("bf16", case, n_c, cuda)
    before = corr_cuda.LAUNCHES["pss_corr_fold_bf16"]
    got = corr_fold_cuda.corr_fold_bf16(cap, taps, starts)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES["pss_corr_fold_bf16"] == before + 1
    ref = corr_fold_cuda.corr_fold_bf16_plain(cap, taps, starts)
    assert got.shape == ref.shape == (n_c, taps.shape[1], 9600)
    # f32 sums of exact bf16 products in another order
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.max())


@pytest.mark.parametrize("case,n_c", FOLD_CASES)
def test_int8_fold_kernel_is_bit_equal_to_its_plain_version(cuda, case, n_c):
    cap, taps, starts = _fold_operands("int8", case, n_c, cuda)
    got = corr_fold_cuda.corr_fold_int8(cap, taps, starts)
    ref = corr_fold_cuda.corr_fold_int8_plain(cap, taps, starts)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_fold_kernel_refuses_a_spread_past_its_span(cuda, precision):
    """One sample more spread than the kernel stages: ValueError before
    any launch."""
    cap, taps, starts = _fold_operands(precision, "limit", 1, cuda)
    starts[1, 1] += 1
    wrapper = corr_fold_cuda.corr_fold_int8 if precision == "int8" \
        else corr_fold_cuda.corr_fold_bf16
    corr_cuda.reset_launch_counts()
    with pytest.raises(ValueError):
        wrapper(cap, taps, starts)
    torch.cuda.synchronize()
    assert _launched() == {}


def test_scan_band_on_a_slice_of_the_band(cuda):
    """Five carriers of the 10 MHz band around its middle cell carrier:
    one launch of the fused bf16 kernel, no v2 launch, the two cells on
    744.0 MHz and nothing elsewhere."""
    band, _adc = band_captures()
    mid = BAND_CELL_CARRIERS[1]
    part = band[mid - 2: mid + 3]
    corr_cuda.reset_launch_counts()
    cells = scan_band(part, default_f_search_set(FC, 100.0), FS,
                      device=cuda)
    assert _launched() == {"pss_corr_fold_bf16": 1}
    assert [sorted(c.n_id_cell() for c in cl) for cl in cells] == \
        [[], [], sorted(TWO_CELL_TRUTH), [], []]
    for c in cells[2]:
        assert (c.n_rb_dl, c.n_ports) == (6, 2)


def test_saturated_band_records_take_the_host_peak_search(cuda, monkeypatch):
    """When a carrier of a chunk fills its peak records, the chunk's peak
    search runs on the host from the front end's maps (one fused launch
    still) and finds the same cells."""
    from lte_cell_scanner_tpu_torch.parallel import carriers

    band, _adc = band_captures()
    mid = BAND_CELL_CARRIERS[1]
    part = band[mid - 1: mid + 2]
    f_set = default_f_search_set(FC, 100.0)
    want = scan_band(part, f_set, FS, device=cuda)
    monkeypatch.setattr(carriers, "PEAK_CAP", 1)
    corr_cuda.reset_launch_counts()
    got = scan_band(part, f_set, FS, device=cuda)
    assert corr_cuda.LAUNCHES["pss_corr_fold_bf16"] == 1
    assert [[(c.n_id_cell(), c.ind, c.sfn) for c in cl] for cl in got] == \
        [[(c.n_id_cell(), c.ind, c.sfn) for c in cl] for cl in want]
    assert [len(cl) for cl in got] == [0, 2, 0]
    for g, w in zip(got[1], want[1]):
        assert abs(g.freq_superfine - w.freq_superfine) < 1e-3


def test_scan_band_takes_the_v2_route_on_a_wide_chunk(cuda):
    """A chunk spanning 200 MHz: the cell carrier's fold starts lie 3
    samples from the middle carrier's table, so the chunk runs the v2
    kernel once per carrier with each carrier's exact fold."""
    band, _adc = band_captures()
    cap, fc, fcp = band[BAND_CELL_CARRIERS[1]]
    noise = band[BAND_CELL_CARRIERS[1] + 1][0]
    corr_cuda.reset_launch_counts()
    cells = scan_band([(cap, fc, fcp), (noise, fc + 200e6, fcp + 200e6)],
                      default_f_search_set(FC, 100.0), FS, device=cuda)
    assert _launched() == {"pss_corr_bf16": 2}
    assert [sorted(c.n_id_cell() for c in cl) for cl in cells] == \
        [sorted(TWO_CELL_TRUTH), []]
