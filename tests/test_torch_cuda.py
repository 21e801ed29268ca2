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
# capture at T = 93, and a 160 ms one)
MAP_SHAPES = [(3, 137 + 5), (9, 9600 + 401), (21, 2 * 9600 + 777),
              (5, 9600 + 401), (16, 2 * 9600 + 777), (93, 2 * 9600 + 777),
              (93, 153600), (93, 307200), (111, 153600),
              # a time block of the (t x f) grids of chip_smoke.py phase
              # 10 (153600 / 4 samples and the 280-sample halo) at T = 93
              # (4 x 1), 6 (4 x 2 over 4 hypotheses) and 3 (the tracker's
              # searcher grid)
              (93, 38400 + 280), (6, 38400 + 280), (3, 38400 + 280)]


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


@pytest.mark.parametrize("kind", ["u8", "it"])
def test_file_capture_takes_its_kernel(cuda, tmp_path, kind):
    """A raw rtl_sdr u8 file lies on the 8-bit ADC grid: its cell_search
    makes exactly one pss_corr_int8 launch; an .it file of the float
    capture one pss_corr_bf16 launch.  Both decode cells 277 and 271."""
    from lte_cell_scanner_tpu_torch.io.capture import FileSource
    from lte_cell_scanner_tpu_torch.utils.itfile import write_itfile
    from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8
    cap = two_cell_capture()
    path = str(tmp_path / f"cap.{kind}")
    if kind == "u8":
        complex_to_iq_u8(adc_quantize(cap)).tofile(path)
    else:
        write_itfile(path, {"capbuf": cap,
                            "fc": np.array([int(FC)], np.int32)})
    capbuf, _fc = FileSource([path]).capture(FC)
    corr_cuda.reset_launch_counts()
    cells = cell_search(capbuf, default_f_search_set(FC, 100.0), FC, FC, FS,
                        device=cuda)
    torch.cuda.synchronize()
    name = "pss_corr_int8" if kind == "u8" else "pss_corr_bf16"
    assert _launched() == {name: 1}
    assert sorted(c.n_id_cell() for c in cells) == sorted(TWO_CELL_TRUTH)
    for c in cells:
        assert (c.n_rb_dl, c.n_ports) == (6, 2)


@pytest.mark.parametrize("kw", [{"interp": "2stage"},
                                {"interp": "freq_time"},
                                {"compat": "golden"},
                                {"batch_peaks": False}],
                         ids=["2stage", "freq_time", "golden",
                              "peak-at-a-time"])
def test_search_variants_decode_both_cells_on_the_card(cuda, kw):
    """Every SearchConfig variant decodes both cells with the default
    run's ID, CP, ports and SFN (freq_superfine within 1 Hz)."""
    cap = two_cell_capture()
    f_set = default_f_search_set(FC, 100.0)
    want = {c.n_id_cell(): c for c in cell_search(cap, f_set, FC, FC, FS,
                                                  device=cuda)}
    got = cell_search(cap, f_set, FC, FC, FS, SearchConfig(**kw),
                      device=cuda)
    assert sorted(c.n_id_cell() for c in got) == sorted(TWO_CELL_TRUTH)
    for c in got:
        w = want[c.n_id_cell()]
        assert (c.cp_type, c.n_ports, c.sfn, c.n_rb_dl) == \
            (w.cp_type, w.n_ports, w.sfn, 6)
        assert abs(c.freq_superfine - w.freq_superfine) < 1.0


def test_long_coupled_capture_decodes_on_the_card(cuda):
    """160 ms through the coupled crystal channel at 60 kHz: one v2 bf16
    launch over 307064 lags (31 half frames folded), cell 277 decoded."""
    from lte_cell_scanner_tpu_torch.io.capture import SimSource
    cap, _ = SimSource(coupled_fc=FC, freq_offset=60e3,
                       capture_ms=160).capture(FC)
    corr_cuda.reset_launch_counts()
    cells = cell_search(cap, default_f_search_set(FC, 100.0), FC, FC, FS,
                        device=cuda)
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_bf16": 1}
    best = {c.n_id_cell(): c for c in cells}[277]
    assert best.n_rb_dl == 6
    assert abs(best.freq_fine - 60e3) < 50.0


def test_band_of_u8_files_through_the_cli(cuda, tmp_path, capsys):
    """A 3-carrier band (-e) from three u8 files, one batched scan_band:
    one chunk, so one pss_corr_fold_int8 launch and no other; the two
    cells on the first carrier only."""
    from lte_cell_scanner_tpu_torch import cli
    from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8
    rng = np.random.default_rng(2)
    paths = []
    for k in range(3):
        cap = two_cell_capture() if k == 0 else 0.1 * (
            rng.normal(size=153600) + 1j * rng.normal(size=153600))
        paths.append(str(tmp_path / f"c{k}.u8"))
        complex_to_iq_u8(adc_quantize(cap)).tofile(paths[-1])
    corr_cuda.reset_launch_counts()
    assert cli.main(["search", "-s", "739e6", "-e", "739.2e6", "-p", "100",
                     "--load-files"] + paths) == 0
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_fold_int8": 1}
    out = capsys.readouterr().out
    assert "Scanning 3 carriers" in out
    rows = [ln.split() for ln in out.splitlines()
            if ln[:4] in ("277 ", "271 ")]
    assert sorted(r[0] for r in rows) == ["271", "277"]
    assert all(r[2] == "739M" for r in rows)


def test_debug_dump_takes_the_host_route_on_the_card(cuda, tmp_path):
    """With a debug dump active, cell_search on the card brings the front
    end's maps back, runs the host peak search and exports them (one
    kernel launch still), and decodes the same cells."""
    from lte_cell_scanner_tpu_torch.utils import debug
    from lte_cell_scanner_tpu_torch.utils.itfile import read_itfile
    cap = two_cell_capture()
    f_set = default_f_search_set(FC, 100.0)
    want = cell_search(cap, f_set, FC, FC, FS, device=cuda)
    path = str(tmp_path / "dump.it")
    debug.set_dump(debug.DebugDump(path))
    try:
        corr_cuda.reset_launch_counts()
        got = cell_search(cap, f_set, FC, FC, FS, device=cuda)
        torch.cuda.synchronize()
    finally:
        debug.set_dump(None)
    assert _launched() == {"pss_corr_bf16": 1}
    assert read_itfile(path)["xc_incoherent_collapsed_pow"].shape == \
        (3, 9600)
    assert [(c.n_id_cell(), c.sfn) for c in got] == \
        [(c.n_id_cell(), c.sfn) for c in want]


# ---------------------------------------------------------------------------
# The streaming tracker (tracker/) on the card
# ---------------------------------------------------------------------------

def _tracker_stream():
    """The 400 ms stream of tests/test_tracker.py:23-35 (cell 277, +300
    Hz, 5 dB), made by the port's own simulator."""
    from lte_cell_scanner_tpu_torch.cell import CpType
    from lte_cell_scanner_tpu_torch.sim import (apply_freq_offset, awgn,
                                                create_dl_sig)
    rng = np.random.default_rng(11)
    sig = create_dl_sig(CpType.NORMAL, 400, 0, 92, 1, 0.4, rng=rng,
                        n_ports=2, sfn=4)
    return awgn(apply_freq_offset(sig, 300.0), 5.0, rng=rng)


def _track(sig, **kw):
    from lte_cell_scanner_tpu_torch.tracker import TrackerRunner
    runner = TrackerRunner(FC, FC, FS, **kw)
    try:
        for i in range(0, len(sig), 10000):
            runner.process_block(sig[i: i + 10000])
    finally:
        runner.close()
    return runner


def test_tracker_native_runtime_loads(cuda):
    from lte_cell_scanner_tpu_torch.io import native
    lib = native.load()
    assert native.get_lib() is lib
    assert native.LIB_PATH.parent.name == "build"


@pytest.mark.parametrize("adc", [False, True], ids=["bf16", "int8"])
def test_searcher_t3_map_matches_its_plain_version(cuda, adc):
    """The background searcher's one hypothesis: T = 3 templates (padded
    to one column group) at the full 153600-sample capture."""
    from lte_cell_scanner_tpu_torch.models.xcorr import _front_staging
    cap = two_cell_capture()
    if adc:
        cap = adc_quantize(cap)
    cap_t, _tmpl, _starts, kern, _n = _front_staging(
        cap, np.array([200.0]), FC, FC, FS, "auto", cuda, None, True)
    assert kern.taps.shape[1] == 3
    n_lags = cap_t.shape[0] - 136
    if adc:
        planes = corr_cuda.capture_planes_int8(cap_t)
        got = corr_cuda.corr_pow_int8(planes, kern.taps, n_lags,
                                      packed=kern.packed)
        ref = corr_cuda.corr_pow_int8_plain(planes, kern.taps, n_lags)
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    else:
        planes = corr_cuda.capture_planes_bf16(cap_t)
        got = corr_cuda.corr_pow_bf16(planes, kern.taps, n_lags,
                                      packed=kern.packed).float()
        ref = corr_cuda.corr_pow_bf16_plain(planes, kern.taps,
                                            n_lags).float()
        tol = 2.0 ** -7 * torch.maximum(got.abs(), ref.abs()) \
            + 1e-5 * ref.max()
        assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.parametrize("adc_grid,wire", [(True, torch.float16),
                                            (False, torch.float64)],
                         ids=["float16-planes", "float64-planes"])
def test_device_loop_tick_matches_the_cpu_program(cuda, adc_grid, wire):
    """The tick computes in complex128 on the card too: cuFFT against
    pocketfft in float64."""
    from lte_cell_scanner_tpu_torch.tracker.device_loop import (
        _tick_program, download)
    from tools_torch.bench_tracker_device import staged_tick
    args = staged_tick(4, 64, "cuda", adc_grid=adc_grid)
    assert args[0].dtype == wire
    got = download(_tick_program(*args))
    ref = _tick_program(*staged_tick(4, 64, "cpu", adc_grid=adc_grid)) \
        .numpy()
    assert got.shape == ref.shape
    # the demodulated rows apart from the 4 cells' final phases
    for sl in (slice(None, -4), slice(-4, None)):
        assert np.abs(got[sl] - ref[sl]).max() \
            <= 1e-9 * np.abs(ref[sl]).max()


def test_tracker_trajectory_matches_the_cpu_at_the_device_loop_tolerance(
        cuda, monkeypatch):
    """The 400 ms stream through the card's float64 device loop and the
    CPU's, from the same acquisition (the card run's searcher on the
    CPU: the first acquisition seeds the offset register, and the card's
    own searcher is complex64): frame timing and offset register within
    the TPU package's device-loop tolerances
    (tests/test_tracker.py:917-930)."""
    from lte_cell_scanner_tpu_torch.tracker import runner as trunner
    sig = _tracker_stream()
    ref = _track(sig, device_loop=True, device="cpu")
    real = trunner.search_once
    monkeypatch.setattr(trunner, "search_once", lambda *a, **k: real(
        *a, **{**k, "device": "cpu"}))
    card = _track(sig, device_loop=True, device="cuda")
    assert [c.n_id_cell for c in card.cells] == [277]
    assert [c.n_id_cell for c in ref.cells] == [277]
    assert card.cells[0].frame_timing == pytest.approx(
        ref.cells[0].frame_timing, rel=0.0, abs=1e-6)
    assert card.state.frequency_offset == pytest.approx(
        ref.state.frequency_offset, rel=1e-9, abs=1e-6)


def test_tracker_trajectory_end_to_end_within_the_measured_limit(cuda):
    """The 400 ms stream with the card's own complex64 searcher: frame
    timing within the device-loop tolerance of the CPU run's, and the
    offset register within chip_smoke.E2E_OFFSET_HZ of it (its seed
    comes from the complex64 search, which the loop forgets slowly)."""
    from chip_smoke import E2E_OFFSET_HZ
    sig = _tracker_stream()
    ref = _track(sig, device_loop=True, device="cpu")
    card = _track(sig, device_loop=True, device="cuda")
    assert [c.n_id_cell for c in card.cells] == [277]
    assert [c.n_id_cell for c in ref.cells] == [277]
    assert card.cells[0].frame_timing == pytest.approx(
        ref.cells[0].frame_timing, rel=0.0, abs=1e-6)
    assert card.state.frequency_offset == pytest.approx(
        ref.state.frequency_offset, rel=0.0, abs=E2E_OFFSET_HZ)


def test_tracker_holds_a_cell_on_the_card(cuda):
    sig = _tracker_stream()
    corr_cuda.reset_launch_counts()
    runner = _track(sig)
    assert runner.device.type == "cuda" and runner._use_device_loop()
    assert _launched().get("pss_corr_bf16", 0) >= 1
    assert [c.n_id_cell for c in runner.cells] == [277]
    proc = runner.processors[277]
    assert proc._native is not None and proc.mib_fifo_synchronized
    assert runner.cells[0].health_pct() > 99.0
    assert abs(runner.state.frequency_offset - 300.0) < 50.0


def test_async_searcher_on_its_own_stream(cuda):
    sig = _tracker_stream()
    from lte_cell_scanner_tpu_torch.tracker import TrackerRunner
    runner = TrackerRunner(FC, FC, FS, search_async=True, search_period=5.0)
    try:
        for _ in range(10):
            for i in range(0, len(sig), 10000):
                runner.process_block(sig[i: i + 10000])
            if runner.cells:
                break
            if runner._search_future is not None:
                runner._search_future.result(timeout=300)
        assert runner._search_stream is not None
        assert [c.n_id_cell for c in runner.cells] == [277]
    finally:
        runner.close()


def test_kalibrate_on_the_card(cuda):
    from lte_cell_scanner_tpu_torch.io.capture import SimSource
    from lte_cell_scanner_tpu_torch.tracker.runner import kalibrate
    src = SimSource(freq_offset=31e3, coupled_fc=FC, seed=5)
    corr_cuda.reset_launch_counts()
    fo = kalibrate(lambda: src.capture(FC)[0], FC, FC, FS, max_tries=2)
    assert _launched().get("pss_corr_bf16", 0) >= 1
    assert abs(fo - 31e3) < 50.0


def test_cli_track_on_the_card(cuda, capsys):
    from lte_cell_scanner_tpu_torch import cli
    assert cli.main(["track", "-f", "739e6", "--sim", "--duration", "0.5",
                     "--no-tui", "-p", "10"]) == 0
    out = capsys.readouterr().out
    assert "  Cell 277  ports 2  CP N  nRB   6" in out
    assert "health 100.0%" in out


# ---------------------------------------------------------------------------
# check, live capture through a fake dongle (chip_smoke.FakeDongle), the
# band's debug exports
# ---------------------------------------------------------------------------

def _table(out):
    lines = out.splitlines()
    return lines[next(i for i, ln in enumerate(lines)
                      if ln.startswith("Detected the following")):]


def test_live_search_through_a_fake_dongle(cuda, monkeypatch, tmp_path,
                                           capsys):
    """One pss_corr_int8 launch (the dongle's u8 bytes), and the table of
    --load-files on the same bytes."""
    from chip_smoke import FakeDongle
    from lte_cell_scanner_tpu_torch import cli
    from lte_cell_scanner_tpu_torch.io import rtlsdr
    from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8
    raw = complex_to_iq_u8(adc_quantize(two_cell_capture()))
    path = tmp_path / "cap.u8"
    raw.tofile(path)
    argv = ["search", "-s", "739e6", "-p", "100"]
    monkeypatch.setattr(rtlsdr, "load_librtlsdr", lambda: FakeDongle(raw))
    corr_cuda.reset_launch_counts()
    assert cli.main(argv) == 0
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_int8": 1}
    live = capsys.readouterr().out
    assert cli.main(argv + ["--load-files", str(path)]) == 0
    assert _table(live) == _table(capsys.readouterr().out)
    assert [ln.split()[0] for ln in _table(live)[3:]] == ["277", "271"]


@pytest.mark.parametrize("cut", [0, 500], ids=["clean", "cut"])
def test_check_on_the_card_prints_the_cpu_lines(cuda, tmp_path, capsys,
                                                cut):
    """`check` correlates in complex64 on the card and on the CPU: the
    same lines, no kernel launched."""
    from lte_cell_scanner_tpu_torch import cli
    from lte_cell_scanner_tpu_torch.utils.itfile import write_itfile
    cap = two_cell_capture()
    at = int(0.030 * FS)
    cap = np.concatenate([cap[:at], cap[at + cut:]])
    path = str(tmp_path / "cap.it")
    write_itfile(path, {"capbuf": cap, "fc": np.array([739000000],
                                                      np.int32)})
    argv = ["check", path, "-f", "739e6", "--cell-id", "277", "--foff",
            "35e3"]
    corr_cuda.reset_launch_counts()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    assert _launched() == {}
    out = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == rc == (2 if cut else 0)
    assert out.splitlines() == capsys.readouterr().out.splitlines()


def test_band_debug_exports_from_the_device_peak_search(cuda, tmp_path):
    """With a dump active, the card's device peak search exports each
    carrier's maps, sp_incoherent, Z_th1 and peak lists under the names
    of the host route, in its order, with the CPU run's values."""
    from lte_cell_scanner_tpu_torch.utils import debug
    from lte_cell_scanner_tpu_torch.utils.itfile import read_itfile
    band = [(two_cell_capture(), FC, FC),
            (two_cell_capture(seed=1), FC + 1e5, FC + 1e5)]
    f_set = default_f_search_set(FC, 100.0)
    dumps = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / f"{dev}.it")
        debug.set_dump(debug.DebugDump(path))
        try:
            scan_band(band, f_set, FS, device=dev)
        finally:
            debug.set_dump(None)
        dumps[dev] = read_itfile(path)
    gpu, cpu = dumps["cuda"], dumps["cpu"]
    assert list(gpu) == list(cpu)
    for k in cpu:
        g, c = np.asarray(gpu[k]), np.asarray(cpu[k])
        assert g.shape == c.shape, k
        if k.startswith(("peak_ind", "peak_n_id_2")):
            np.testing.assert_array_equal(g, c, err_msg=k)
        elif k.startswith(("sp_incoherent", "Z_th1")):
            # float32 power sums on the card, float64 on the CPU
            np.testing.assert_allclose(g, c, rtol=1e-5, err_msg=k)
        elif k.startswith("xc_incoherent_collapsed_pow"):
            # bf16 map operands: within one bf16 step of the largest value
            assert np.abs(g - c).max() <= 2.0 ** -7 * np.abs(c).max(), k
    # the collapsed frequency index agrees at every exported peak
    for sfx in ("", "_1"):
        ind, nid = cpu["peak_ind" + sfx], cpu["peak_n_id_2" + sfx]
        np.testing.assert_array_equal(
            np.asarray(gpu["xc_incoherent_collapsed_frq" + sfx])[nid, ind],
            np.asarray(cpu["xc_incoherent_collapsed_frq" + sfx])[nid, ind])


@pytest.mark.parametrize("kernel", [False, True], ids=["exact", "kernel"])
def test_sharded_front_end_on_a_card_grid(cuda, kernel):
    """The (t x f) front end on a (4 x 2) grid that repeats the card,
    over 4 hypotheses (tests/test_sharded.py:28, about the capture's
    offset) on the full two-cell capture: the exact route (complex64)
    within 1e-5 x max of the float64 CPU grid; the kernel route
    (pss_corr_bf16 once per device) within 1e-5 x max of the one-device
    front end on the card, whose bf16 map it shares lag for lag.  Argmax
    on >= 99.9% of lags."""
    from lte_cell_scanner_tpu_torch.models.xcorr import xcorr_pss
    from lte_cell_scanner_tpu_torch.parallel.sharded import (
        make_mesh, plan_sharded_bands, plan_sharded_inputs, sharded_xcorr)
    cap = two_cell_capture()
    f_set = np.array([-5e3, 0.0, 5e3, 10e3]) + 35e3
    grid = make_mesh(4, 2, [cuda] * 8)
    inp = plan_sharded_inputs(cap, f_set, FC, FC, FS, grid,
                              dtype=np.complex128)
    bands = plan_sharded_bands(inp[1], grid) if kernel else ()
    corr_cuda.reset_launch_counts()
    pow_g, frq_g = (x.cpu().numpy() for x in sharded_xcorr(
        grid, inp[0], inp[1], inp[2], 2, inp[3], inp[4], 0, bands))
    torch.cuda.synchronize()
    assert _launched() == ({"pss_corr_bf16": 8} if kernel else {})
    if kernel:
        ref = xcorr_pss(cap, f_set, 2, FC, FC, FS, lean=True,
                        device="cuda")
        pow_r, frq_r = (ref.xc_incoherent_collapsed_pow,
                        ref.xc_incoherent_collapsed_frq)
    else:
        cpu = make_mesh(4, 2, ["cpu"] * 8)
        pow_r, frq_r = (x.numpy() for x in sharded_xcorr(
            cpu, inp[0], inp[1], inp[2], 2, inp[3], inp[4]))
    assert np.max(np.abs(pow_g - pow_r)) <= 1e-5 * np.max(pow_r)
    assert (frq_g == frq_r).mean() >= 0.999


def test_cell_search_over_a_card_grid_decodes_both_cells(cuda):
    """cell_search(mesh=(4 x 1) of the card) at full width (T = 93):
    one pss_corr_bf16 launch per time block, the one-device search's
    cells."""
    from lte_cell_scanner_tpu_torch.parallel.sharded import make_mesh
    cap = two_cell_capture()
    f_set = default_f_search_set(FC, 100.0)
    corr_cuda.reset_launch_counts()
    cells = cell_search(cap, f_set, FC, FC, FS,
                        mesh=make_mesh(4, 1, [cuda] * 4))
    torch.cuda.synchronize()
    assert _launched() == {"pss_corr_bf16": 4}
    one = cell_search(cap, f_set, FC, FC, FS, device=cuda)
    key = [(c.n_id_cell(), c.cp_type, c.n_rb_dl, c.n_ports, c.sfn)
           for c in cells]
    assert sorted(k[0] for k in key) == sorted(TWO_CELL_TRUTH)
    assert key == [(c.n_id_cell(), c.cp_type, c.n_rb_dl, c.n_ports, c.sfn)
                   for c in one]
