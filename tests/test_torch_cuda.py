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
from lte_cell_scanner_tpu_torch.models.xcorr import pss_templates
from lte_cell_scanner_tpu_torch.ops import corr_cuda
from lte_cell_scanner_tpu_torch.sim.scenarios import (TWO_CELL_TRUTH,
                                                      adc_quantize,
                                                      two_cell_capture)

FS = 1.92e6
FC = 739e6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(precision, n_f, n_cap, seed, device):
    rng = np.random.default_rng(seed)
    tmpl = pss_templates(np.arange(n_f) * 5e3, FC, FC, FS).reshape(-1, 137)
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


# ragged lag tiles and template chunks: n_lags not a multiple of the
# 256-lag tile, T not a multiple of the 16-template chunk
@pytest.mark.parametrize("n_f,n_cap", [(1, 137 + 5), (3, 9600 + 401),
                                       (7, 2 * 9600 + 777)])
def test_bf16_kernel_matches_its_plain_version(cuda, n_f, n_cap):
    cap, taps = _operands("bf16", n_f, n_cap, 1 + n_f, cuda)
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


@pytest.mark.parametrize("n_f,n_cap", [(1, 137 + 5), (3, 9600 + 401),
                                       (7, 2 * 9600 + 777)])
def test_int8_kernel_is_bit_equal_to_its_plain_version(cuda, n_f, n_cap):
    cap, taps = _operands("int8", n_f, n_cap, 2 + n_f, cuda)
    n_lags = n_cap - 136
    got = corr_cuda.corr_pow_int8(cap, taps, n_lags)
    ref = corr_cuda.corr_pow_int8_plain(cap, taps, n_lags)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


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
