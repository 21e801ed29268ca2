"""The port's (t x f) front end (lte_cell_scanner_tpu_torch/parallel/
sharded.py) against the TPU package's on the CPU.

The TPU package's ``sharded_xcorr`` runs on a (4 x 2) mesh of
tests/conftest.py's eight virtual CPU devices; the port's on a (4 x 2)
grid that repeats the one CPU device (the blocking, halo and fold
arithmetic is the same).  Both in complex128 on the same numpy inputs
(the cases of tests/test_sharded.py:24, :50, :78): the collapsed power at
atol 1e-12 with the argmax on >= 99.9% of lags, the aux outputs at 1e-12,
the f32 kernel operands' route against the exact one at 2e-5 x max, and
a capture length that 4 does not divide (the padding and the last
block's zero halo).
"""

import jax
import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.parallel import sharded as js
from lte_cell_scanner_tpu_torch.models.xcorr import xcorr_pss
from lte_cell_scanner_tpu_torch.parallel import sharded as ts

FS = 1.92e6
FC = 739e6
F_SET = np.array([-5e3, 0.0, 5e3, 10e3])
GRID = ts.make_mesh(4, 2, ["cpu"] * 8)


def _noise(seed, n_cap):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n_cap) + 1j * rng.normal(size=n_cap)) * 0.1


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs tests/conftest.py's 8 virtual devices")
    return js.make_mesh(4, 2)


def _both(capbuf, jmesh, n_comb_sp):
    j_in = js.plan_sharded_inputs(capbuf, F_SET, FC, FC, FS, jmesh,
                                  dtype=np.complex128)
    t_in = ts.plan_sharded_inputs(capbuf, F_SET, FC, FC, FS, GRID,
                                  dtype=np.complex128)
    want = js.sharded_xcorr(jmesh, j_in[0], j_in[1], j_in[2], 2, j_in[3],
                            j_in[4], n_comb_sp)
    got = ts.sharded_xcorr(GRID, t_in[0], t_in[1], t_in[2], 2, t_in[3],
                           t_in[4], n_comb_sp)
    return ([np.asarray(x) for x in want], [x.numpy() for x in got])


@pytest.mark.parametrize("n_cap", [40000, 40003], ids=["even", "ragged"])
def test_sharded_xcorr_matches_tpu_package(jmesh, n_cap):
    (pow_j, frq_j), (pow_t, frq_t) = _both(_noise(0, n_cap), jmesh, 0)
    assert pow_t.shape == (3, 9600) and frq_t.shape == (3, 9600)
    np.testing.assert_allclose(pow_t, pow_j, rtol=0, atol=1e-12)
    assert (frq_t == frq_j).mean() >= 0.999


@pytest.mark.parametrize("n_cap", [40000, 40003], ids=["even", "ragged"])
def test_sharded_aux_outputs_match_tpu_package(jmesh, n_cap):
    """sp_incoherent and xc_incoherent_single, against the TPU package's
    grid and against the port's own one-device front end."""
    capbuf = _noise(1, n_cap)
    ref = xcorr_pss(capbuf, F_SET, 2, FC, FC, FS, device="cpu")
    want, got = _both(capbuf, jmesh, ref.n_comb_sp)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert (got[1] == want[1]).mean() >= 0.999
    np.testing.assert_allclose(got[0], ref.xc_incoherent_collapsed_pow,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[2], ref.sp_incoherent, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got[3], ref.xc_incoherent_single, rtol=0,
                               atol=1e-12)


def test_f32_kernel_operands_route_matches_exact():
    """plan_sharded_bands(precision="f32"): each device's map through
    corr_pow_f32 (its plain version on the CPU) within 2e-5 x max of the
    exact route, argmax on >= 99.9% of lags (tests/test_sharded.py:78)."""
    capbuf = _noise(2, 20000).astype(np.complex64)
    inp = ts.plan_sharded_inputs(capbuf, F_SET, FC, FC, FS, GRID,
                                 dtype=np.complex64)
    pow_x, frq_x = ts.sharded_xcorr(GRID, inp[0], inp[1], inp[2], 2, inp[3],
                                    inp[4])
    bands = ts.plan_sharded_bands(inp[1], GRID, precision="f32")
    assert bands[0][0].taps.shape == (2, 6, 137)
    assert bands[0][1] is bands[3][1]           # one set per column
    pow_p, frq_p = ts.sharded_xcorr(GRID, inp[0], inp[1], inp[2], 2, inp[3],
                                    inp[4], 0, bands)
    scale = float(pow_x.max())
    assert float((pow_p - pow_x).abs().max()) <= 2e-5 * scale
    assert (frq_p == frq_x).double().mean() >= 0.999


@pytest.mark.parametrize("n_t,n_f", [(4, 2), (8, 1), (2, 4)])
def test_plan_sharded_inputs_equal_tpu_package(n_t, n_f):
    if len(jax.devices()) < n_t * n_f:
        pytest.skip("needs tests/conftest.py's 8 virtual devices")
    capbuf = _noise(3, 30001)
    want = js.plan_sharded_inputs(capbuf, F_SET, FC, 739.1e6, FS,
                                  js.make_mesh(n_t, n_f),
                                  dtype=np.complex128)
    got = ts.plan_sharded_inputs(capbuf, F_SET, FC, 739.1e6, FS,
                                 ts.make_mesh(n_t, n_f, ["cpu"] * (n_t * n_f)),
                                 dtype=np.complex128)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]


def test_make_mesh_layout_and_errors():
    grid = ts.make_mesh(2, 3, ["cpu", "meta", "cpu", "cpu", "cpu", "cpu",
                               "cpu"])
    assert grid.shape == {"t": 2, "f": 3}
    assert grid.devices[0][1] == torch.device("meta")
    assert grid.first == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 8 devices"):
        ts.make_mesh(4, 2, ["cpu"] * 7)
    if not torch.cuda.is_available():
        # no card visible: a grid of visible cards cannot be made
        with pytest.raises(ValueError, match="0 given or visible"):
            ts.make_mesh(1, 1)
    with pytest.raises(ValueError, match="do not divide"):
        ts.plan_sharded_inputs(_noise(4, 20000), np.zeros(3), FC, FC, FS,
                               GRID)
