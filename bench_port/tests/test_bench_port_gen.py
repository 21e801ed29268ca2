"""The frozen generator and the frozen arithmetic: the same seed gives
the same stream and truth, the vectorised generator equals the port's
simulator where neither draws at random, the tracker's loop joins
without a seam, the reference's rule for which 40 ms period a MIB
re-decode read, and the idle arithmetic worked by hand.

    python -m pytest bench_port/tests -q
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import gen, reference  # noqa: E402
from bench_port.frozen import channel, trace  # noqa: E402
from bench_port.frozen.dl_sig import create_dl_sig  # noqa: E402

TRACK = json.loads((ROOT / "bench_port/configs/tracker_4x2.json")
                   .read_text())
SHORT = dict(TRACK, stream=dict(TRACK["stream"], loop_ms=1280,
                                chunk_ms=320))


def test_same_seed_same_stream_and_truth():
    seed = 2 ** 33 + 7
    a = gen.tracker_loop(seed, SHORT)
    b = gen.tracker_loop(seed, SHORT, workers=1)
    c = gen.tracker_loop(seed + 1, SHORT)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.dtype == np.complex64 and len(a) == 1280 * 1920
    # on the dongle's grid: whole codes over 128
    for plane in (a.real, a.imag):
        k = plane.astype(np.float64) * 128
        assert np.array_equal(k, np.round(k)) and np.abs(k).max() <= 128
    assert gen.tracker_cells(SHORT) == gen.tracker_cells(SHORT)


@pytest.mark.parametrize("normal_cp", [True, False])
@pytest.mark.parametrize("ports", [1, 2, 4])
def test_frozen_generator_equals_the_simulator(normal_cp, ports):
    """With no random filler both build the same samples."""
    from lte_cell_scanner_tpu_torch.cell import CpType
    from lte_cell_scanner_tpu_torch.sim.dl_sig import create_dl_sig as port
    cp = CpType.NORMAL if normal_cp else CpType.EXTENDED
    want = port(cp, 25, 3, 92, 1, 0.0, rng=np.random.default_rng(0),
                n_ports=ports, sfn=1021)
    got = create_dl_sig(normal_cp, 25, 3, 92, 1, 0.0,
                        np.random.default_rng(0), ports, 1021)
    assert np.array_equal(want, got)


def test_tracker_loop_joins_without_a_seam():
    """The loop's last chunk runs on into its first: each cell's signal
    generated across the seam in one piece equals the two chunks, and
    the mixer's phase at the loop's length is whole cycles."""
    s = TRACK["stream"]
    chunk, n_loop = s["chunk_ms"], s["loop_ms"] // s["chunk_ms"]
    n = int(chunk * gen.FS / 1000)
    for n1, slot, sfn0 in s["cell_plan"][: s["n_cells"]]:
        last = (sfn0 + (n_loop - 1) * chunk // 10) % 1024
        both = create_dl_sig(True, 2 * chunk, slot, n1, s["n_id_2"], 0.0,
                             np.random.default_rng(0), s["n_ports"], last,
                             s["n_rb_dl"])
        first = create_dl_sig(True, chunk, slot, n1, s["n_id_2"], 0.0,
                              np.random.default_rng(0), s["n_ports"], sfn0,
                              s["n_rb_dl"])
        assert np.allclose(both[n:], first, atol=1e-12)
    n_total = int(s["loop_ms"] * gen.FS / 1000)
    cycles = s["f_off_hz"] * n_total / gen.FS
    assert cycles == round(cycles)
    x = channel.apply_freq_offset(np.ones(1), s["f_off_hz"], n_total)
    assert abs(x[0] - 1.0) < 1e-9
    # the truth: frame boundaries of the plan's slot starts
    assert [t.frame0 for t in gen.tracker_cells(TRACK)] == [
        0, 13 * 960, 7 * 960, 15 * 960]


def test_reference_mib_period_rule():
    """A re-decode reads the 40 ms period whose last frame (SFN % 4 ==
    3) ended its PBCH at or before the stream position, less than two
    frames before it; the SFN counts on through the loop and starts
    again at its seam."""
    t = gen.tracker_cells(TRACK)[0]        # frame0 0, sfn0 from the plan
    last = (3 - t.sfn0) % 4                   # first frame with SFN % 4 == 3
    end = last * reference.FRAME_LEN + reference.PBCH_END
    assert reference.mib_frame(t, end) == last
    assert reference.mib_frame(t, end + 2 * 19200 - 1) == last
    assert reference.mib_frame(t, end - 1) is None
    assert reference.mib_frame(t, end + 2 * 19200) is None
    assert t.sfn(last) % 4 == 3 and t.sfn(last + 1024) == t.sfn(last)
    s = gen.tracker_cells(SHORT)[0]
    assert s.sfn(128) == s.sfn0 and s.sfn(127) == (s.sfn0 + 127) % 1024


def test_idle_arithmetic_by_hand():
    dev = [(0.0, 2.0, "a"), (1.0, 3.0, "b"), (5.0, 6.0, "a")]
    assert trace.union(dev) == [(0.0, 3.0), (5.0, 6.0)]
    assert trace.busy_us(dev, 0.0, 10.0) == 4.0
    assert trace.gaps(dev, 0.0, 10.0) == [(6.0, 10.0), (3.0, 5.0)]
    assert trace.by_name(dev) == {"a": (2, 3.0), "b": (1, 2.0)}
    host = [(0.0, 10.0, "outer"), (2.5, 5.5, "inner")]
    assert trace.host_label(host, 4.0) == "inner"
    assert trace.host_label(host, 11.0) == "python"
