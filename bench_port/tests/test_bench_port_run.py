"""Whole runs of the harness at a small size: on the CPU the tracker on
a short loop, as it is and with its timed path broken underneath after
the warm-up; on the card the control and the fault at the cell's own
size.

The CPU runs skip the look for a card and drive the rest of a run: the
program as it is comes out correct; the control (the tick computed in
complex64) and each fault the cell can have come out not correct: a
step that returns its state unchanged, half of each tick's cells left
out, a tick's answer altered where it is produced, every MIB re-decode
skipped.

    python -m pytest bench_port/tests -q
"""

from __future__ import annotations

import copy
import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import control, run  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
SMALL = dict(run.load_json(ROOT / "bench_port/configs/tracker_4x2.json"))
SMALL["stream"] = dict(SMALL["stream"], loop_ms=1280)
DATA = {"configs/small": SMALL,
        "traffic/small": {"driver": "track", "block": 10000, "acq_s": 5.0,
                          "settle_s": 0.5, "profile_s": 0.0}}


def _small_bench():
    """BENCHMARK.json with one cell on the short loop that reports
    realtime_factor and the metrics that move it."""
    b = copy.deepcopy(BENCH)
    b["workloads"] = [{"name": "track-small", "config": "small",
                       "traffic": "small", "chips": 1, "why": "test"}]
    for m in b["end_to_end"] + b["per_layer"]:
        m.pop("workloads", None)
    return b


def _run(patch=None, trace=0, seed=2 ** 33 + 11):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "track-small", "--seed", str(seed),
                       "--seconds", "1.0", "--trace", str(trace)],
                      device="cpu", check_card=False, patch=patch,
                      bench=_small_bench(), data=DATA)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_tracker_correct_and_traced():
    res = _run(trace=1)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    checks = res["checks"]
    assert checks["mismatches"] == {"value": 0, "limit": 0}
    assert checks["tick_gap"]["value"] < 1e-12
    assert checks["mib_gap"]["value"] <= 1
    # the CPU has no device trace: only the span readers report
    assert "track.control_ms_per_s" in res["metrics"]
    assert "track.device_idle_pct" not in res["metrics"]


def test_no_search_in_the_window(monkeypatch):
    """The configuration keeps the searcher out of the window: acquisition
    searches, the window runs none."""
    from lte_cell_scanner_tpu_torch.tracker import runner
    calls = []

    def patch(drv):
        assert drv.runner.search_period == float("inf")
        assert drv.runner.producer.capture_idle()
        orig = runner.search_once
        monkeypatch.setattr(runner, "search_once",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
    res = _run(patch=patch)
    assert res["correct"] is True and calls == []


def _frozen(drv):
    drv.runner.process_block = lambda block: None


def _undo_after(monkeypatch, module, name, make):
    """A patch that puts ``make(original)`` in the module's place for the
    run (monkeypatch restores it)."""
    def patch(drv):
        monkeypatch.setattr(module, name, make(getattr(module, name)))
    return patch


def _half_left_out(orig):
    def tick(cell_pdus, *a, **k):
        return orig(list(cell_pdus)[::2], *a, **k)
    return tick


def _altered(orig):
    def program(*args):
        out = orig(*args)
        out[0] = out[0] * (1 + 1e-6) + 1e-6
        return out
    return program


def _fault(name, monkeypatch):
    from lte_cell_scanner_tpu_torch.tracker import cell_tracker, device_loop
    if name == "state_unchanged":
        return _frozen
    if name == "half_left_out":
        return _undo_after(monkeypatch, device_loop, "batched_tick_extract",
                           _half_left_out)
    if name == "answer_altered":
        return _undo_after(monkeypatch, device_loop, "_tick_program",
                           _altered)
    if name == "mib_skipped":
        return _undo_after(monkeypatch, cell_tracker.TrackedCellProcessor,
                           "_mib_try_decode", lambda orig: lambda self: True)
    return _undo_after(monkeypatch, device_loop, "_tick_program",
                       control.complex64_tick)


@pytest.mark.parametrize("name", ["state_unchanged", "half_left_out",
                                  "answer_altered", "mib_skipped",
                                  "control_complex64"])
def test_broken_window_is_not_correct(name, monkeypatch):
    res = _run(patch=_fault(name, monkeypatch))
    assert res["correct"] is False


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_at_cell_size_is_not_correct(cuda, workload):
    """The program, its control and the fault on the card at the cell's
    own size, one short window each: bench_port/control.py runs them on
    more seeds."""
    lines = {x["run"]: x for x in control.readings(workload, 123456789, 3.0)}
    assert lines["program"]["correct"] is True
    assert lines["control_complex64"]["correct"] is False
    assert lines["fault_mib_skipped"]["correct"] is False
