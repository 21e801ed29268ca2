"""The port's kernel benches (tools_torch/bench_corr_v2.py and
tools_torch/bench_kernels.py) and tracker benches
(tools_torch/bench_tracker.py, tools_torch/bench_tracker_device.py) run
end to end on the CPU at a tiny size: every requested variant reports
its time, parity holds its bars, the tracker holds its cells, and a bad
request or a missing card ends non-zero.  On the CPU the kernels'
plain versions run, so the times say nothing about any device."""

import json

import pytest
import torch

from tools_torch import (bench_corr_v2, bench_kernels, bench_tracker,
                         bench_tracker_device)

TINY = ["--device", "cpu", "--ppm", "5", "--samples", str(2 * 9600 + 400),
        "--repeats", "1"]
V2_VARIANTS = ["peak", "bw", "v1", "v2_128_16", "v2b_64_16", "v3_128_16",
               "v3b_128_8", "v2sum", "v2s_128_16", "v2s_128_5", "v2i_128"]


def _json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_bench_corr_v2_reports_every_variant(capsys):
    rc = bench_corr_v2.main(TINY + ["--skip-rulers",
                                    "--variants", ",".join(V2_VARIANTS)])
    res = _json_line(capsys)
    assert rc == 0
    assert res["device"] == "cpu" and res["n_templates"] == 9
    assert res["rulers_skipped"] == ["peak", "bw"]
    names = [bench_corr_v2.result_name(v) for v in V2_VARIANTS[2:]]
    assert names == ["v1_bf16", "v2_bf16_128_16", "v2b_bf16_64_16",
                     "v3_bf16_128_16", "v3b_bf16_128_8", "v2sum_bf16",
                     "v2s_bf16_128_16", "v2s_bf16_128_5",
                     "v2i_int8_128_16"]
    for name in names:
        assert res[f"{name}_ms"] > 0
        assert res[f"{name}_useful_tflops"] > 0


def test_bench_kernels_reports_every_variant(capsys):
    rc = bench_kernels.main(TINY)
    res = _json_line(capsys)
    assert rc == 0
    for v in bench_kernels.VARIANTS:
        assert res[f"{v}_ms"] > 0 and res[f"{v}_tflops"] > 0


def test_bench_kernels_parity_holds_its_bars(capsys):
    rc = bench_kernels.main(TINY + ["--parity-only"])
    res = _json_line(capsys)
    assert rc == 0
    assert set(res) == {"device", "v1_f32_maxerr", "v1_bf16_maxerr",
                        "v2_bf16_maxerr"}
    assert res["v1_f32_maxerr"] < 1e-5
    assert 0 < res["v1_bf16_maxerr"] < 2e-2


@pytest.mark.parametrize("tool,variant", [
    (bench_corr_v2, "v4_128_16"), (bench_corr_v2, "v2_128"),
    # sharded_1x1 is a variant now; a (2 x 2) grid is none
    pytest.param(bench_kernels, "sharded_2x2",
                 id="tools_torch.bench_kernels-sharded_1x1")])
def test_unknown_variant_raises(tool, variant):
    with pytest.raises(ValueError):
        tool.main(TINY + ["--variants", variant])


def test_bench_tracker_holds_two_cells(capsys):
    rc = bench_tracker.main(["--device", "cpu", "--cells", "2", "--runs",
                             "1", "--seconds", "0.3", "--json"])
    res = _json_line(capsys)
    assert rc == 0
    assert res["metric"] == "tracker_realtime_factor"
    assert res["device"] == "cpu" and res["cells"] == 2
    assert res["healthy"] and res["value"] > 0
    assert sorted(c["n_id_cell"] for c in res["tracked"]) == [271, 277]
    assert all(c["mib_synced"] for c in res["tracked"])
    assert abs(res["frequency_offset"] - 200.0) < 50.0
    assert {"producer", "control", "control.phase_c", "control.mib"} \
        <= set(res["split_ms_per_stream_s"])


def test_bench_tracker_device_reports_every_shape(capsys):
    rc = bench_tracker_device.main(["--device", "cpu", "--cells", "1,3",
                                    "--syms", "32,64", "--repeats", "1",
                                    "--json"])
    res = _json_line(capsys)
    assert rc == 0 and res["device"] == "cpu"
    assert [(r["cells"], r["syms"]) for r in res["rows"]] == \
        [(1, 32), (1, 64), (3, 32), (3, 64)]
    assert all(r["ms_per_call"] > 0 and r["realtime_factor"] > 0
               for r in res["rows"])


@pytest.mark.parametrize("tool", [bench_corr_v2, bench_kernels,
                                  bench_tracker, bench_tracker_device])
def test_no_card_exits_non_zero(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert capsys.readouterr().out.startswith("FAIL")
