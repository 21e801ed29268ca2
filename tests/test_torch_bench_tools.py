"""The port's kernel benches (tools_torch/bench_corr_v2.py and
tools_torch/bench_kernels.py) run end to end on the CPU at a tiny size:
every requested variant reports its time, parity holds its bars, and a
bad request or a missing card ends non-zero.  On the CPU the kernels'
plain versions run, so the times say nothing about any device."""

import json

import pytest
import torch

from tools_torch import bench_corr_v2, bench_kernels

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


@pytest.mark.parametrize("tool,variant", [(bench_corr_v2, "v4_128_16"),
                                          (bench_corr_v2, "v2_128"),
                                          (bench_kernels, "sharded_1x1")])
def test_unknown_variant_raises(tool, variant):
    with pytest.raises(ValueError):
        tool.main(TINY + ["--variants", variant])


@pytest.mark.parametrize("tool", [bench_corr_v2, bench_kernels])
def test_no_card_exits_non_zero(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert capsys.readouterr().out.startswith("FAIL")
