"""The port's analysis and bench tools (tools_torch/monte_carlo.py,
pss_foff.py, segment_doppler_study.py, bench_search.py,
bench_carriers.py, bench_front_stages.py) on the CPU.

The Monte-Carlo harness draws the TPU tool's trials from the same seed
and classifies them alike through the exact (complex128) routes of both
packages: the same outcome, cell and detected cell per trial, the frame
timing error within 1e-9 samples and the fine-frequency error within
1e-6 Hz.  The two host studies print the TPU tools' lines.  The benches
run end to end at a tiny size (on the CPU the kernels' plain versions
run, so their times say nothing about any device), and exit non-zero
without a card.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from tools_torch import (bench_carriers, bench_front_stages, bench_search,
                         monte_carlo, pss_foff, segment_doppler_study)

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


@pytest.fixture(scope="module")
def jtools():
    """The TPU package's tool modules (tools/ is not a package)."""
    sys.path.insert(0, str(TOOLS))
    try:
        import monte_carlo as jmc
        import segment_doppler_study as jsd
        yield {"monte_carlo": jmc, "segment_doppler_study": jsd}
    finally:
        sys.path.remove(str(TOOLS))


# (trials, snr_db, fading, seed, decode): every outcome class the TPU
# tool's own tests reach
MC_CASES = [(3, 0.0, False, 10, False), (2, -5.0, True, 11, False),
            (3, -30.0, False, 12, False), (2, 5.0, False, 13, True),
            (2, -10.0, False, 14, False)]


@pytest.mark.parametrize("trials,snr,fading,seed,decode", MC_CASES,
                         ids=[f"seed{c[3]}" for c in MC_CASES])
def test_monte_carlo_matches_the_tpu_tool(jtools, trials, snr, fading,
                                          seed, decode):
    jmc = jtools["monte_carlo"]
    got = []
    out = monte_carlo.run_config(trials, snr, fading, seed, decode=decode,
                                 corr_backend="xla", device="cpu",
                                 results=got)
    rng = np.random.default_rng(seed)
    want = [jmc.run_trial(rng, snr, fading, decode=decode,
                          corr_backend="xla") for _ in range(trials)]
    for g, w in zip(got, want):
        assert (g.outcome, g.n_id_cell, g.detected_id) == \
            (w.outcome, w.n_id_cell, w.detected_id)
        for a, b, tol in ((g.timing_err, w.timing_err, 1e-9),
                          (g.freq_err, w.freq_err, 1e-6)):
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol
    for k in ("success", "thresh1_fail", "thresh2_fail", "false_alarm"):
        assert out[k] == sum(w.outcome == k for w in want) / trials
    assert out["corr_backend"] == "xla" and out["trials"] == trials
    if snr == -30.0:
        assert out["thresh1_fail"] == 1.0
    if seed == 10:
        assert out["success"] == 1.0


def test_noise_only_calibration_matches_the_tpu_tool(jtools):
    """The false-alarm tail calibration on the same noise draws: the
    same rounded statistics, exceedance curve and tail fit."""
    got = monte_carlo.noise_only_config(2, 5, "xla", device="cpu")
    want = jtools["monte_carlo"].noise_only_config(2, 5, "xla")
    assert got == want
    assert abs(got["t_mean"] - got["dof"]) < 1.5
    assert got["false_alarms_at_design_threshold"] == 0


def test_monte_carlo_cli_on_the_cpu(capsys):
    assert monte_carlo.main(["--device", "cpu", "--trials", "1", "--snr",
                             "-30", "--seed", "12", "--corr-backend",
                             "exact"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["thresh1_fail"] == 1.0 and res["trials"] == 1


def test_pss_foff_prints_the_tpu_tool_lines(capsys):
    from lte_cell_scanner_tpu.constants import FS_LTE
    from lte_cell_scanner_tpu.models.pss import PSS_TD
    argv = ["--max-off", "15e3", "--step", "2500", "--n-id-2", "1"]
    assert pss_foff.main(argv) == 0
    got = capsys.readouterr().out
    sys.path.insert(0, str(TOOLS))
    try:
        import pss_foff as jpf
        assert jpf.main(argv + ["--platform", "default"]) == 0
    finally:
        sys.path.remove(str(TOOLS))
    assert got == capsys.readouterr().out
    # unrounded: the TPU package's PSS at the same offsets
    offs = np.arange(0.0, 15e3 + 1, 2500.0)
    pss = PSS_TD()[1]
    fs = FS_LTE / 16
    want = [10 * np.log10(np.abs(np.vdot(pss, pss * np.exp(
        2j * np.pi * f * np.arange(137) / fs))) ** 2
        / np.abs(np.vdot(pss, pss)) ** 2) for f in offs]
    np.testing.assert_allclose(pss_foff.corr_loss_db(offs, 1), want,
                               rtol=0, atol=1e-9)


def test_coherence_ratio_matches_the_tpu_study(jtools, capsys):
    jsd = jtools["segment_doppler_study"]
    from lte_cell_scanner_tpu.models.pss import PSS_TD
    p0 = np.asarray(PSS_TD()[0], np.complex128)
    for f in (0.0, 1234.5, 36950.0, 73900.0):
        for L in (5, 17, 46, 137):
            assert abs(segment_doppler_study.coherence_ratio(
                p0, f, 1.92e6, L) - jsd.coherence_ratio(
                p0, f, 1.92e6, L)) <= 1e-9
    assert segment_doppler_study.main(["--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["study"] == "segment_doppler" and len(res["rows"]) == 10


def _json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_bench_search_on_the_cpu(capsys):
    """+-50 ppm holds the two-cell capture's +35 kHz offset."""
    assert bench_search.main(["--device", "cpu", "--ppm", "50",
                              "--repeats", "1", "--json"]) == 0
    res = _json_line(capsys)
    assert res["device"] == "cpu" and res["n_hyp"] == 15
    assert res["cell_ids"] == [271, 277]
    assert res["n_cells_serial"] == res["n_cells_batched"] == 2
    assert {"xcorr_pss", "peak_search", "sss_foe_fused",
            "decode_fused"} <= set(res["cell_search_stages_s"])
    assert res["front_end_s"] > 0 and res["total_s"] > 0


@pytest.mark.parametrize("adc", [False, True], ids=["float", "adc"])
def test_bench_carriers_front_end_on_the_cpu(adc, capsys):
    argv = ["--device", "cpu", "--ppm", "5", "--repeats", "1",
            "--batches", "1,2", "--json"] + (["--adc-grid"] if adc else [])
    assert bench_carriers.main(argv) == 0
    res = _json_line(capsys)
    assert res["mode"] == "front_end" and res["adc_grid"] == adc
    assert [r["carriers"] for r in res["rows"]] == [1, 2]
    assert all(r["route"] == "exact" and r["carriers_per_s"] > 0
               for r in res["rows"])
    assert res["best_carriers_per_s"] == max(r["carriers_per_s"]
                                             for r in res["rows"])


def test_bench_carriers_full_chain_on_the_cpu(capsys):
    assert bench_carriers.main(["--device", "cpu", "--ppm", "50",
                                "--repeats", "1", "--batches", "2",
                                "--full-chain", "--json"]) == 0
    res = _json_line(capsys)
    (row,) = res["rows"]
    assert res["mode"] == "full_chain" and row["carriers"] == 2
    assert row["cell_ids"] == [271, 277] and row["carriers_per_s"] > 0


@pytest.mark.parametrize("adc", [False, True], ids=["bf16", "int8"])
def test_bench_front_stages_on_the_cpu(adc, capsys):
    argv = ["--device", "cpu", "--ppm", "5", "--repeats", "1", "--inner",
            "1", "--samples", str(2 * 9600 + 400), "--json"] \
        + (["--adc-grid"] if adc else [])
    assert bench_front_stages.main(argv) == 0
    res = _json_line(capsys)
    assert res["kernel"] == ("pss_corr_int8" if adc else "pss_corr_bf16")
    for s in bench_front_stages.STAGES:
        assert res[f"{s}_ms"] > 0 and res[f"{s}_issue_ms"] > 0
    with pytest.raises(ValueError):
        bench_front_stages.main(argv + ["--stages", "gslab"])


@pytest.mark.parametrize("tool", [bench_search, bench_carriers,
                                  bench_front_stages, monte_carlo])
def test_no_card_exits_non_zero(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert capsys.readouterr().out.startswith("FAIL")
