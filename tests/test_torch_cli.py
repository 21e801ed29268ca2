"""The port's ``cli.py search`` against the TPU package's CLI on the CPU,
and ``bench_torch.py`` with ``--device cpu``.

A recorded capture -- the two-cell capture at +1 kHz, inside the +-5 kHz
grid of ``-p 5`` -- as a raw rtl_sdr u8 file (on the 8-bit grid, with a
few saturated 255 bytes) and as an .it file goes through both CLIs: the
printed cell tables must be equal, line for line.  Record then replay
must print the same table; the argument checks print the TPU CLI's
messages in its order.
"""

import json

import numpy as np
import pytest

from lte_cell_scanner_tpu import cli as jcli
from lte_cell_scanner_tpu_torch import cli
from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                      two_cell_capture)
from lte_cell_scanner_tpu_torch.utils import debug as tdebug
from lte_cell_scanner_tpu_torch.utils.itfile import write_itfile
from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8

import bench_torch


def _table(out: str):
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(("Detected the following cells:",
                                   "No LTE cells were found")))
    return lines[start:]


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture(scope="module")
def capture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("captures")
    cap = two_cell_capture(f_off=1e3)
    raw = complex_to_iq_u8(adc_quantize(cap))
    raw[1::50001] = 255                      # saturated Q samples
    u8 = d / "cap.u8"
    raw.tofile(u8)
    it = d / "cap.it"
    write_itfile(str(it), {"capbuf": cap,
                           "fc": np.array([739000000], np.int32)})
    return {"u8": str(u8), "it": str(it)}


@pytest.mark.parametrize("kind", ["u8", "it"])
def test_file_search_prints_the_tpu_cli_table(capture_files, kind, capsys):
    argv = ["search", "-s", "739e6", "-p", "5", "--load-files",
            capture_files[kind]]
    rc, out, _ = _run(cli.main, argv + ["--device", "cpu"], capsys)
    jrc, jout, _ = _run(jcli.main, ["--platform", "cpu"] + argv, capsys)
    assert rc == jrc == 0
    table = _table(out)
    assert table == _table(jout)
    assert [ln.split()[0] for ln in table[3:]] == ["277", "271"]


def test_record_then_load_replays_the_table(tmp_path, capsys):
    base = ["search", "-s", "739e6", "-p", "5", "-d", str(tmp_path)]
    rc, rec, _ = _run(cli.main, base + ["--sim", "--sim-foff", "1200", "-r",
                                        "--device", "cpu"], capsys)
    assert rc == 0
    assert [p.name for p in tmp_path.iterdir()] == ["capbuf_0000.it"]
    rc, rep, _ = _run(cli.main, base + ["-l", "--device", "cpu"], capsys)
    assert rc == 0
    jrc, jrep, _ = _run(jcli.main, ["--platform", "cpu"] + base + ["-l"],
                        capsys)
    assert jrc == 0
    assert _table(rec) == _table(rep) == _table(jrep)
    assert _table(rec)[3].startswith("277 2 ")


def test_band_from_files_is_the_same_serial_and_batched(capture_files,
                                                        capsys):
    """Two carriers from two files: the serial loop and one batched
    scan_band print the same table (the same cells, deduplicated)."""
    argv = ["search", "-s", "739e6", "-e", "739.1e6", "-p", "5",
            "--device", "cpu", "--load-files", capture_files["u8"],
            capture_files["it"]]
    rc, serial, _ = _run(cli.main, argv, capsys)
    rc2, batched, _ = _run(cli.main, argv + ["--shard-carriers"], capsys)
    assert rc == rc2 == 0
    assert "Examining center frequency 739.1 MHz" in serial
    assert "Scanning 2 carriers" in batched
    assert _table(serial) == _table(batched)
    assert len(_table(serial)) == 5


ERRORS = [
    (["-s", "500e3", "--sim"], "start frequency must be greater"),
    (["-s", "739e6", "-e", "738e6", "--sim"], "end frequency must be >="),
    (["-s", "739e6", "--sim", "-p", "-5"], "ppm value must be positive"),
    (["-s", "739.05e6", "-c", "1.01", "-r", "-l"], "cannot both record"),
    (["-s", "739e6", "-r", "--load-files", "x.u8"], "cannot both record"),
    (["-s", "739e6", "--sim", "--capture-ms", "40"], "--capture-ms must"),
]


@pytest.mark.parametrize("argv,message", ERRORS,
                         ids=[m.split()[0] for _, m in ERRORS])
def test_argument_checks_match_the_tpu_cli(argv, message, capsys):
    rc, out, _ = _run(cli.main, ["search"] + argv, capsys)
    jrc, jout, _ = _run(jcli.main, ["search"] + argv, capsys)
    assert rc == jrc == 1
    assert out == jout
    assert f"Error: {message}" in out


def test_sim_cell_and_missing_captures_are_errors(tmp_path, capsys):
    with pytest.raises(SystemExit, match="--sim-cell must be in 0..503"):
        cli.main(["search", "-s", "739e6", "--sim", "--sim-cell", "504"])
    for argv in (["--load-files", str(tmp_path / "none.u8")],
                 ["-l", "-d", str(tmp_path)]):
        rc, _out, err = _run(cli.main, ["search", "-s", "739e6"] + argv,
                             capsys)
        assert rc == 1 and err.startswith("Error: file not found: ")
    # no source named: a live dongle, which this machine lacks; the same
    # Error: as the TPU CLI's, never a fallback to another source
    with pytest.raises(SystemExit) as got:
        cli.main(["search", "-s", "739e6", "--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jcli.main(["--platform", "cpu", "search", "-s", "739e6"])
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("Error: ")


def test_profile_brief_and_backend_names(capsys):
    """-b silences the progress lines, --profile prints the stage table
    (the stages cell_search records on the CPU), and the TPU package's
    backend names map onto the port's."""
    argv = ["search", "-s", "739e6", "--sim", "--device", "cpu", "-p", "5",
            "--sim-foff", "1200"]
    try:
        rc, out, _ = _run(cli.main, argv + ["-b", "--profile",
                                            "--corr-backend", "xla"], capsys)
    finally:
        tdebug.enable_profiling(False)
    assert rc == 0
    assert "Examining" not in out and "Detected a cell!" not in out
    stages = {ln.split()[0] for ln in out.splitlines()[-5:]}
    assert {"xcorr_pss", "peak_search", "sss_foe_fused",
            "decode_fused"} <= stages
    rc, plain, _ = _run(cli.main, argv, capsys)
    assert rc == 0 and "Examining center frequency 739 MHz" in plain
    assert _table(plain) == _table(out.split("\n\nstage")[0])


def test_bench_torch_on_the_cpu_prints_its_keys(capture_files, capsys):
    """At +-5 kHz on the +1 kHz capture file: the keys of bench.py's line
    and a valid full chain."""
    assert bench_torch.main(["--device", "cpu", "--carriers", "2", "--ppm",
                             "5", "--rounds", "1", "--iters", "1",
                             "--runs", "1", "--capture",
                             capture_files["it"]]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metric"] == "pss_scan_samples_per_sec"
    for k in ("value", "value_min", "value_max", "n_rounds", "useful_tflops",
              "share_of_datasheet_peak", "route", "full_chain"):
        assert k in res
    assert res["value"] > 0 and res["route"] == "exact"
    fc = res["full_chain"]
    for k in ("s_per_carrier", "s_per_carrier_min", "s_per_carrier_max",
              "n_runs", "cell_ids", "valid", "bytes_uploaded", "stages_ms"):
        assert k in fc
    assert fc["valid"] and fc["cell_ids"] == [271, 277]
    assert set(fc["stages_ms"]) == {"xcorr_pss", "peak_search",
                                    "sss_foe_fused", "decode_fused"}
