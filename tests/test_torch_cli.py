"""The port's ``cli.py search`` against the TPU package's CLI on the CPU,
and ``bench_torch.py`` with ``--device cpu``.

A recorded capture -- the two-cell capture at +1 kHz, inside the +-5 kHz
grid of ``-p 5`` -- as a raw rtl_sdr u8 file (on the 8-bit grid, with a
few saturated 255 bytes) and as an .it file goes through both CLIs: the
printed cell tables must be equal, line for line.  Record then replay
must print the same table; the argument checks print the TPU CLI's
messages in its order.  ``track --profile`` prints the tracker's
spans as a nested table.
"""

import json
import re

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


def test_track_profile_nests_the_tracker_spans(capsys):
    """``track --profile`` prints the span table when the tracker stops:
    each span under the one that enclosed it (the CPU's dense tick:
    control.phase_c in control, control.mib in control.phase_c, the
    searcher's stages in search), shares of the top-level spans' sum;
    then the tick program's counts."""
    argv = ["track", "-f", "739e6", "--sim", "--duration", "0.3",
            "--no-tui", "--no-kalibrate", "--no-warmup", "--device", "cpu",
            "-b", "--profile"]
    try:
        rc, out, _ = _run(cli.main, argv, capsys)
    finally:
        tdebug.enable_profiling(False)
    assert rc == 0
    table, counts = out.split("\n\nstage")[1].split("\n\n")
    assert re.fullmatch(r"tick program: captures \d+, replays \d+, "
                        r"eager \d+, evictions \d+, wire_f16 \d+, "
                        r"wire_f64 \d+, arenas \d+\n", counts)
    table = table.splitlines()[1:]
    rows = {ln.split()[0]: ln for ln in table}
    depth = {k: (len(ln) - len(ln.lstrip())) // 2 for k, ln in rows.items()}
    assert {"producer": 0, "pop": 0, "fd": 0, "control": 0, "search": 0,
            "control.phase_c": 1, "control.mib": 2,
            "xcorr_pss": 1}.items() <= depth.items()
    assert table.index(rows["control.mib"]) \
        == table.index(rows["control.phase_c"]) + 1
    share = sum(float(ln.split()[-1].rstrip("%"))
                for ln in table if not ln.startswith(" "))
    assert abs(share - 100.0) < 0.1 * len(table)


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


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_band_prints_the_one_process_table(tmp_path, capsys):
    """A two-carrier band recorded by one process, then replayed by two
    ranks over gloo (``--coordinator``, each loading the capbuf_XXXX.it
    files of its band indices): rank 0 prints the one-process table,
    rank 1 no table."""
    import os
    import subprocess
    import sys

    band = ["search", "-s", "739e6", "-e", "739.1e6", "-p", "5", "-d",
            str(tmp_path), "--device", "cpu"]
    rc, rec, _ = _run(cli.main, band + ["--sim", "--sim-foff", "1200", "-r"],
                      capsys)
    assert rc == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["capbuf_0000.it", "capbuf_0001.it"]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lte_cell_scanner_tpu_torch.cli"] + band
        + ["-l", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
           "2", "--process-id", str(pid)],
        env=dict(os.environ, OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert _table(outs[0]) == _table(rec)
    assert _table(rec)[3].startswith("277 2 ")
    assert "[proc 1] capturing 739.1 MHz (band index 1)" in outs[1]
    assert "Detected the following cells" not in outs[1]


def test_fewer_carriers_than_processes_exits_before_joining(capsys):
    """Checked on the band alone before joining the group (nothing
    listens at the coordinator's port), with the TPU CLI's message."""
    argv = ["search", "-s", "739e6", "--sim", "--coordinator",
            "127.0.0.1:1", "--num-processes", "2", "--process-id", "1"]
    rc, out, _ = _run(cli.main, argv + ["--device", "cpu"], capsys)
    jrc, jout, _ = _run(jcli.main, ["--platform", "cpu"] + argv, capsys)
    assert rc == jrc == 1
    assert out == jout == ("Error: band has fewer carriers (1) than "
                           "processes (2); some process would own none\n")


WARN = ("Warning: {} requested but only one device is visible; running "
        "single-device")
SEARCH = ["search", "-s", "739e6", "--sim", "-p", "5", "--sim-foff", "1200"]
TRACK = ["track", "-f", "739e6", "--sim", "--no-kalibrate", "--no-warmup",
         "--duration", "0.01", "--no-tui"]


@pytest.mark.parametrize("argv,flag", [(SEARCH, "--shard-hypotheses"),
                                       (TRACK, "--shard-search")],
                         ids=["search", "track"])
def test_one_visible_device_warns_as_the_tpu_cli(argv, flag, capsys,
                                                 monkeypatch):
    import jax
    rc, out, _ = _run(cli.main, argv + [flag, "--device", "cpu"], capsys)
    # the TPU CLI with one device visible
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jrc, jout, _ = _run(jcli.main, ["--platform", "cpu"] + argv + [flag],
                        capsys)
    assert rc == jrc == 0
    assert out.splitlines()[0] == jout.splitlines()[0] == WARN.format(flag)


@pytest.mark.parametrize("argv,flag", [(SEARCH, "--shard-hypotheses"),
                                       (TRACK, "--shard-search")],
                         ids=["search", "track"])
def test_several_visible_devices_take_a_grid(argv, flag, capsys,
                                             monkeypatch):
    """Two visible devices: no warning, with the flag or by default, and
    the searches run over a (2 x 1) grid."""
    import torch

    from lte_cell_scanner_tpu_torch import device as tdevice
    from lte_cell_scanner_tpu_torch.models import search as tsearch

    cpu = torch.device("cpu")
    monkeypatch.setattr(tdevice, "visible_devices", lambda d=None: [cpu, cpu])
    shapes = []
    real = tsearch.cell_search_sharded

    def sharded(*a, **k):
        shapes.append(a[5].shape)
        return real(*a, **k)

    monkeypatch.setattr(tsearch, "cell_search_sharded", sharded)
    for extra in ([flag], []):
        rc, out, _ = _run(cli.main, argv + extra + ["--device", "cpu"],
                          capsys)
        assert rc == 0 and "Warning" not in out
    if argv is SEARCH:
        assert shapes == [{"t": 2, "f": 1}] * 2
        assert _table(out)[3].startswith("277 2 ")
    rc, out, _ = _run(cli.main, argv + [f"--no-{flag[2:]}", "--device",
                                        "cpu"], capsys)
    assert rc == 0 and len(shapes) == (2 if argv is SEARCH else 0)


def test_shard_carriers_spreads_the_band_over_visible_devices(
        capture_files, capsys, monkeypatch):
    """--shard-carriers with two visible devices: scan_band over both
    (a 2-device list), the table of the one-device batched scan."""
    import torch

    from lte_cell_scanner_tpu_torch import device as tdevice
    from lte_cell_scanner_tpu_torch.parallel import carriers as tcar

    argv = ["search", "-s", "739e6", "-e", "739.1e6", "-p", "5",
            "--device", "cpu", "--shard-carriers", "--load-files",
            capture_files["u8"], capture_files["it"]]
    rc, one, _ = _run(cli.main, argv, capsys)
    cpu = torch.device("cpu")
    monkeypatch.setattr(tdevice, "visible_devices", lambda d=None: [cpu, cpu])
    meshes = []
    real = tcar.scan_band

    def scan(*a, **k):
        meshes.append(k.get("mesh"))
        return real(*a, **k)

    monkeypatch.setattr(tcar, "scan_band", scan)
    rc2, two, _ = _run(cli.main, argv, capsys)
    assert rc == rc2 == 0
    assert meshes == [[cpu, cpu]]
    assert _table(one) == _table(two)
