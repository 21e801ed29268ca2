"""The benchmark's files: BENCHMARK.json and every file it names parse
and keep to the contract's character sets and limits; every per-layer
metric has its reader, which declares the same layer, unit, source and
end-to-end metric; no file of the harness imports JAX or the JAX
package.

    python -m pytest bench_port/tests -q
"""

from __future__ import annotations

import ast
import importlib.util
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "bench_port"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "lte_cell_scanner_tpu"}


def _line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["bench_port"]
    assert all(_line_ok(w) for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32


def test_names_units_and_entries():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and _line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line_ok(w["why"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_configs_and_traffic_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line_ok(c["source"])
        assert c["file"].startswith("bench_port/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        g = cfg["guarantees"]
        assert g["freq_tol_ppm"] > 0 and g["timing_tol_samples"] > 0
    for w in BENCH["workloads"]:
        t = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        assert (HERE / "drivers" / f"{t['driver']}.py").exists()


def _cells_reporting(metric: dict):
    return [w["name"] for w in BENCH["workloads"]
            if "workloads" not in metric or w["name"] in metric["workloads"]]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_declares_its_entry(metric):
    path = HERE / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        metric["layer"], metric["unit"], metric["moves"], metric["source"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    # every cell that lists this metric reports the metric it moves
    assert set(_cells_reporting(metric)) <= set(
        _cells_reporting(e2e[metric["moves"]]))


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in _cells_reporting(m)]
        layer = [m for m in BENCH["per_layer"]
                 if w["name"] in _cells_reporting(m) and m["moves"] in e2e]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]


def test_layers_are_named_alike():
    """Metrics of one module name that module's layer letter for letter."""
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[-1], set()).add(
            m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (path, tops)


def test_run_loads_no_jax_module():
    """What a run loads (the harness, every driver and the program's
    entries they import) holds no module whose top-level name is jax,
    jaxlib, flax or lte_cell_scanner_tpu, compared whole: the port's
    name begins with the JAX package's."""
    import subprocess
    import sys
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bench_port import run, harness, readers, control\n"
        "run._fix_paths()\n"
        "import torch\n"
        "for p in sorted((run.HERE / 'drivers').glob('*.py')):\n"
        "    run.load_module(p, p.stem)\n"
        "import lte_cell_scanner_tpu_torch.tracker\n"
        "import lte_cell_scanner_tpu_torch.tracker.device_loop\n"
        "assert 'lte_cell_scanner_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"
