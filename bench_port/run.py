"""Run one cell of the port's benchmark and print its result line.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The cell (``workloads`` in BENCHMARK.json)
names a configuration (bench_port/configs/<config>.json) and a traffic
mix (bench_port/traffic/<traffic>.json); the traffic names its driver
(bench_port/drivers/<driver>.py), which makes the inputs from the seed,
warms the cell's shapes and drives the program's entry.  Set-up ends at
the first timed call; the window then runs for ``--seconds``.  With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` the window runs with the program's stage timers on, a
short profiled stretch follows, and the result holds the cell's
per-layer metrics, read by one file each under bench_port/metrics/.
Every run judges the window's answers against the plain reference
(bench_port/reference.py) and prints each number compared beside its
limit as the last lines of standard error.  The last line of standard
output is the result's JSON object.

Exits non-zero with no result when there is no card, fewer cards than
the cell asks for, or when jax, jaxlib, flax or the JAX package sits in
``sys.modules`` after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lte_cell_scanner_tpu")


def _fix_paths() -> None:
    """Import the harness as the package ``bench_port`` and the program
    from the checkout's root; keep the program's and the compilers'
    caches at fixed paths inside the checkout."""
    if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == HERE:
        sys.path.pop(0)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    """A module of the harness found by its file name (a driver or a
    metric reader)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str, data: dict = None):
    """(cell entry, configuration, traffic) of a workload by name; the
    files' contents come from ``data`` ({"configs/<name>": ...,
    "traffic/<name>": ...}) where it has them."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    w = cells[workload]
    data = data or {}

    def get(kind, name):
        key = f"{kind}/{name}"
        return data[key] if key in data else load_json(HERE / f"{key}.json")
    return w, get("configs", w["config"]), get("traffic", w["traffic"])


def cell_metrics(bench: dict, workload: str):
    """The cell's end-to-end and per-layer metric entries."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if listed(m) and m["moves"] in names]
    return e2e, layer


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        lines = out.stdout.strip().splitlines()
        return lines[0] if lines else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_window(drv, seconds: float, timings=None):
    """Drive the cell for ``seconds``: returns (units, wall seconds,
    per-step seconds)."""
    steps = []
    units = 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        units += drv.step(timings)
        te = time.perf_counter()
        steps.append(te - ts)
        if te - t0 >= seconds:
            return units, te - t0, steps


def main(argv=None, device: str = "cuda", check_card: bool = True,
         patch=None, bench: dict = None, data: dict = None) -> int:
    """One run.  ``device``, ``check_card``, ``patch`` (a callable given
    the driver after its warm-up, before the window), ``bench`` (in
    place of BENCHMARK.json) and ``data`` (in place of configuration and
    traffic files) serve the harness's own tests, which drive the rest
    of a run on the CPU at a small size, some with the timed path broken
    underneath."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _fix_paths()
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = cell_spec(bench, args.workload, data)
    e2e, layer = cell_metrics(bench, args.workload)

    import torch
    if check_card:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"the cell needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
    from bench_port import harness
    drv_mod = load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                          f"bench_port_driver_{traffic['driver']}")
    t_imports = time.perf_counter() - T_START
    drv = drv_mod.Driver(cfg, traffic, args.seed, torch.device(device))
    drv.warm()
    if patch is not None:
        patch(drv)
    drv.begin()
    harness.sync(device)
    setup_s = time.perf_counter() - T_START
    print(f"set-up {setup_s:.3f} s: imports {t_imports:.3f} s, "
          + ", ".join(f"{k} {v:.3f}" for k, v in drv.split.items()),
          file=sys.stderr)

    result = {"correct": False, "attempted": 0, "failed": 0,
              "metrics": {}, "device": {}}
    if args.trace == 0:
        units, wall, steps = run_window(drv, args.seconds)
        drv.end()
        values = dict(drv.end_to_end(units, wall, steps), setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]} for m in e2e}
    else:
        spans: dict = {}
        units, wall, steps = run_window(drv, args.seconds, spans)
        drv.end()
        prof = harness.profile(drv, device)
        rec = {"spans": spans, "units": units, "steps": len(steps),
               "shapes": drv.shapes(), **prof}
        values = {}
        for m in layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "bench_port_metric_"
                                 + m["name"].replace(".", "_"))
            v = reader.read(rec)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
        result["breakdown"] = prof["breakdown"]
    result["attempted"] = len(steps)
    mem = harness.memory_peak(device)
    result["device"] = harness.device_info(device, cell["chips"], mem)
    if args.trace == 1:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
    if check_card:
        result["device"]["power"] = power_limit()
    drv.release()

    verdict = drv.judge(cfg["guarantees"])
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    result["failed"] = verdict.failed
    result["correct"] = verdict.correct
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v),
                               "limit": lim}
                        for name, (v, lim) in verdict.checks.items()}
    print(json.dumps(result), flush=True)
    for note in verdict.notes:
        print(f"mismatch: {note}", file=sys.stderr)
    print(f"answers judged {verdict.answers}, correct {verdict.correct}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
