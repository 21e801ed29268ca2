"""Readings of the program, of its control and of a fault, seed by seed,
at the cell's own size on the card: the readings that the comparison's
limits rest on (the benchmark's own runs do not run this).

    python3 bench_port/control.py --workload <name> --seeds 1,2,3
        [--seconds 10]

For each seed one process makes the stream and warms the tracker once,
then runs three windows of ``--seconds`` in turn, each judged on its
own: the program as it is; the control, the same program with its tick
computed in complex64 (the precision below the complex128 that the
configuration states: the tick's float64 inputs cast to float32 on the
way in, its output cast back); and the fault, every MIB re-decode
skipped (returning at once as if it had passed, as a PR trimming the
control loops might).  One JSON line per window.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

if __package__ in (None, ""):
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from bench_port import harness, run  # noqa: E402


def complex64_tick(program):
    """The tick's device program computed in complex64."""
    def tick(planes, data, starts, fln, init_phase, fc_req, fc_prog,
             fs_prog, rs_flat, rs_tab, spec_rows, spec_mask):
        out = program(planes, None if data is None else data.float(),
                      starts, fln.float(), init_phase.float(), fc_req,
                      fc_prog, fs_prog, rs_flat, rs_tab.float(), spec_rows,
                      spec_mask.float())
        return out.double()
    return tick


def patch_complex64():
    """Put the complex64 tick in the program's place; returns the undo."""
    from lte_cell_scanner_tpu_torch.tracker import device_loop
    orig = device_loop._tick_program
    device_loop._tick_program = complex64_tick(orig)

    def undo():
        device_loop._tick_program = orig
    return undo


def patch_mib_skipped():
    """Make every MIB re-decode return at once; returns the undo."""
    from lte_cell_scanner_tpu_torch.tracker import cell_tracker
    cls = cell_tracker.TrackedCellProcessor
    orig = cls._mib_try_decode
    cls._mib_try_decode = lambda self: True

    def undo():
        cls._mib_try_decode = orig
    return undo


RUNS = (("program", None), ("control_complex64", patch_complex64),
        ("fault_mib_skipped", patch_mib_skipped))


def readings(workload: str, seed: int, seconds: float,
             device: str = "cuda"):
    """One JSON-ready line per window: the program's, the control's and
    the fault's readings on one seed."""
    run._fix_paths()
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, cfg, traffic = run.cell_spec(bench, workload)
    import torch
    mod = run.load_module(run.HERE / "drivers" / f"{traffic['driver']}.py",
                          f"bench_port_driver_{traffic['driver']}")
    drv = mod.Driver(cfg, traffic, seed, torch.device(device))
    drv.warm()
    out = []
    for name, patch in RUNS:
        undo = patch() if patch is not None else None
        try:
            drv.begin()
            units, wall, _ = run.run_window(drv, seconds)
            drv.end()
        finally:
            if undo is not None:
                undo()
        v = drv.judge(cfg["guarantees"])
        out.append({"workload": workload, "seed": seed, "run": name,
                    "realtime_factor": units / 1.92e6 / wall,
                    "correct": v.correct,
                    "checks": {k: x[0] for k, x in v.checks.items()},
                    "notes": v.notes[:4]})
    drv.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for line in readings(args.workload, seed, args.seconds):
            print(json.dumps(line), flush=True)
    harness.sync("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
