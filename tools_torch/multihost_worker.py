"""One process of a band scan spread over processes
(``parallel/multihost.py``): the counterpart of tools/multihost_worker.py.

Each worker joins the process group (gloo over localhost), takes its
slice of a band and runs ``scan_band_multihost``; the gathered and
deduplicated cells, the route verdicts each chunk gathered and, on the
card, the kernel launches of each pass go to a JSON file.

--band four (default): the four-carrier band of the TPU package's worker
(N_CARRIERS, CARRIERS_PER_PROC, F_SEARCH, CELL_OF, make_capture): two
carriers per process, full decode; the unequal 3 + 1 split of the same
band (the padding path); then the band on the 8-bit ADC grid, detection
only (the int8 route on the card; the exact route on the CPU, which runs
no kernel).  JSON keys as that worker's (``merged``, ``merged_unequal``,
``merged_pallas_ids``, ``process``, ...) plus ``verdicts``.

--band scenario: the 101-carrier 10 MHz band of
``sim/scenarios.py::band_captures`` in the CLI's strided split (process
p takes carriers p, p + n, ...), the float band and the ADC-grid band,
each once counted and then REPEATS times timed.

Usage (one per process; the test and chip_smoke.py start them):
  python tools_torch/multihost_worker.py --coordinator 127.0.0.1:PORT \\
      --num-processes 2 --process-id I --out OUT.json [--device cpu] \\
      [--band scenario]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N_CARRIERS = 4
CARRIERS_PER_PROC = 2
FC0 = 739e6
N_SUBFRAMES = 80          # 80 ms captures (>= one full 40 ms PBCH
                          # period at any frame phase -> MIB decodes)
F_SEARCH = [-5e3, 0.0, 5e3]
# carrier -> (n_id_1, n_id_2) of an embedded sim cell (None = pure noise)
CELL_OF = {0: (92, 1), 3: (167, 2)}
REPEATS = 2               # timed passes per band (--band scenario)


def make_capture(carrier: int):
    """Deterministic per-carrier capture: sim eNodeB + AWGN or noise."""
    from lte_cell_scanner_tpu_torch.cell import CpType
    from lte_cell_scanner_tpu_torch.sim import awgn, create_dl_sig

    rng = np.random.default_rng(1000 + carrier)
    n_samp = N_SUBFRAMES * 1920
    if carrier in CELL_OF:
        n_id_1, n_id_2 = CELL_OF[carrier]
        sig = create_dl_sig(CpType.NORMAL, N_SUBFRAMES, 0, n_id_1, n_id_2,
                            0.5, rng=rng, n_ports=2, sfn=100)
        sig = awgn(sig, 5.0, rng=rng)
    else:
        sig = (rng.normal(size=n_samp) + 1j * rng.normal(size=n_samp)) \
            .astype(np.complex128) * np.sqrt(0.5)
    fc = FC0 + 100e3 * carrier
    return sig, fc, fc


def to_grid(x):
    """The 8-bit dongle grid of the TPU package's worker."""
    k = np.clip(np.round(x.real * 128), -127, 127) \
        + 1j * np.clip(np.round(x.imag * 128), -127, 127)
    return (k / 128.0).astype(np.complex64)


def cell_summary(c):
    return {"n_id_cell": c.n_id_cell(), "n_id_2": c.n_id_2,
            "cp": c.cp_type.value,
            "fc": c.fc_requested,
            "frame_start": round(float(c.frame_start), 6),
            "freq_fine": round(float(c.freq_fine), 3),
            "pss_pow": float(c.pss_pow),
            # decoded MIB fields: they must cross the gather (the
            # reference's results table, CellSearch.cpp:576-614)
            "n_ports": c.n_ports, "n_rb_dl": c.n_rb_dl, "sfn": c.sfn,
            "phich_duration": c.phich_duration.value,
            "phich_resource": c.phich_resource.value}


def cell_record(c):
    """Every field at full precision (the chip run's comparison)."""
    return {"n_id_cell": c.n_id_cell(), "cp": c.cp_type.value,
            "fc": c.fc_requested, "frame_start": float(c.frame_start),
            "pss_pow": float(c.pss_pow),
            "freq_superfine": float(c.freq_superfine),
            "n_ports": c.n_ports, "n_rb_dl": c.n_rb_dl, "sfn": c.sfn}


def _by_fc(cells):
    return sorted(cells, key=lambda c: (c.fc_requested, c.n_id_cell()))


def _launches(dev):
    import torch

    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {k: v for k, v in corr_cuda.LAUNCHES.items() if v}


def run_four(args, dev) -> dict:
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import SearchConfig
    from lte_cell_scanner_tpu_torch.parallel import multihost

    my = range(args.process_id * CARRIERS_PER_PROC,
               (args.process_id + 1) * CARRIERS_PER_PROC)
    captures = [make_capture(i) for i in my]
    verdicts = {"equal": [], "unequal": [], "adc": []}
    # full decode: n_ports/n_rb_dl/sfn must cross the gather
    cfg = SearchConfig()
    local_lists, merged = multihost.scan_band_multihost(
        captures, np.asarray(F_SEARCH), FS_WORK, cfg, device=dev,
        verdicts=verdicts["equal"])
    # the same band split 3 + 1: scan_band_multihost pads the short
    # slice itself
    uneq = [make_capture(i) for i in (range(3) if args.process_id == 0
                                      else [3])]
    _, merged_uneq = multihost.scan_band_multihost(
        uneq, np.asarray(F_SEARCH), FS_WORK, cfg, device=dev,
        verdicts=verdicts["unequal"])
    # captures on the 8-bit ADC grid (what a dongle delivers), detection
    # only: the int8 route of every rank on the card
    gcaps = [(to_grid(c), fc, fcp) for c, fc, fcp in captures]
    _, merged_adc = multihost.scan_band_multihost(
        gcaps, np.asarray(F_SEARCH), FS_WORK, SearchConfig(decode=False),
        device=dev, verdicts=verdicts["adc"])
    return {
        "local_counts": [len(cells) for cells in local_lists],
        "local": [[cell_summary(c) for c in cells] for cells in local_lists],
        "merged": [cell_summary(c) for c in _by_fc(merged)],
        "merged_unequal": [cell_summary(c) for c in _by_fc(merged_uneq)],
        "merged_pallas_ids": sorted(c.n_id_cell() for c in merged_adc),
        "verdicts": verdicts,
    }


def run_scenario(args, dev) -> dict:
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import (
        default_f_search_set)
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.parallel import multihost
    from lte_cell_scanner_tpu_torch.sim.scenarios import band_captures

    t0 = time.perf_counter()
    bands = dict(zip(("float", "adc"), band_captures()))
    made_s = time.perf_counter() - t0
    f_set = default_f_search_set(739e6, 100.0)
    out = {"band_made_s": made_s}
    for name, band in bands.items():
        mine = band[args.process_id::args.num_processes]
        verdicts = []
        corr_cuda.reset_launch_counts()
        _, merged = multihost.scan_band_multihost(
            mine, f_set, FS_WORK, device=dev, verdicts=verdicts)
        launches = _launches(dev)
        secs = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            multihost.scan_band_multihost(mine, f_set, FS_WORK, device=dev)
            _launches(dev)
            secs.append(time.perf_counter() - t0)
        out[name] = {"carriers": len(mine), "band_carriers": len(band),
                     "merged": [cell_record(c) for c in _by_fc(merged)],
                     "verdicts": verdicts, "launches": launches,
                     "seconds": secs}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda: cuda:(rank %% device count); cpu: the host")
    ap.add_argument("--band", choices=("four", "scenario"), default="four")
    args = ap.parse_args(argv)

    import torch

    from lte_cell_scanner_tpu_torch.parallel import multihost

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id)
    try:
        dev = multihost.local_device(args.device)
        res = (run_four if args.band == "four" else run_scenario)(args, dev)
    finally:
        multihost.finalize()
    res.update({"process": args.process_id,
                "n_processes": args.num_processes, "device": str(dev)})
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(f"worker {args.process_id} on {dev}: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
