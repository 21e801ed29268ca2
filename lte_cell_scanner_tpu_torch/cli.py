"""Command-line cell search on one carrier or a band of carriers.

Behavioral contract: the reference CellSearch CLI
(reference src/CellSearch.cpp:92-280, results table :576-614), for
synthetic captures.  A band (-s .. -e on the 100 kHz raster) runs as one
batched band scan on the card (parallel/carriers.py::scan_band) and
carrier by carrier on the CPU.

Usage:
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 --sim -p 100
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 -e 740e6 \
        --sim -p 100
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 --sim \
        --device cpu -p 10
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def _freq_formatter(freq: float) -> str:
    """Reference freq_formatter (CellSearch.cpp:322-340)."""
    a = abs(freq)
    for limit, div, suf in ((998.0, 1.0, "h"), (998e3, 1e3, "k"),
                            (998e6, 1e6, "m"), (998e9, 1e9, "g")):
        if a < limit:
            return f"{freq / div:5.3g}{suf}"
    return str(freq)


def _print_cells(cells, correction: float) -> None:
    """Final results table (reference CellSearch.cpp:576-614)."""
    if not cells:
        print("No LTE cells were found...")
        return
    print("Detected the following cells:")
    print("A: #antenna ports C: CP type ; P: PHICH duration ; "
          "PR: PHICH resource type")
    print("CID A      fc   foff RXPWR C nRB P  PR CrystalCorrectionFactor")
    for c in cells:
        cp = {"normal": "N", "extended": "E"}.get(c.cp_type.value, "U")
        pd = {"normal": "N", "extended": "E"}.get(
            c.phich_duration.value, "U")
        pr = {"1/6": "1/6", "1/2": "1/2", "one": "one",
              "two": "two"}.get(c.phich_resource.value, "UNK")
        # best available offset estimate: --no-decode runs stop at
        # freq_fine (freq_superfine stays NaN)
        foff = c.freq_superfine
        if not np.isfinite(foff):
            foff = c.freq_fine if np.isfinite(c.freq_fine) else c.freq
        true_loc = c.fc_requested
        crystal_actual = c.fc_requested - foff
        corr_new = correction * (true_loc / crystal_actual)
        print(f"{c.n_id_cell():3d} {c.n_ports:1d} "
              f"{c.fc_requested / 1e6:6.5g}M "
              f"{_freq_formatter(foff)} "
              f"{10 * np.log10(c.pss_pow):5.3g} {cp} {c.n_rb_dl:3d} {pd} "
              f"{pr} {corr_new:.20g}")


def _sim_captures(args, n: int) -> List[np.ndarray]:
    """n synthetic captures of the same cell, one per carrier, drawn in
    turn from one generator (each carrier gets a fresh capture)."""
    from .cell import CpType
    from .sim import apply_freq_offset, awgn, create_dl_sig

    if not 0 <= args.sim_cell <= 503:
        raise SystemExit("Error: --sim-cell must be in 0..503")
    rng = np.random.default_rng(0)
    caps = []
    for _ in range(n):
        sig = create_dl_sig(CpType(args.sim_cp), 80, 0, args.sim_cell // 3,
                            args.sim_cell % 3, 0.5, rng=rng,
                            n_ports=args.sim_ports)
        caps.append(awgn(apply_freq_offset(sig, args.sim_foff),
                         args.sim_snr, rng=rng))
    return caps


def cmd_search(args) -> int:
    from .constants import FS_WORK
    from .device import resolve_device
    from .models.search import (SearchConfig, cell_search, dedup,
                                default_f_search_set)
    from .parallel.carriers import scan_band

    freq_start = args.freq_start
    freq_end = args.freq_end if args.freq_end else freq_start
    # second-order validation, reference CellSearch.cpp:222-262
    if freq_start < 1e6:
        print("Error: start frequency must be greater than 1MHz")
        return 1
    if freq_end < freq_start:
        print("Error: end frequency must be >= start frequency")
        return 1
    for name, v in (("freq-start", freq_start), ("freq-end", freq_end)):
        if abs(v - round(v / 100e3) * 100e3) > 1:
            print(f"Warning: {name} rounded to the 100 kHz raster")
    freq_start = round(freq_start / 100e3) * 100e3
    freq_end = round(freq_end / 100e3) * 100e3
    if args.ppm < 0:
        print("Error: ppm value must be positive")
        return 1
    if args.ppm > 200:
        print("Warning: ppm value appears to be set unreasonably high")
    if not args.sim:
        print("Error: only --sim captures are supported")
        return 1

    dev = resolve_device(args.device)
    fc_search_set = np.arange(freq_start, freq_end + 1, 100e3)
    f_search_set = default_f_search_set(freq_start, args.ppm)
    cfg = SearchConfig(decode=not args.no_decode)
    caps = _sim_captures(args, len(fc_search_set))
    if len(fc_search_set) > 1 and dev.type == "cuda":
        # the whole band as one batched scan on the card; the serial loop
        # is the CPU's
        print(f"Scanning {len(fc_search_set)} carriers, "
              f"{fc_search_set[0] / 1e6:.4g}-{fc_search_set[-1] / 1e6:.4g}"
              f" MHz ...")
        all_cells = scan_band([(c, float(fc), float(fc))
                               for c, fc in zip(caps, fc_search_set)],
                              f_search_set, FS_WORK, cfg, device=dev)
    else:
        all_cells = []
        for cap, fc in zip(caps, fc_search_set):
            print(f"Examining center frequency {fc / 1e6:.4g} MHz ...")
            all_cells.append(cell_search(cap, f_search_set, float(fc),
                                         float(fc), FS_WORK, cfg,
                                         device=dev))
    for cells in all_cells:
        for c in cells:
            print(f"  Detected a cell! {c}")
    _print_cells(dedup(all_cells), args.correction)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="lte_cell_scanner_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("search", help="search carriers for LTE cells")
    ps.add_argument("-s", "--freq-start", type=float, required=True)
    ps.add_argument("-e", "--freq-end", type=float, default=None,
                    help="last carrier of the band (default: freq-start)")
    ps.add_argument("-p", "--ppm", type=float, default=120.0)
    ps.add_argument("-c", "--correction", type=float, default=1.0)
    ps.add_argument("--sim", action="store_true",
                    help="search a synthetic capture")
    ps.add_argument("--sim-snr", type=float, default=10.0)
    ps.add_argument("--sim-foff", type=float, default=0.0)
    ps.add_argument("--sim-ports", type=int, default=2, choices=(1, 2, 4))
    ps.add_argument("--sim-cp", default="normal",
                    choices=("normal", "extended"))
    ps.add_argument("--sim-cell", type=int, default=277)
    ps.add_argument("--no-decode", action="store_true",
                    help="stop after SSS detection and fine FOE")
    ps.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    return cmd_search(args)


if __name__ == "__main__":
    raise SystemExit(main())
