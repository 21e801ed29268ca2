"""Command-line cell search on one carrier or a band of carriers, the
realtime multi-cell tracker, and the capture-integrity check.

Behavioral contract: the reference CellSearch CLI
(reference src/CellSearch.cpp:92-280: --freq-start/-s, --freq-end/-e,
--ppm/-p, --correction/-c, --record/-r, --load/-l, --data-dir/-d,
--device-index/-i; 100 kHz raster rounding, record/load exclusivity;
results table :576-614) plus the reference tracker's hidden replay flags
(--drop, --repeat, --noise-power), and the reference LTE-Tracker CLI
(reference src/LTE-Tracker.cpp:114-373: --freq/-f; the tracker/
package, kalibrate, warmup, the text or curses dashboard), and the
reference rtl_sdr_check tool (``check``, diag.py).  Captures come from
recorded files (``capbuf_XXXX.it`` with -l, or .it / raw rtl_sdr u8
files with --load-files), the synthetic eNodeB (--sim) or, when none of
those is named, a live RTL-SDR dongle through librtlsdr
(io/rtlsdr.py).  A band (-s .. -e on the 100 kHz
raster) runs as one batched band scan on the card
(parallel/carriers.py::scan_band) and carrier by carrier on the CPU
(--shard-carriers / --no-shard-carriers choose).

Usage:
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 \
        --load-files cap.u8 -p 100
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 -l -d DIR
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 --sim -r -d DIR
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 -e 740e6 \
        --sim -p 100
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 --sim \
        --device cpu -p 10
    python -m lte_cell_scanner_tpu_torch.cli track -f 739e6 --sim \
        --duration 5 --no-tui
    python -m lte_cell_scanner_tpu_torch.cli search -s 739e6 -p 100
    python -m lte_cell_scanner_tpu_torch.cli check cap.u8 -f 739e6 \
        --cell-id 277
"""

from __future__ import annotations

import argparse
import sys
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


def _make_source(args):
    from .cell import CpType
    from .io.capture import FileSource, SimSource
    if args.live:
        from .io.rtlsdr import RtlSdrSource
        try:
            return RtlSdrSource(device_index=max(0, args.device_index),
                                correction=args.correction)
        except RuntimeError as e:
            raise SystemExit(f"Error: {e}")
    if args.sim:
        if not 0 <= args.sim_cell <= 503:
            raise SystemExit("Error: --sim-cell must be in 0..503")
        fc = getattr(args, "freq_start", None) or args.freq
        return SimSource(n_id_1=args.sim_cell // 3, n_id_2=args.sim_cell % 3,
                         cp_type=CpType(args.sim_cp), n_ports=args.sim_ports,
                         snr_db=args.sim_snr, freq_offset=args.sim_foff,
                         capture_ms=getattr(args, "capture_ms", 80),
                         coupled_fc=fc if args.sim_coupled else 0.0)
    return FileSource(args.load_files, drop_seconds=args.drop,
                      repeat=args.repeat, noise_power=args.noise_power)


def _time_grid(flag: Optional[bool], name: str, devices):
    """A (n x 1) grid over the n visible devices for the hypothesis
    sweep's front end, decided as the TPU CLI decides it: by default
    when there are several; a flag asked for with one device visible
    warns and runs on that device."""
    on = flag
    if on is None:
        on = len(devices) > 1
    elif on and len(devices) == 1:
        print(f"Warning: {name} requested but only one device is visible; "
              f"running single-device")
        on = False
    if not (on and len(devices) > 1):
        return None
    from .parallel.sharded import make_mesh
    return make_mesh(len(devices), 1, devices)


def _search_multihost(args, fc_search_set, f_search_set, cfg,
                      capture) -> int:
    """The band over several processes (parallel/multihost.py): join
    the group, capture this process's strided slice of the band, scan
    it, gather and deduplicate every process's cells; rank 0 prints the
    table."""
    import torch

    from .constants import FS_WORK
    from .device import resolve_device
    from .parallel import multihost
    # decided the same on every process from the band alone, BEFORE
    # joining: a check after joining would leave the peers waiting in
    # the first collective
    if len(fc_search_set) < args.num_processes:
        print(f"Error: band has fewer carriers "
              f"({len(fc_search_set)}) than processes "
              f"({args.num_processes}); some process would own none")
        return 1
    if resolve_device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("Error: no CUDA device (each process runs on a card; "
              "--device cpu runs it on the host)")
        return 1
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id)
    try:
        captures = []
        # this process's real carriers, each numbered by its band index
        # so that -l replays (and -r writes) the right capbuf_XXXX.it
        # files on a shared data dir; scan_band_multihost pads unequal
        # slices itself
        for k, fc in enumerate(fc_search_set[args.process_id::
                                             args.num_processes]):
            fc = float(fc)
            band_idx = args.process_id + k * args.num_processes
            if args.verbose:
                print(f"[proc {args.process_id}] capturing "
                      f"{fc / 1e6:.4g} MHz (band index {band_idx}) ...")
            capbuf, fc_programmed = capture(fc, index=band_idx)
            captures.append((capbuf, fc, fc_programmed))
        _local, merged = multihost.scan_band_multihost(
            captures, f_search_set, FS_WORK, cfg, device=args.device)
    finally:
        multihost.finalize()
    if args.process_id == 0:
        _print_cells(merged, args.correction)
        _print_profile(args)
    return 0


def cmd_search(args) -> int:
    from .constants import FS_WORK
    from .device import resolve_device, visible_devices
    from .interop import _BACKENDS
    from .io.capture import CaptureSession
    from .models.search import (SearchConfig, cell_search, dedup,
                                default_f_search_set)
    from .parallel.carriers import make_carrier_mesh, scan_band
    from .utils.debug import enable_profiling
    if args.brief:
        args.verbose = 0
    if args.profile:
        enable_profiling()

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
    if abs(args.correction - 1) > 1000e-6:
        print("Warning: crystal correction factor appears to be "
              "unreasonable")
    if args.record and (args.load or args.load_files):
        print("Error: cannot both record and load")
        return 1
    if args.capture_ms < 80:
        print("Error: --capture-ms must be >= 80 (one full 40 ms PBCH "
              "period regardless of frame phase needs an 80 ms capture)")
        return 1
    args.live = not (args.sim or args.load or args.load_files)
    source = _make_source(args)
    if args.load:
        source = None  # capture_data reads capbuf_XXXX.it from data_dir

    dev = resolve_device(args.device)
    f_search_set = default_f_search_set(freq_start, args.ppm)
    fc_search_set = np.arange(freq_start, freq_end + 1, 100e3)
    cfg = SearchConfig(interp=args.interp, compat=args.compat,
                       thresh2_n_sigma=float(args.thresh2_sigma),
                       decode=not args.no_decode,
                       corr_backend=_BACKENDS[args.corr_backend])
    session = CaptureSession(args.data_dir)

    def capture(fc: float, index: Optional[int] = None):
        # replayed and synthetic captures are taken at the requested
        # frequency: no tuner model
        return session.capture_data(fc, source, save_cap=args.record,
                                    use_recorded_data=args.load,
                                    tuner="none", index=index)

    if args.coordinator:
        return _search_multihost(args, fc_search_set, f_search_set, cfg,
                                 capture)

    devices = visible_devices(dev)
    shard_carriers = args.shard_carriers
    if shard_carriers is None:
        # the whole band as one batched scan on the card; the serial loop
        # is the CPU's
        shard_carriers = len(fc_search_set) > 1 and dev.type == "cuda"

    all_cells = []
    if shard_carriers:
        captures = []
        for fc in fc_search_set:
            if args.verbose:
                print(f"Capturing center frequency {fc / 1e6:.4g} MHz ...")
            capbuf, fc_programmed = capture(float(fc))
            captures.append((capbuf, float(fc), fc_programmed))
        if args.verbose:
            print(f"Scanning {len(captures)} carriers, "
                  f"{fc_search_set[0] / 1e6:.4g}-{fc_search_set[-1] / 1e6:.4g}"
                  f" MHz ...")
        # several visible devices: each takes a block of every chunk
        mesh = make_carrier_mesh(devices=devices) if len(devices) > 1 \
            else None
        all_cells = scan_band(captures, f_search_set, FS_WORK, cfg,
                              device=None if mesh else dev, mesh=mesh)
        for cells in all_cells:
            for c in cells:
                if args.verbose:
                    print(f"  Detected a cell! {c}")
    else:
        # single carrier (or serial scan) with several devices: the
        # hypothesis sweep's front end over a (t x 1) grid of time blocks
        mesh = _time_grid(args.shard_hypotheses, "--shard-hypotheses",
                          devices)
        for fc in fc_search_set:
            if args.verbose:
                print(f"Examining center frequency {fc / 1e6:.4g} MHz ...")
            capbuf, fc_programmed = capture(float(fc))
            cells = cell_search(capbuf, f_search_set, float(fc),
                                fc_programmed, FS_WORK, cfg,
                                device=None if mesh else dev, mesh=mesh)
            for c in cells:
                if args.verbose:
                    print(f"  Detected a cell! {c}")
            all_cells.append(cells)
    _print_cells(dedup(all_cells), args.correction)
    _print_profile(args)
    return 0


def cmd_track(args) -> int:
    import torch

    from .constants import FS_WORK
    from .device import resolve_device, visible_devices
    from .interop import _BACKENDS
    from .models.search import SearchConfig
    from .tracker import TrackerRunner
    from .tracker.display import render
    from .tracker.runner import kalibrate
    from .utils.debug import enable_profiling

    if args.brief:
        args.verbose = 0
    if args.profile:
        enable_profiling()
    if args.ppm < 0:
        print("Error: ppm value must be positive")
        return 1
    if abs(args.correction - 1) > 1000e-6:
        print("Warning: crystal correction factor appears to be "
              "unreasonable")
    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("Error: no CUDA device (the tracker runs on the card; "
              "--device cpu runs it on the host)")
        return 1
    args.live = not (args.sim or args.load_files)
    source = _make_source(args)
    # the background searcher's front end over a (n x 1) grid of the
    # visible devices: by default when there are several
    mesh = _time_grid(args.shard_search, "--shard-search",
                      visible_devices(dev))

    # kalibrate bootstrap (reference LTE-Tracker.cpp:565-741): run a
    # full +-ppm cell search on one capture and seed the dongle FO
    # register from the strongest cell's superfine estimate -- without
    # it the single-hypothesis background searcher cannot acquire
    # beyond ~+-2.5 kHz of crystal error.
    initial_fo = 0.0
    if not args.no_kalibrate:
        if args.verbose:
            print(f"kalibrate: searching +-{args.ppm:g} ppm for a cell ...")
        try:
            initial_fo = kalibrate(
                lambda: source.capture(args.freq)[0], args.freq,
                args.freq, FS_WORK, ppm=args.ppm,
                max_tries=args.kalibrate_tries or None, device=dev)
            if args.verbose:
                print(f"kalibrate: dongle frequency offset "
                      f"{initial_fo:.1f} Hz")
        except (RuntimeError, ValueError) as e:
            # no cell in the tries allowed, or a file source ran out
            print(f"kalibrate found no cell ({e}); starting at 0 Hz")

    runner = TrackerRunner(args.freq, args.freq, FS_WORK,
                           initial_fo=initial_fo,
                           search_config=SearchConfig(
                               corr_backend=_BACKENDS[args.corr_backend]),
                           search_period=args.search_period,
                           search_async=args.async_search,
                           search_duty=args.search_duty,
                           parallel_cells=args.parallel_cells,
                           debug_knobs=tuple(
                               getattr(args, f"g{i}") for i in
                               range(1, 10)),
                           device=dev, search_mesh=mesh)
    if not args.no_warmup:
        if args.verbose:
            print("Compiling the search/decode path (one-time warmup) ...")
        runner.warmup()

    block = 10000
    if sys.stdout.isatty() and not args.no_tui:
        # the reference's live ncurses dashboard (display_thread.cpp)
        from .tracker.tui import run_tui
        stream = iter(source.stream(block))
        n_blocks = [0]

        def process_for(seconds: float) -> bool:
            n = max(1, int(args.fs * seconds) // block)
            for _ in range(n):
                if args.duration and \
                        n_blocks[0] * block / args.fs >= args.duration:
                    return False
                samples = next(stream, None)
                if samples is None:
                    return False
                runner.process_block(samples)
                n_blocks[0] += 1
            if hasattr(source, "dropped_seconds"):
                runner.state.usb_seconds_dropped = source.dropped_seconds()
            return True

        try:
            run_tui(process_for, runner.state, lambda: runner.cells)
        except KeyboardInterrupt:
            pass
        finally:
            runner.close()
        print(render(runner.state, runner.cells, plots=args.expert))
        _print_track_profile(args)
        return 0

    n_blocks = 0
    report_every = max(1, int(args.fs * 1.0) // block)
    try:
        for samples in source.stream(block):
            runner.process_block(samples)
            n_blocks += 1
            if hasattr(source, "dropped_seconds"):
                runner.state.usb_seconds_dropped = source.dropped_seconds()
            if n_blocks % report_every == 0:
                print(render(runner.state, runner.cells,
                             plots=args.expert))
                print("-" * 70)
            if args.duration and n_blocks * block / args.fs >= args.duration:
                break
    except KeyboardInterrupt:
        pass
    finally:
        runner.close()
    print(render(runner.state, runner.cells, plots=args.expert))
    _print_track_profile(args)
    return 0


def _print_profile(args) -> None:
    from .utils.debug import profile_report
    if args.profile:
        print()
        print(profile_report())


def _print_track_profile(args) -> None:
    """The span table, then how the tick's device program ran and how
    its inputs were staged (tracker/device_loop.py::tick_counts)."""
    from .tracker.device_loop import tick_counts
    _print_profile(args)
    if args.profile:
        print()
        print("tick program: " + ", ".join(
            f"{k} {v}" for k, v in tick_counts.items()))


def cmd_check(args) -> int:
    """Capture-integrity diagnostics (the reference rtl_sdr_check binary,
    reference src/rtl_sdr_check.cpp:280-424)."""
    from .diag import check_capture
    from .utils.itfile import read_itfile
    from .utils.rtl import read_rtlsdr_file

    if args.file.endswith(".it"):
        d = read_itfile(args.file)
        if "capbuf" not in d:
            raise ValueError(f"{args.file} has no 'capbuf' variable "
                             f"(found: {sorted(d) or 'none'})")
        cap = d["capbuf"]
    else:
        cap = read_rtlsdr_file(args.file)
    res = check_capture(cap, args.freq, args.foff, args.fs, args.cell_id,
                        drop_seconds=args.drop, device=args.device)
    print(f"Samples: {res.n_samples}  peak {res.peak_power_db:.1f} dB  "
          f"peak/avg {res.peak_to_average:.0f}  "
          f"expected period {res.expected_period:.3f}")
    if not res.sync_found():
        print("No sync-signal correlation found -- wrong cell ID / freq "
              "offset, or no such cell in this capture.")
        return 1
    print(f"{'location':>10} {'diff':>8} {'dropped':>8}  flag")
    for p in res.peaks:
        print(f"{p.location:>10} {p.diff_with_prev:>8} {p.n_dropped:>8}  "
              f"{p.severity}")
    if res.missing:
        print(f"Missing peaks near: {res.missing}")
    worst = res.worst_drop()
    print(f"Worst drop: {worst} samples"
          + ("  (capture is CLEAN)" if worst <= 2 else ""))
    return 0 if worst <= 2 and not res.missing else 2


def _add_check_parser(sub) -> None:
    pc = sub.add_parser("check", help="scan a capture for dropped samples")
    pc.add_argument("file", help=".it capture or raw rtl_sdr u8 file")
    pc.add_argument("-f", "--freq", type=float, required=True)
    pc.add_argument("--cell-id", type=int, required=True,
                    help="known cell ID whose sync signals to correlate")
    pc.add_argument("--foff", type=float, default=0.0)
    pc.add_argument("--fs", type=float, default=1.92e6)
    pc.add_argument("--drop", type=float, default=0.0,
                    help="seconds to skip at the start (AGC settle)")
    pc.add_argument("--device", default=None,
                    help="torch device of the correlation (default: cuda)")
    pc.set_defaults(func=cmd_check)


def _add_track_parser(sub) -> None:
    pt = sub.add_parser("track", help="realtime multi-cell tracker")
    pt.add_argument("-f", "--freq", type=float, required=True)
    pt.add_argument("--fs", type=float, default=1.92e6)
    pt.add_argument("--load-files", nargs="*", default=None)
    pt.add_argument("--sim", action="store_true")
    pt.add_argument("--sim-snr", type=float, default=10.0)
    pt.add_argument("--sim-foff", type=float, default=0.0)
    pt.add_argument("--sim-ports", type=int, default=2, choices=(1, 2, 4),
                    help="sim eNodeB TX ports (4 = SFBC+FSTD)")
    pt.add_argument("--sim-cp", default="normal",
                    choices=("normal", "extended"))
    pt.add_argument("--sim-cell", type=int, default=277,
                    help="sim cell ID (0..503)")
    pt.add_argument("--sim-coupled", action="store_true",
                    help="apply --sim-foff through the coupled-crystal "
                         "channel (carrier + sample clock offset together)")
    pt.add_argument("--noise-power", type=float, default=None)
    pt.add_argument("--drop", type=float, default=0.0)
    pt.add_argument("--repeat", action="store_true")
    pt.add_argument("--duration", type=float, default=None,
                    help="seconds of stream to process")
    pt.add_argument("--search-period", type=float, default=1.0,
                    help="min stream-seconds between background-search "
                         "cycles once tracking (0 = every capture, the "
                         "reference's continuous low-priority cadence)")
    pt.add_argument("--search-duty", type=float, default=0.5,
                    help="max share of the background searcher once "
                         "tracking: the next search waits until "
                         "cycle_time/duty stream-seconds since the last "
                         "(0 = period-only cadence)")
    pt.add_argument("--parallel-cells", type=int, default=0,
                    help=">1: run each cell's tracker tick on a worker "
                         "pool of this size (the reference's "
                         "thread-per-cell layout; ignored in device-loop "
                         "mode, which batches all cells in one tick)")
    pt.add_argument("--async-search", action="store_true",
                    help="run the background searcher on a nice+19 "
                         "worker thread (and its own CUDA stream) "
                         "concurrent with streaming; use with "
                         "wall-clock-paced sources -- file/sim replay "
                         "feeds faster than realtime")
    pt.add_argument("--shard-search", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="run the background searcher's front end over "
                         "all visible devices (overlap-save time blocks; "
                         "default: on when more than one is visible)")
    pt.add_argument("-p", "--ppm", type=float, default=120.0,
                    help="crystal-error window for the kalibrate "
                         "bootstrap search")
    pt.add_argument("-c", "--correction", type=float, default=1.0)
    pt.add_argument("-i", "--device-index", type=int, default=-1,
                    help="dongle index (live capture)")
    pt.add_argument("--corr-backend", default="auto",
                    choices=("auto", "pallas", "xla", "kernel", "exact"),
                    help="correlation backend of kalibrate and the "
                         "background searcher (as for search)")
    pt.add_argument("--kalibrate-tries", type=int, default=0,
                    help="max kalibrate search attempts (0 = retry "
                         "until a cell is found, the reference's loop; "
                         "bounded file replay ends the loop by running "
                         "out of captures)")
    pt.add_argument("--no-kalibrate", action="store_true",
                    help="skip the initial wide-ppm calibration search")
    pt.add_argument("-v", "--verbose", action="count", default=1)
    pt.add_argument("-b", "--brief", action="store_true",
                    help="reduce status messages (reference -b)")
    pt.add_argument("--no-warmup", action="store_true",
                    help="skip the one-time search-path warmup before "
                         "streaming (first acquisition will stall)")
    pt.add_argument("-x", "--expert", action="store_true",
                    help="show ASCII channel/autocorrelation plots")
    pt.add_argument("--no-tui", action="store_true",
                    help="disable the interactive curses dashboard even "
                         "on a tty (plain periodic prints)")
    pt.add_argument("--profile", action="store_true",
                    help="print a wall-time table of the tracker's spans "
                         "(kalibrate and warm-up searches, the tick, its "
                         "control loops) when the tracker stops")
    pt.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    for i in range(1, 10):
        # the reference's hidden generic debug knobs
        # (LTE-Tracker.cpp:158-166); carried on GlobalState.g, consumed
        # by no production path
        pt.add_argument(f"--g{i}", type=float, default=0.0,
                        help=argparse.SUPPRESS)
    pt.set_defaults(func=cmd_track)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="lte_cell_scanner_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("search", help="search carriers for LTE cells")
    ps.add_argument("-s", "--freq-start", type=float, required=True)
    ps.add_argument("-e", "--freq-end", type=float, default=None,
                    help="last carrier of the band (default: freq-start)")
    ps.add_argument("-p", "--ppm", type=float, default=120.0)
    ps.add_argument("-c", "--correction", type=float, default=1.0)
    ps.add_argument("-r", "--record", action="store_true",
                    help="write each capture to DATA_DIR/capbuf_XXXX.it")
    ps.add_argument("-l", "--load", action="store_true",
                    help="replay capbuf_XXXX.it files from --data-dir")
    ps.add_argument("-d", "--data-dir", default=".")
    ps.add_argument("-i", "--device-index", type=int, default=-1,
                    help="dongle index (live capture)")
    ps.add_argument("-v", "--verbose", action="count", default=1)
    ps.add_argument("-b", "--brief", action="store_true",
                    help="reduce status messages (reference -b)")
    ps.add_argument("--profile", action="store_true",
                    help="print a per-stage wall-time table after the scan")
    ps.add_argument("--load-files", nargs="*", default=None,
                    help="replay specific .it or raw rtl_sdr u8 files")
    ps.add_argument("--sim", action="store_true",
                    help="search a synthetic capture")
    ps.add_argument("--sim-snr", type=float, default=10.0)
    ps.add_argument("--sim-foff", type=float, default=0.0)
    ps.add_argument("--sim-ports", type=int, default=2, choices=(1, 2, 4),
                    help="sim eNodeB TX ports (4 = SFBC+FSTD)")
    ps.add_argument("--sim-cp", default="normal",
                    choices=("normal", "extended"))
    ps.add_argument("--sim-cell", type=int, default=277,
                    help="sim cell ID (0..503)")
    ps.add_argument("--sim-coupled", action="store_true",
                    help="apply --sim-foff through the coupled-crystal "
                         "channel (carrier + sample clock offset together)")
    ps.add_argument("--capture-ms", type=int, default=80,
                    help="sim capture length; >80 ms lengthens the "
                         "incoherent fold for more detection SNR")
    ps.add_argument("--noise-power", type=float, default=None,
                    help="add white Gaussian noise of this power to "
                         "replayed files")
    ps.add_argument("--drop", type=float, default=0.0,
                    help="seconds to skip at the start of raw u8 files")
    ps.add_argument("--repeat", action="store_true",
                    help="cycle through --load-files")
    ps.add_argument("--interp", default="hex",
                    choices=("hex", "2stage", "freq_time"),
                    help="channel-estimate interpolator (reference "
                         "default: hex/Delaunay, searcher.cpp:1474)")
    ps.add_argument("--compat", default="production",
                    choices=("production", "golden"),
                    help="numerical-contract variant: production = the "
                         "modern C++ formulas; golden = the MATLAB "
                         "semantics the reference's golden vectors encode")
    ps.add_argument("--thresh2-sigma", type=float, default=3.0,
                    help="SSS log-likelihood acceptance threshold in "
                         "sigmas (reference THRESH2_N_SIGMA = 3)")
    ps.add_argument("--no-decode", action="store_true",
                    help="stop after SSS detection and fine FOE")
    ps.add_argument("--corr-backend", default="auto",
                    choices=("auto", "pallas", "xla", "kernel", "exact"),
                    help="correlation backend: auto = the CUDA kernels on "
                         "the card, the exact correlation elsewhere; "
                         "kernel (or pallas) / exact (or xla) force either")
    ps.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0: scan the band over "
                         "several processes (torch.distributed, gloo; "
                         "every process runs the same command with its "
                         "own --process-id)")
    ps.add_argument("--num-processes", type=int, default=1)
    ps.add_argument("--process-id", type=int, default=0)
    ps.add_argument("--shard-carriers", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="scan a band as one batched scan_band, over every "
                         "visible card when there are several (default: "
                         "on the card; --no-shard-carriers forces the "
                         "serial per-carrier loop)")
    ps.add_argument("--shard-hypotheses",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="run a single-carrier (or serial) scan's front "
                         "end over a time-block grid of all visible "
                         "devices (default: on when more than one is "
                         "visible; --no-shard-hypotheses forces one)")
    ps.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    ps.set_defaults(func=cmd_search)
    _add_track_parser(sub)
    _add_check_parser(sub)
    args = p.parse_args(argv)
    if getattr(args, "load_files", None) is None:
        args.load_files = []
    try:
        return args.func(args)
    except FileNotFoundError as e:
        print(f"Error: file not found: {e.filename}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
