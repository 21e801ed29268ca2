"""Smoke run of the PyTorch/CUDA cell scanner on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from ``lte_cell_scanner_tpu_torch/csrc``
     with nvcc (sm_90a): ``cuda_build.build``, one nvcc per source (two
     sources, ``pss_corr.cu`` and ``pss_corr_fold.cu``, both including
     ``hankel_mma.cuh``), all started together with the g++ build of the
     tracker's native runtime (``io/native.py::build``: ``native/*.cpp``,
     ``csrc/cell_rows_tick.cpp`` and ``csrc/stage_tick.cpp`` into the
     port's ``build/``); the
     ptxas register and
     spill lines of the seven tensor-core kernel instances, keyed by trait
     and sink (the five ``map_tc_kernel`` instances: the maps bf16, int8,
     bf16_f32out, int8_scaled and the sum probe; the two of
     ``pss_corr_fold_kernel``; a missing instance or any spill fails), and
     the resident blocks per SM of the five ``map_tc_kernel`` instances
     (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
  3. kernel phase at full width for the v2 kernels (tensor-core mma.sync;
     T = 93 templates: +-100 ppm at 739 MHz; one 80 ms capture of 153600
     samples) on the main path's operands (taps packed once): each kernel
     against its plain PyTorch version on the same inputs (int8
     bit-equal, bf16 within one bf16 step + 1e-5 x max), then timed (CUDA
     events, median of 20 windows of 10 calls after warm-up) as the
     wrapper call and as the bare launch on capture words built once,
     beside its plain version and a library yardstick; its bound computed
     from this run's inputs, its useful TF/s (TOPS) and their share of the
     data-sheet peak (the share of this card's ruler follows at phase 9);
  3b. kernel phase at the same width for the correlation A/B path's
     kernels: pss_corr_f32 (v1/v2 with f32 bands) and
     pss_corr_bf16_f32out (v1 with bf16 bands, v3; tensor cores) on the
     float capture within 1e-5 x max of their plain versions,
     pss_corr_int8_scaled (the int8 probe; tensor cores) on the
     ADC-grid capture bit-equal, the sum probe pss_corr_sum_bf16 (tensor
     cores) within 1e-5 of the largest sum, and the per-chunk probe
     (pss_corr_bf16 once per 16 templates) bit-equal to one launch; each
     timed beside its plain version, a cuDNN conv1d yardstick (f32, TF32
     off, for the f32 kernel; bf16 otherwise) and its bound; the three
     tensor-core kernels also as the bare launch on capture words and
     taps packed once, with their useful TF/s (TOPS) and share of the
     data-sheet peak (of this card's ruler at phase 9); the sum probe's
     ptxas line, resident blocks per SM, grid and atomics per launch;
  4. single-carrier path: ``cell_search`` on a synthetic two-cell capture,
     once on the float capture (bf16 kernel) and once on the same capture
     quantized to the 8-bit ADC grid (int8 kernel); launch counts are
     zeroed just before and read just after each run; both cells must
     decode, and the cells must match the port's own float64 CPU run
     of the same capture; then s_per_carrier (median of 5 plain runs
     after a warm-up) and seconds by stage (median of 5 more runs, each
     stage synchronised);
  4b. file captures and search variants, launch counts zeroed just
     before and read just after each run (every count goes into the
     kernel records as ``file_launches``, apart from ``launches``): the
     two-cell capture written to a temporary directory as a raw rtl_sdr
     u8 file (the ADC-grid codes + 127) and as an .it file (the float
     capture); ``cli.main(["search", "-s", "739e6", "-p", "100",
     "--load-files", ...])`` on each: exactly one pss_corr_int8 launch
     (u8) or one pss_corr_bf16 launch (.it) and no other, cells 277 and
     271 with their MIB, ID, CP, SFN and ports equal to phase 4's run of
     the same capture; the u8 file with --noise-power (off the grid: one
     pss_corr_bf16); ``-r -d DIR --sim`` then ``-l -d DIR`` (the same
     table); --interp 2stage, --interp freq_time and --compat golden
     through the CLI and ``SearchConfig(batch_peaks=False)`` through
     ``cell_search`` on the float capture (the default run's ID, CP and
     SFN); a 160 ms capture through the coupled crystal channel at 60 kHz
     (``io/capture.py::SimSource``): cell 277 must decode, and the
     pss_corr_bf16 map it gives ([93, 307064]) is held against its plain
     version (within one bf16 step + 1e-5 x max; not counted), then its
     front-end seconds and the v2 map's lag count; ``bench_torch.py``'s ``main`` at small repeats
     (its JSON line, ``full_chain.valid`` true); one ``cell_search`` of a
     capture through ``sim/channel.py::multipath_channel``;
  5. one cell_search under torch.profiler: the device's busy share and
     the device operations that take the most time;
  5b. the correlation A/B path, launch counts zeroed just before and read
     just after each run: the v1 route of ``xcorr_core`` (one launch of
     pss_corr_bf16_f32out and nothing else; its strongest peak where the
     production route puts it), then ``tools_torch/bench_corr_v2.py``
     (the TPU tool's variants at full width and this card's tensor-core
     rulers, printed beside the data-sheet peaks) and
     ``tools_torch/bench_kernels.py`` (timings, then --parity-only), each
     line printed;
  6. kernel phase at full width for the fused v4 kernels (tensor-core
     mma.sync): C = 64 carriers (one chunk), T = 93, n_comb = 15, staged
     by the band scan's own planning from the first 64 carriers of
     ``band_captures`` (float band for bf16, ADC-grid band for int8; the
     host seconds of each staging step printed): each kernel against its
     plain version (int8 bit-equal, bf16 within 1e-5 x max), timed beside
     its plain version and a cuDNN bf16 conv1d yardstick over the
     64-carrier stack (the correlation only, without |.|^2 and the fold);
     its useful TF/s (TOPS), their share of the data-sheet peak and of
     this card's tensor-core ruler from phase 5b, and their ptxas register
     and spill lines;
  7. band-scan path: ``scan_band`` over the 101-carrier 10 MHz band
     (chunks of 64 + 37), float band and ADC-grid band; launch counts
     zeroed just before and read just after each run: exactly 2 launches
     of the route's v4 kernel and none of any other; cells 277 and 271
     with their MIB on 739.0, 744.0 and 749.0 MHz, freq_superfine within
     50 Hz of each carrier's simulated offset, nothing elsewhere, and
     each cell equal (ID, CP, SFN, ports) to the single-carrier
     ``cell_search`` of the same capture on the card; then seconds per
     band and carriers_per_s through MIB (median of 3 plain runs after a
     warm-up), and seconds by stage (staging, xcorr_pss, peak_search,
     sss_foe_fused, decode_fused, total; median of 3 more runs, each stage
     synchronised);
  8. one band scan under torch.profiler (float band): busy share and top
     device operations;
  9. the streaming tracker (``tracker/``) on the card, launch counts
     zeroed just before and read just after each run: the native runtime
     must be the one loaded (no numpy fallback); ``kalibrate`` at
     +-120 ppm on a coupled sim stream (pss_corr_bf16, T = 111) must find
     the simulated offset within 50 Hz; kalibrate's T = 111 maps (the
     +-120 ppm grid) on the float capture (bf16) and the ADC-grid capture
     (int8, a u8 stream's route) against their plain versions at 153600
     samples; the background searcher's T = 3
     maps (its one hypothesis) against their plain versions at 153600
     samples (int8 bit-equal, bf16 within one bf16 step + 1e-5 x max),
     timed with their bounds; ``tools_torch/bench_tracker.py``'s
     ``bench_one`` on 4 cells x 2 ports of ``CELL_PLAN`` (ADC-grid stream,
     +200 Hz, 12 dB: the searcher's pss_corr_int8, the warmup's
     pss_corr_bf16) with the searcher inline: every cell tracked, MIB
     synced, health > 99% and the offset register within 50 Hz of
     +200 Hz; its realtime factor, tick split and worst tick; the same
     samples with the asynchronous searcher (its own CUDA stream): the
     worst tick while a search is in flight; 1 cell's realtime factor;
     one device-loop tick (4 cells x 256 symbols) on the card against the
     port's float64 CPU program on the same inputs, from a block on the
     8-bit ADC grid (float16 planes) and from a Gaussian block (float64
     planes), both computed in complex128 (difference printed; beyond
     1e-9 x max fails); the 400 ms test stream of tests/test_tracker.py
     through the card's and the CPU's float64 device loops (frame timing,
     offset, health, MIB failures, each difference printed beside the
     TPU package's device-loop tolerance), end to end and with the card
     run's searcher on the CPU (the same acquisition seeds both offset
     registers): there frame timing or offset beyond the tolerance
     fails;
  9b. the rest of the user surface on the card, launch counts zeroed
     just before and read just after each run (the counts go into the
     kernel records as ``tools_launches``): ``cli.main(["check", ...])``
     on the two-cell capture as a u8 and an .it file (exit 0, cell 277's
     sync peaks every 10 ms, no drop; no kernel launched: the check
     correlates through ``ops/corr.py``) and on a copy with 500 samples
     cut out at 30 ms (exit 2, one drop of 500 +- 2 samples); ``search
     -s 739e6 -p 100`` with no source named, through a fake librtlsdr
     (``FakeDongle``) that serves the ADC-grid capture's u8 bytes after
     the 1.5 s AGC discard: exactly one pss_corr_int8 launch and the
     table of ``--load-files`` on the same bytes; ``track -f 739e6
     --no-tui --duration 1.5`` through a fake dongle paced at 1.92 Msps
     serving 2 s of one cell (277, +200 Hz, 12 dB, 8-bit grid): cell 277
     held (health > 99%, MIB synced), the reader filling the native ring
     (``io/native.py::SampleRing``) and dropping nothing;
     ``tools_torch/monte_carlo.py`` on the production path, bf16 and
     int8 (--adc-grid): 10 trials at -10 dB all successes without a
     false alarm and one launch per trial, 3 at -30 dB all
     thresh1_fail, then 25 trials at -14 and -12 dB printed beside
     docs/SENSITIVITY.md's golden-path rates (not gated); the benches
     ``tools_torch/bench_search.py``, ``bench_carriers.py`` (float and
     ADC-grid band, front end; float band through MIB) and
     ``bench_front_stages.py``, each JSON line printed with the card's
     name and power limit; the phase's seconds;
 10. the multi-device layouts on the one card (one-card runs of layouts
     made for several devices, not multi-card results), launch counts
     zeroed just before and read just after each run (the counts of
     10a-10d go into the kernel records as ``multidevice_launches``):
     10a two ``tools_torch/multihost_worker.py --band scenario`` ranks
     over gloo on localhost, both on this card (kernels built in phase 2,
     each rank only loads them; both killed if either fails or outlasts
     MH_TIMEOUT), scan phase 7's band split 51 + 50 (the CLI's strided
     split; the short rank pads), float and ADC-grid: both ranks' merged
     lists equal, equal to phase 7's deduplicated cells (ID, CP, SFN,
     ports, n_rb, fc exactly, frame_start within 1e-3 samples, pss_pow
     within 2e-2 relative), the same gathered route verdict (grid flag,
     v4 kv at margin 1) on both, and one launch of the route's v4 kernel
     per rank; their carriers_per_s beside phase 7's; 10b ``scan_band``
     over the device list [cuda:0, cuda:0] on the float band (one v4
     launch per block, phase 7's cells); 10c ``cell_search`` over a
     (4 x 1) grid of the card at T = 93 (4 pss_corr_bf16 launches of 93
     templates on 38400 + 280 samples each) and a (4 x 2) grid over 4
     hypotheses (8 launches of 6 templates): phase 4's cells; each
     grid's collapsed map within 1e-5 x max of the one-device front end
     and its argmax on >= 99.9% of lags, the f32 operands (4
     pss_corr_f32 launches) within 2e-5 x max of the exact route; the
     (4 x 1) grid's s_per_carrier beside one device's, in turns; 10d the
     tracker with its searcher over a (4 x 1) grid on the 400 ms stream
     of tests/test_tracker.py:485-500 (277 held, n_rb 6, health > 99%,
     offset register within 50 Hz of +300 Hz); 10e
     ``tools_torch/bench_kernels.py`` front_lean, sharded_1x1 and
     sharded_1x1_kernel; each step's seconds with the card's name and
     power limit;
 11. the public staged API on the card ("surface"), launch counts zeroed
     just before and read just after each run (the counts go into the
     kernel records as ``surface_launches``): 11a phase 4's peak lists
     (``cell_search`` of the float and the ADC-grid two-cell capture at
     T = 93: one pss_corr_bf16 or pss_corr_int8 launch) through
     ``sss_detect_batch`` -> ``pss_sss_foe_batch``, equal to the fused
     ``sss_foe_batch_fused`` that ``cell_search`` ran on the same peaks
     in n_id_1, CP and frame_start, freq_fine within SURFACE_FF_HZ (the
     gap printed); 11b the same for phase 7's two bands (``scan_band``:
     two v4 launches each) through ``sss_detect_batch_multi`` ->
     ``pss_sss_foe_batch_multi`` against ``sss_foe_batch_fused(
     carrier_idx=)``; 11c ``ce_interp_hex`` of each port on
     tests/vectors/test_tfg.it against the fused hex ``chan_est``, and
     ``pbch_extract`` against the CPU's, no kernel launched; 11d
     ``interpft`` of the sync template's bodies against
     ``interpft_host`` within SURFACE_REL x max; 11e
     ``tools_torch/bench_tracker.py``'s ``bench_one`` at 4 cells with the
     device loop off, serial and with ``parallel=4``, on phase 9's
     recorded stream: every cell held, the realtime factors printed with
     the card's name and power limit (no gate on speed); the phase's
     seconds;
 12. the five map_tc_kernel instances' useful rates against this card's
     rulers of phase 5b (bf16 matmul, bf16 matmul with f32 output for
     pss_corr_bf16_f32out, int8 _int_mm); one JSON line of kernel records
     (all nine: the four above and the five of the A/B path, whose
     launches are those of phase 5b; each with its ``file_launches`` of
     phase 4b, its ``tracker_launches`` of phase 9, its
     ``tools_launches`` of phase 9b, its ``multidevice_launches`` of
     phase 10 and its ``surface_launches`` of phase 11, rows 1-2 with
     their ``searcher_t3`` record), then the result line.

Exits non-zero, printing no result line, without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FC = 739e6
PPM = 100.0
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, int8 tensor cores,
# f32 on the CUDA cores (the f32 kernel's type: a TF32 tensor-core path
# would compute another function), HBM3 bandwidth
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
KERNEL_SOURCE = "lte_cell_scanner_tpu_torch/csrc/pss_corr.cu"
FOLD_SOURCE = "lte_cell_scanner_tpu_torch/csrc/pss_corr_fold.cu"
PALLAS = "lte_cell_scanner_tpu/ops/corr_pallas.py"
PROBES = "tools/bench_corr_v2.py"
REPLACES = {"bf16": f"{PALLAS}:407", "int8": f"{PALLAS}:416"}
# the A/B path's kernels: the TPU kernels (rows of PERF.md's table) each
# replaces
AB_REPLACES = {"pss_corr_f32": f"{PALLAS}:67",
               "pss_corr_bf16_f32out": f"{PALLAS}:67; {PALLAS}:429",
               "pss_corr_int8_scaled": f"{PROBES}:355",
               "pss_corr_sum_bf16": f"{PROBES}:205",
               "pss_corr_bf16_per_chunk": f"{PROBES}:302"}
BENCH_CORR_VARIANTS = "peak,v1,v2_128_16,v3_128_16,v3b_128_16,v2sum," \
    "v2s_128_16,v2i_128"
BENCH_REPEATS = "5"
FOLD_REPLACES = {"bf16": "lte_cell_scanner_tpu/ops/corr_pallas.py:774",
                 "int8": "lte_cell_scanner_tpu/ops/corr_pallas.py:792"}
CHUNK = 64                 # carriers per band-scan chunk (scan_band default)
UNIT = {"bf16": "TF/s", "int8": "TOPS"}
# the tensor-core kernel templates' instances: label -> the length-prefixed
# type names (trait, epilogue or sink) that its mangled name holds
MAP_TC = {"bf16": ("4Bf16", "7PowBf16"), "int8": ("4Int8", "7PowBf16"),
          "bf16_f32out": ("4Bf16", "6PowF32"),
          "int8_scaled": ("4Int8", "13ScaledPowBf16"),
          "sum": ("4Bf16", "12RowBlockSums")}
FOLD_TC = {"bf16": ("4Bf16",), "int8": ("4Int8",)}
BF16_RTOL = 2.0 ** -7      # one bf16 ulp relative to the value
BF16_ATOL_REL = 1e-5       # x the map's max, where Re/Im cancel


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_cuda(fn, reps: int = 20, per_rep: int = 10, warmup: int = 3
              ) -> float:
    """Median milliseconds of one fn() call: ``reps`` windows of
    ``per_rep`` back-to-back calls, one CUDA event pair per window, so the
    host's launch cost overlaps the device's work as in a pipeline."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return smi


def phase_build() -> dict:
    """Builds every source; returns nvcc's output (with ptxas' report) by
    source name."""
    from lte_cell_scanner_tpu_torch.cuda_build import SOURCES, build
    from lte_cell_scanner_tpu_torch.io import native
    t0 = time.perf_counter()
    # one nvcc per source and the native runtime's g++, all started
    # together
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        host = pool.submit(native.build)
        builds = list(zip(SOURCES, pool.map(build, SOURCES)))
        try:
            secs, _log = host.result()
        except RuntimeError as e:
            fail(f"native runtime build: {e}")
    print(f"built {native.LIB_PATH.name} (native runtime) in {secs:.2f} s")
    for name, (secs, log) in builds:
        print(f"built {name} in {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {line.strip()}")
    print(f"build phase: {time.perf_counter() - t0:.2f} s")
    return {name: log for name, (_secs, log) in builds}


def tc_ptxas(log: str, kernel: str, source: str, instances: dict) -> dict:
    """ptxas' register and spill lines of every instance of the
    tensor-core kernel template ``kernel`` in ``source``'s build log, by
    label: ``instances`` maps each label to the type names its mangled
    name holds, and each instance must match exactly one label.  Fails on
    an instance it cannot label, a label without an instance, and any
    spill."""
    lines = {}
    name = None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = None
            if f"{len(kernel)}{kernel}" in line:
                hits = [k for k, types in instances.items()
                        if all(t in line for t in types)]
                if len(hits) != 1:
                    fail(f"{source}: {kernel} instance matches {hits}: "
                         f"{line}")
                name = hits[0]
                if name in lines:
                    fail(f"{source}: two {kernel} instances for {name}")
                lines[name] = []
        elif name and ("registers" in line or "spill" in line):
            lines[name].append(line.replace("ptxas info    : ", ""))
            if "spill" in line and not (" 0 bytes spill stores" in line
                                        and " 0 bytes spill loads" in line):
                fail(f"{source} {kernel} ({name}) spills: {line}")
    if set(lines) != set(instances):
        fail(f"ptxas reports {kernel} instances {sorted(lines)}, expected "
             f"{sorted(instances)}")
    for k, v in lines.items():
        print(f"{kernel} {k}: {'; '.join(v)}")
    return {k: "; ".join(v) for k, v in lines.items()}


def kernel_operands(capbuf: np.ndarray, f_set: np.ndarray):
    """The capture and template operands the main path hands the
    kernel, built by the main path's own staging."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.xcorr import _front_staging
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    dev = torch.device("cuda")
    cap_t, _tmpl, _starts, kern, _n = _front_staging(
        capbuf, f_set, FC, FC, FS_WORK, "auto", dev, None, True)
    if kern.precision == "int8":
        cap_q = corr_cuda.capture_planes_int8(cap_t)
    else:
        cap_q = corr_cuda.capture_planes_bf16(cap_t)
    return kern, cap_q


def bound(precision: str, cap_q, taps, n_lags: int, out_bytes=None):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth (each
    input read once, the output written once: by default the bf16
    [T, n_lags] map) and the useful multiply-adds over the peak of the
    operand type."""
    n_t = taps.shape[1]
    if out_bytes is None:
        out_bytes = n_t * n_lags * 2
    in_bytes = cap_q.numel() * cap_q.element_size() \
        + taps.numel() * taps.element_size()
    ops = 2.0 * 4 * n_t * n_lags * taps.shape[2]
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    t_ops = ops / PEAK_OPS[precision]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(cap_q, taps, n_lags: int, dtype=torch.bfloat16):
    """One PyTorch call computing the same correlation (Re and Im, without
    the |.|^2 epilogue): conv1d of the [1, 2, N] planes with [2T, 2, 137]
    weights, in bf16 or f32 (cuDNN, TF32 off).  Used only as a
    yardstick."""
    x = cap_q.to(dtype)[None]
    t = taps.to(dtype)
    w = torch.cat([torch.stack([t[0], -t[1]], dim=1),
                   torch.stack([t[1], t[0]], dim=1)], dim=0).contiguous()

    def run():
        return torch.nn.functional.conv1d(x, w)[..., :n_lags]
    return run


def map_parity(precision: str, kern, cap_q, n_lags: int) -> float:
    """The v2 map kernel of ``precision`` on the main path's operands (the
    taps packed once by KernelOperands) against its plain version: int8
    bit for bit, bf16 within one bf16 step + 1e-5 x the map's max.
    Returns the largest |error|."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    wrapper = corr_cuda.corr_pow_int8 if precision == "int8" \
        else corr_cuda.corr_pow_bf16
    plain = corr_cuda.corr_pow_int8_plain if precision == "int8" \
        else corr_cuda.corr_pow_bf16_plain
    got = wrapper(cap_q, kern.taps, n_lags, packed=kern.packed)
    torch.cuda.synchronize()
    ref = plain(cap_q, kern.taps, n_lags)
    if got.shape != ref.shape or got.dtype != torch.bfloat16:
        fail(f"{precision} kernel: shape/dtype {tuple(got.shape)} "
             f"{got.dtype}")
    g = got.float()
    r = ref.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{precision} kernel: non-finite output")
    err = (g - r).abs()
    max_abs_err = float(err.max())
    if precision == "int8":
        n_diff = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
        print(f"int8 kernel vs plain: {n_diff} of {got.numel()} entries "
              f"differ (bit-equal required)")
        if n_diff:
            fail("int8 kernel disagrees with its plain version")
    else:
        tol = BF16_RTOL * torch.maximum(g.abs(), r.abs()) \
            + BF16_ATOL_REL * float(r.max())
        n_bad = int((err > tol).sum())
        n_diff = int((err > 0).sum())
        print(f"bf16 kernel vs plain: max |err| {max_abs_err:.3e} (map max "
              f"{float(r.max()):.3e}); {n_diff} entries differ, {n_bad} "
              f"beyond 1 bf16 ulp + 1e-5 x max")
        if n_bad:
            fail("bf16 kernel disagrees with its plain version")
    return max_abs_err


def check_kernel(precision: str, kern, cap_q, n_lags: int,
                 ptxas: str) -> dict:
    """The tensor-core map kernel of ``precision`` on the main path's
    operands against its plain version (map_parity), then timed: the
    wrapper (capture words built per call), the bare launch on words
    built once, the plain version and the library yardstick; its bound
    and useful rate."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    wrapper = corr_cuda.corr_pow_int8 if precision == "int8" \
        else corr_cuda.corr_pow_bf16
    plain = corr_cuda.corr_pow_int8_plain if precision == "int8" \
        else corr_cuda.corr_pow_bf16_plain
    name = f"pss_corr_{precision}"
    n_t = kern.taps.shape[1]
    max_abs_err = map_parity(precision, kern, cap_q, n_lags)
    ms = time_cuda(lambda: wrapper(cap_q, kern.taps, n_lags,
                                   packed=kern.packed))
    words = corr_cuda.capture_words(cap_q[None])[0]
    out = torch.empty((n_t, n_lags), dtype=torch.bfloat16, device="cuda")
    bare_ms = time_cuda(lambda: corr_cuda._launch_tc(
        name, words, kern.packed, out, n_t, n_lags))
    plain_ms = time_cuda(lambda: plain(cap_q, kern.taps, n_lags))
    library_ms = time_cuda(library_call(cap_q, kern.taps, n_lags))
    bound_ms, bound_by = bound(precision, cap_q, kern.taps, n_lags)
    print(f"{precision} kernel: wrapper {ms:.4f} ms, bare launch "
          f"{bare_ms:.4f} ms; plain {plain_ms:.4f} ms; library conv1d "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    print(f"{precision} kernel: ptxas {ptxas}")
    return {"name": name, "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[precision],
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            **tc_rates(name, precision, n_t, n_lags, ms, bare_ms)}


def tc_rates(name: str, precision: str, n_t: int, n_lags: int, ms: float,
             bare_ms: float) -> dict:
    """A tensor-core map kernel's useful TF/s (TOPS) as the wrapper call
    and as the bare launch, printed with their share of the data-sheet
    peak of the operand type (the share of this card's ruler follows at
    phase 9)."""
    ops = 8.0 * n_t * n_lags * 137
    useful = ops / (ms * 1e-3) / 1e12
    bare = ops / (bare_ms * 1e-3) / 1e12
    peak = PEAK_OPS[precision] / 1e12
    print(f"{name}: {useful:.1f} useful {UNIT[precision]} (wrapper), "
          f"{bare:.1f} (bare launch): {100.0 * useful / peak:.1f}% and "
          f"{100.0 * bare / peak:.1f}% of the data-sheet {peak:.0f}; shares "
          f"of this card's ruler at the end")
    return {"bare_ms": bare_ms, "useful_tflops": useful,
            "bare_useful_tflops": bare, "share_of_peak": useful / peak}


def ab_operands(cap_float, cap_adc, f_set):
    """The A/B path's operands at full width: the float capture as f32 and
    bf16 planes with the v1 route's f32 template planes and bf16 operands
    (KernelOperands: planes and packed taps), the ADC-grid capture as int8
    planes with int8 taps, the int8 probe's power scale and the taps
    packed once."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.xcorr import (pss_templates,
                                                         v1_operands)
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    dev = torch.device("cuda")
    tmpl = pss_templates(f_set, FC, FC, FS_WORK).reshape(-1, 137)
    cap_t = torch.from_numpy(cap_float.astype(np.complex64)).to(dev)
    cap_a = torch.from_numpy(cap_adc.astype(np.complex64)).to(dev)
    taps_i, _scale = corr_cuda.template_planes_int8(tmpl, dev)
    return {"f32": (corr_cuda.capture_planes_f32(cap_t),
                    v1_operands(tmpl, "f32", dev).taps),
            "bf16": (corr_cuda.capture_planes_bf16(cap_t),
                     v1_operands(tmpl, "bf16", dev)),
            "int8": (corr_cuda.capture_planes_int8(cap_a), taps_i,
                     corr_cuda.probe_inv(tmpl),
                     corr_cuda.pack_map_taps(taps_i))}


def check_ab_kernels(ops, n_lags: int, sum_ptxas: str) -> dict:
    """The A/B path's kernels against their plain versions at full width
    (f32 maps within 1e-5 x max, the scaled int8 map bit-equal, the sums
    within 1e-5 relative, the per-chunk map bit-equal to one launch), then
    timed beside their plain versions, a cuDNN conv1d yardstick (f32 for
    the f32 kernel, else bf16) and their bounds; the three tensor-core
    kernels also as the bare launch on words and packed taps made once,
    with their useful rates; the sum probe's ptxas line, occupancy, grid
    and atomics per launch."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda as cc
    cap_f, taps_f = ops["f32"]
    cap_b, v1 = ops["bf16"]
    taps_b = v1.taps
    cap_i, taps_i, inv, packed_i = ops["int8"]
    n_t = taps_b.shape[1]
    f32_map = n_t * n_lags * 4
    sums = 4 * int(np.prod(cc.sum_shape(n_t, n_lags)))
    # name: (kernel, plain version, reference of the check, check, library
    #        yardstick, bound)
    cases = {
        "pss_corr_f32": (
            lambda: cc.corr_pow_f32(cap_f, taps_f, n_lags),
            lambda: cc.corr_pow_f32_plain(cap_f, taps_f, n_lags), None,
            "max", library_call(cap_f, taps_f, n_lags, torch.float32),
            bound("f32", cap_f, taps_f, n_lags, f32_map)),
        "pss_corr_bf16_f32out": (
            lambda: cc.corr_pow_bf16(cap_b, taps_b, n_lags, torch.float32,
                                     v1.packed),
            lambda: cc.corr_pow_f32_plain(cap_b, taps_b, n_lags), None,
            "max", library_call(cap_b, taps_b, n_lags),
            bound("bf16", cap_b, taps_b, n_lags, f32_map)),
        "pss_corr_int8_scaled": (
            lambda: cc.corr_pow_int8_scaled(cap_i, taps_i, n_lags, inv,
                                            packed_i),
            lambda: cc.corr_pow_int8_scaled_plain(cap_i, taps_i, n_lags,
                                                  inv), None,
            "equal", library_call(cap_i, taps_i, n_lags),
            bound("int8", cap_i, taps_i, n_lags)),
        "pss_corr_sum_bf16": (
            lambda: cc.corr_pow_sum_bf16(cap_b, taps_b, n_lags, v1.packed),
            lambda: cc.corr_pow_sum_bf16_plain(cap_b, taps_b, n_lags), None,
            "relative", library_call(cap_b, taps_b, n_lags),
            bound("bf16", cap_b, taps_b, n_lags, sums)),
        "pss_corr_bf16_per_chunk": (
            lambda: cc.corr_pow_bf16_per_chunk(cap_b, taps_b, n_lags),
            lambda: cc.corr_pow_bf16_plain(cap_b, taps_b, n_lags),
            lambda: cc.corr_pow_bf16(cap_b, taps_b, n_lags),
            "equal", library_call(cap_b, taps_b, n_lags),
            bound("bf16", cap_b, taps_b, n_lags)),
    }
    # the tensor-core kernels' bare launches: (launch, operand type)
    words_b = cc.capture_words(cap_b[None])[0]
    words_i = cc.capture_words(cap_i[None])[0]
    out_f = torch.empty((n_t, n_lags), dtype=torch.float32, device="cuda")
    out_b = torch.empty((n_t, n_lags), dtype=torch.bfloat16, device="cuda")
    # the sum probe walks whole row blocks; the bare launches add into one
    # buffer, zeroed once
    sum_lags = cc.sum_shape(n_t, n_lags)[0] * cc.SUM_BLOCK_LAGS
    out_s = torch.zeros(cc.sum_shape(n_t, n_lags), dtype=torch.float32,
                        device="cuda")
    bare = {
        "pss_corr_bf16_f32out": (lambda: cc._launch_tc(
            "pss_corr_bf16_f32out", words_b, v1.packed, out_f, n_t, n_lags),
            "bf16"),
        "pss_corr_int8_scaled": (lambda: cc._launch_tc(
            "pss_corr_int8_scaled", words_i, packed_i, out_b, n_t, n_lags,
            float(inv)), "int8"),
        "pss_corr_sum_bf16": (lambda: cc._launch_tc(
            "pss_corr_sum_bf16", words_b, v1.packed, out_s, n_t, sum_lags),
            "bf16"),
    }
    records = {}
    for name, (kernel, plain, ref_fn, check, library, (bound_ms, by)) \
            in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        ref = (ref_fn or plain)()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            fail(f"{name}: shape/dtype {tuple(got.shape)} {got.dtype}, "
                 f"expected {tuple(ref.shape)} {ref.dtype}")
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"{name}: non-finite output")
        err = (got.float() - ref.float()).abs()
        max_abs_err = float(err.max())
        scale = float(ref.float().abs().max())
        if check == "equal":
            n_diff = int((got.view(torch.int16) != ref.view(torch.int16))
                         .sum())
            what = "one launch" if ref_fn else "plain"
            print(f"{name} vs {what}: {n_diff} of {got.numel()} entries "
                  f"differ (bit-equal required)")
            if n_diff:
                fail(f"{name} is not bit-equal to {what}")
        else:
            print(f"{name} vs plain: max |err| {max_abs_err:.3e}, "
                  f"{max_abs_err / scale:.3e} of the max {scale:.3e} "
                  f"({'relative' if check == 'relative' else 'x max'} "
                  f"bar 1e-5)")
            if max_abs_err > 1e-5 * scale:
                fail(f"{name} disagrees with its plain version")
        del got, ref, err
        ms = time_cuda(kernel)
        plain_ms = time_cuda(plain, reps=5, per_rep=2, warmup=1)
        library_ms = time_cuda(library)
        print(f"{name}: {ms:.4f} ms; plain {plain_ms:.4f} ms; library "
              f"conv1d {library_ms:.4f} ms; bound {bound_ms:.4f} ms ({by})")
        records[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": AB_REPLACES[name], "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}
        if name in bare:
            launch, precision = bare[name]
            bare_ms = time_cuda(launch)
            print(f"{name}: bare launch {bare_ms:.4f} ms, "
                  f"{bare_ms / bound_ms:.1f}x its bound; wrapper "
                  f"{ms / bound_ms:.1f}x")
            records[name].update(tc_rates(name, precision, n_t, n_lags, ms,
                                          bare_ms))
    grid = cc.map_tc_grid("pss_corr_sum_bf16", n_t, sum_lags)
    print(f"pss_corr_sum_bf16: ptxas {sum_ptxas}; "
          f"{cc.map_tc_blocks_per_sm()['pss_corr_sum_bf16']} resident "
          f"blocks per SM; grid {grid[0]} x {grid[1]} over {sum_lags} lags; "
          f"{cc.sum_atomics(n_t, sum_lags, grid[0])} atomics per launch "
          f"into {int(np.prod(cc.sum_shape(n_t, n_lags)))} sums")
    return records


def read_launches(label: str, expect) -> dict:
    """The launch counts since the last reset: every kernel in ``expect``
    launched, and no other."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    torch.cuda.synchronize()
    launched = {k: v for k, v in corr_cuda.LAUNCHES.items() if v}
    print(f"{label}: launches {launched}")
    if set(launched) != set(expect):
        fail(f"{label}: launched {sorted(launched)}, expected "
             f"{sorted(expect)}")
    return launched


def run_ab_path(cap_float, f_set, counts: dict) -> None:
    """The v1 route of the front end: ``xcorr_core`` with v1 bf16 operands
    on the float capture launches one pss_corr_bf16_f32out and nothing
    else, and puts the strongest peak where the production v2 route puts
    it, within 2e-2 x max (tests/test_xcorr.py:195) on the collapsed
    powers."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.xcorr import (_front_staging,
                                                         v1_operands,
                                                         xcorr_core)
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    dev = torch.device("cuda")
    cap_t, tmpl, starts, kern, _n = _front_staging(
        cap_float, f_set, FC, FC, FS_WORK, "auto", dev, None, True)
    v1 = v1_operands(tmpl.reshape(-1, 137).cpu().numpy(), "bf16", dev)
    corr_cuda.reset_launch_counts()
    got = xcorr_core(cap_t, None, starts, 2, False, True, v1)
    launched = read_launches("xcorr_core, v1 route",
                             {"pss_corr_bf16_f32out"})
    if launched["pss_corr_bf16_f32out"] != 1:
        fail("the v1 route launched pss_corr_bf16_f32out more than once")
    want = xcorr_core(cap_t, None, starts, 2, False, True, kern)
    peak_got, peak_want = int(got[2].argmax()), int(want[2].argmax())
    dev_rel = float((got[2] - want[2]).abs().max() / want[2].max())
    print(f"xcorr_core v1 vs v2 route: strongest peak (pss, lag) "
          f"{divmod(peak_got, 9600)} vs {divmod(peak_want, 9600)}, "
          f"collapsed powers within {dev_rel:.3e} of the max")
    if peak_got != peak_want or dev_rel > 2e-2:
        fail("the v1 route disagrees with the production route")
    for k, v in launched.items():
        counts[k] = counts.get(k, 0) + v


def run_captured(main, argv):
    """main(argv) with its standard output captured; (rc, output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def run_tool(label: str, main, argv) -> dict:
    """One run of a tools_torch bench's main(argv) on the card: its JSON
    line echoed and parsed; fails unless it exits 0."""
    rc, out = run_captured(main, argv)
    out = out.strip()
    print(f"{label}: {out}")
    if rc != 0:
        fail(f"{label} exited {rc}")
    return json.loads(out.splitlines()[-1])


def phase_benches(counts: dict) -> dict:
    """The kernel benches at full width, launch counts zeroed before and
    read after each: bench_corr_v2 (the TPU tool's variants and the
    card's tensor-core rulers, returned: TF/s bf16, TOPS int8),
    bench_kernels (timing, then parity)."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from tools_torch import bench_corr_v2, bench_kernels

    corr_cuda.reset_launch_counts()
    res = run_tool("bench_corr_v2", bench_corr_v2.main, [
        "--variants", BENCH_CORR_VARIANTS, "--repeats", BENCH_REPEATS])
    runs = [read_launches("bench_corr_v2", {
        "pss_corr_bf16", "pss_corr_bf16_f32out", "pss_corr_sum_bf16",
        "pss_corr_bf16_per_chunk", "pss_corr_int8_scaled"})]
    for key, peak in (("peak_bf16_tflops", "bf16"),
                      ("peak_bf16_f32out_tflops", "bf16"),
                      ("peak_int8_tops", "int8")):
        print(f"tensor-core ruler {key}: {res[key]:.1f} measured, data "
              f"sheet {PEAK_OPS[peak] / 1e12:.0f}")
    corr_cuda.reset_launch_counts()
    run_tool("bench_kernels", bench_kernels.main,
             ["--repeats", BENCH_REPEATS])
    runs.append(read_launches("bench_kernels", {
        "pss_corr_bf16", "pss_corr_bf16_f32out", "pss_corr_f32"}))
    corr_cuda.reset_launch_counts()
    run_tool("bench_kernels --parity-only", bench_kernels.main,
             ["--parity-only"])
    runs.append(read_launches("bench_kernels --parity-only", {
        "pss_corr_bf16", "pss_corr_bf16_f32out", "pss_corr_f32"}))
    for launched in runs:
        for k, v in launched.items():
            counts[k] = counts.get(k, 0) + v
    return {"bf16": res["peak_bf16_tflops"],
            "bf16_f32out": res["peak_bf16_f32out_tflops"],
            "int8": res["peak_int8_tops"]}


def expect_cells(cells, label: str) -> None:
    from lte_cell_scanner_tpu_torch.sim.scenarios import TWO_CELL_TRUTH
    ids = sorted(c.n_id_cell() for c in cells)
    if ids != sorted(TWO_CELL_TRUTH):
        fail(f"{label}: decoded cells {ids}, expected "
             f"{sorted(TWO_CELL_TRUTH)}")
    for c in cells:
        truth = TWO_CELL_TRUTH[c.n_id_cell()]
        if (c.n_rb_dl != 6 or c.n_ports != truth["n_ports"]
                or c.sfn not in (truth["sfn"], truth["sfn"] + 1)):
            fail(f"{label}: wrong MIB for {c}")
        if not abs(c.freq_superfine - 35e3) < 50.0:
            fail(f"{label}: freq_superfine {c.freq_superfine} for {c}")


def run_main_path(label: str, capbuf, f_set, precision: str, counts: dict):
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import cell_search
    from lte_cell_scanner_tpu_torch.ops import corr_cuda

    corr_cuda.reset_launch_counts()
    cells = cell_search(capbuf, f_set, FC, FC, FS_WORK, device="cuda")
    torch.cuda.synchronize()
    launched = dict(corr_cuda.LAUNCHES)
    print(f"{label}: launches {launched}")
    name = f"pss_corr_{precision}"
    if launched[name] < 1:
        fail(f"{label}: the main path never launched {name}")
    if sum(launched.values()) != launched[name]:
        fail(f"{label}: the main path launched another kernel: {launched}")
    counts[name] = launched[name]
    for c in cells:
        print(f"  {c}")
    expect_cells(cells, label)

    ref = cell_search(capbuf, f_set, FC, FC, FS_WORK, device="cpu")
    expect_cells(ref, f"{label} (float64 CPU run)")
    by_id = {c.n_id_cell(): c for c in ref}
    for c in cells:
        r = by_id[c.n_id_cell()]
        print(f"  cell {c.n_id_cell()}: vs float64 CPU run "
              f"d(freq_fine) {c.freq_fine - r.freq_fine:+.4f} Hz, "
              f"d(freq_superfine) {c.freq_superfine - r.freq_superfine:+.4f}"
              f" Hz, d(frame_start) {c.frame_start - r.frame_start:+.4f}")
        if (c.n_id_1, c.cp_type, c.sfn, c.n_ports) != \
                (r.n_id_1, r.cp_type, r.sfn, r.n_ports):
            fail(f"{label}: cell {c.n_id_cell()} differs from the float64 "
                 f"CPU run: {c} vs {r}")

    totals, stages = timed_runs(lambda timings: cell_search(
        capbuf, f_set, FC, FC, FS_WORK, device="cuda", timings=timings), 5)
    print(f"{label}: s_per_carrier {statistics.median(totals):.5f} (median "
          f"of 5 after a warm-up; " + ", ".join(f"{t:.5f}" for t in totals)
          + ")")
    print(f"{label}: seconds per carrier by stage (median of 5 more, each "
          f"stage synchronised): " + ", ".join(
              f"{k} {v:.5f}" for k, v in stages.items()))
    print(f"{label}: pss_scan_samples_per_sec "
          f"{capbuf.shape[0] / stages['xcorr_pss']:.1f}")
    return cells


def run_cli(label: str, argv, expect: dict, file_counts: dict):
    """cli.main(argv) on the card, its standard output captured and
    echoed; launch counts zeroed before and read after, exactly
    ``expect`` (kernel: launches).  Returns ({cell ID: (CP, ports, SFN,
    n_rb)} from its "Detected a cell!" lines, the printed table)."""
    import contextlib
    import io
    import re
    from lte_cell_scanner_tpu_torch import cli
    from lte_cell_scanner_tpu_torch.ops import corr_cuda

    corr_cuda.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    launched = read_launches(label, set(expect))
    if rc != 0:
        print(out)
        fail(f"{label}: cli exited {rc}")
    if launched != expect:
        fail(f"{label}: launched {launched}, expected {expect}")
    for k, v in launched.items():
        file_counts[k] = file_counts.get(k, 0) + v
    lines = out.splitlines()
    table = lines[next(i for i, ln in enumerate(lines)
                       if ln.startswith("Detected the following")):]
    print(f"{label}: {secs:.3f} s; " + " | ".join(table[3:]))
    cells = {int(m[1]): (m[2], int(m[3]), int(m[4]), int(m[5]))
             for m in re.finditer(
                 r"Detected a cell! Cell\(cellID=(\d+) .*?cp=(\w+) .*?"
                 r"nRB=(\d+) ports=(\d+) .*?sfn=(\d+)\)", out)}
    cells = {k: (cp, ports, sfn, n_rb)
             for k, (cp, n_rb, ports, sfn) in cells.items()}
    return cells, table


def cell_key(cells) -> dict:
    return {c.n_id_cell(): (c.cp_type.value, c.n_ports, c.sfn, c.n_rb_dl)
            for c in cells}


def expect_same(label: str, got: dict, want: dict, fields: int = 4) -> None:
    """The decoded cells (ID -> CP, ports, SFN, n_rb) of a run against
    another run's, on the first ``fields`` fields."""
    from lte_cell_scanner_tpu_torch.sim.scenarios import TWO_CELL_TRUTH
    if sorted(got) != sorted(TWO_CELL_TRUTH):
        fail(f"{label}: decoded cells {sorted(got)}")
    for k in got:
        if got[k][:fields] != want[k][:fields] or got[k][3] != 6:
            fail(f"{label}: cell {k} {got[k]}, expected {want[k]}")


def run_search(label: str, capbuf, f_set, expect: dict, file_counts: dict,
               config=None, timings=None):
    """cell_search on the card with launch counts zeroed before and read
    after (exactly ``expect``)."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import cell_search
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    corr_cuda.reset_launch_counts()
    cells = cell_search(capbuf, f_set, FC, FC, FS_WORK, config,
                        device="cuda", timings=timings)
    launched = read_launches(label, set(expect))
    if launched != expect:
        fail(f"{label}: launched {launched}, expected {expect}")
    for k, v in launched.items():
        file_counts[k] = file_counts.get(k, 0) + v
    for c in cells:
        print(f"  {c}")
    return cells


def phase_files(cap_float, cap_adc, f_set, float_cells, adc_cells,
                file_counts: dict) -> None:
    """Phase 4b: file captures and search variants (see the docstring)."""
    import contextlib
    import io
    import os
    import tempfile
    from lte_cell_scanner_tpu_torch.io.capture import SimSource
    from lte_cell_scanner_tpu_torch.models.search import SearchConfig
    from lte_cell_scanner_tpu_torch.sim import (awgn, create_dl_sig,
                                                multipath_channel)
    from lte_cell_scanner_tpu_torch.cell import CpType
    from lte_cell_scanner_tpu_torch.utils.itfile import write_itfile
    from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8
    import bench_torch

    t_phase = time.perf_counter()
    want_adc = cell_key(adc_cells)
    want_float = cell_key(float_cells)
    bf16 = {"pss_corr_bf16": 1}
    with tempfile.TemporaryDirectory() as tmp:
        u8 = os.path.join(tmp, "cap.u8")
        it = os.path.join(tmp, "cap.it")
        complex_to_iq_u8(cap_adc).tofile(u8)
        write_itfile(it, {"capbuf": cap_float,
                          "fc": np.array([int(FC)], dtype=np.int32)})
        print(f"files: {u8} ({os.path.getsize(u8)} bytes), {it} "
              f"({os.path.getsize(it)} bytes)")
        base = ["search", "-s", "739e6", "-p", "100"]
        got, _ = run_cli("u8 file", base + ["--load-files", u8],
                         {"pss_corr_int8": 1}, file_counts)
        expect_same("u8 file", got, want_adc)
        from lte_cell_scanner_tpu_torch.constants import FS_WORK
        from lte_cell_scanner_tpu_torch.io.capture import FileSource
        from lte_cell_scanner_tpu_torch.models.search import cell_search
        totals, _st = timed_runs(lambda timings: cell_search(
            FileSource([u8]).capture(FC)[0], f_set, FC, FC, FS_WORK,
            device="cuda", timings=timings), 5)
        print(f"u8 file: s_per_carrier {statistics.median(totals):.5f} "
              f"(file read and cell_search, median of 5 after a warm-up; "
              + ", ".join(f"{t:.5f}" for t in totals) + ")")
        got, _ = run_cli(".it file", base + ["--load-files", it], bf16,
                         file_counts)
        expect_same(".it file", got, want_float)
        got, _ = run_cli("u8 file --noise-power 1e-4",
                         base + ["--load-files", u8, "--noise-power",
                                 "1e-4"], bf16, file_counts)
        expect_same("u8 file --noise-power", got, want_adc, 1)
        rec_dir = os.path.join(tmp, "rec")
        os.mkdir(rec_dir)
        _c, rec = run_cli("--sim -r", base + ["--sim", "-r", "-d", rec_dir],
                          bf16, file_counts)
        if os.listdir(rec_dir) != ["capbuf_0000.it"]:
            fail(f"record: {os.listdir(rec_dir)}")
        _c, rep = run_cli("-l replay", base + ["-l", "-d", rec_dir], bf16,
                          file_counts)
        if rep != rec or not rec[3].startswith("277 2 "):
            fail(f"replay printed {rep}, the recording {rec}")
        for flags in (["--interp", "2stage"], ["--interp", "freq_time"],
                      ["--compat", "golden"]):
            label = "variant " + " ".join(flags)
            got, _ = run_cli(label, base + ["--load-files", it] + flags,
                             bf16, file_counts)
            expect_same(label, got, want_float, 3)
    cells = run_search("batch_peaks=False", cap_float, f_set, bf16,
                       file_counts, SearchConfig(batch_peaks=False))
    expect_same("batch_peaks=False", cell_key(cells), want_float, 3)

    # a 160 ms capture through the coupled crystal channel at 60 kHz
    long_cap, _ = SimSource(coupled_fc=FC, freq_offset=60e3,
                            capture_ms=160).capture(FC)
    cells = run_search("160 ms coupled capture", long_cap, f_set, bf16,
                       file_counts)
    best = {c.n_id_cell(): c for c in cells}.get(277)
    if best is None or best.n_rb_dl != 6 or abs(best.freq_fine - 60e3) > 50:
        fail(f"160 ms capture: cell 277 not decoded at 60 kHz: {cells}")
    # the v2 map at this width against its plain version (not counted)
    kern, cap_q = kernel_operands(long_cap, f_set)
    if kern.precision != "bf16":
        fail(f"160 ms capture: staging picked {kern.precision}")
    n_lags = len(long_cap) - 136
    err = map_parity("bf16", kern, cap_q, n_lags)
    print(f"160 ms capture: pss_corr_bf16 [{kern.taps.shape[1]}, {n_lags}] "
          f"vs plain: max |err| {err:.3e}")
    del kern, cap_q
    torch.cuda.empty_cache()
    timings = {}
    run_search("160 ms coupled capture (timed)", long_cap, f_set, bf16,
               file_counts, timings=timings)
    print(f"160 ms capture: front end (xcorr_pss) {timings['xcorr_pss']:.5f}"
          f" s over the v2 map [{3 * len(f_set)}, {n_lags}] bf16 "
          f"({3 * len(f_set) * n_lags * 2 / 1e6:.1f} MB), n_comb_xc "
          f"{(n_lags - 100) // 9600}; stages " + ", ".join(
              f"{k} {v:.5f}" for k, v in timings.items()))

    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    corr_cuda.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main(["--rounds", "3", "--iters", "3", "--runs",
                               "3"])
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"bench_torch: {line}")
    launched = read_launches("bench_torch", {"pss_corr_fold_bf16",
                                             "pss_corr_bf16"})
    for k, v in launched.items():
        file_counts[k] = file_counts.get(k, 0) + v
    res = json.loads(line)
    if rc != 0 or not res["full_chain"]["valid"]:
        fail("bench_torch: full_chain.valid is not true")

    rng = np.random.default_rng(17)
    sig = create_dl_sig(CpType.NORMAL, 80, 0, 92, 1, 0.5, rng=rng,
                        n_ports=2, sfn=40)
    sig = awgn(multipath_channel(sig, n_taps=4, delay_spread=1.5, rng=rng),
               5.0, rng=rng)
    cells = run_search("multipath capture", sig, f_set, bf16, file_counts)
    best = max(cells, key=lambda c: c.pss_pow) if cells else None
    if best is None or (best.n_id_cell(), best.n_rb_dl, best.n_ports) != \
            (277, 6, 2) or best.sfn not in (40, 41):
        fail(f"multipath capture: {cells}")
    print(f"phase 4b: {time.perf_counter() - t_phase:.2f} s; launches "
          f"{file_counts}")


def timed_runs(run, n: int):
    """(totals, stages) of ``run(timings)``: after one warm-up, the wall
    seconds of n runs without stage timings, synchronised at both ends
    (the end-to-end metric), then the median per-stage seconds of n runs
    with them (each stage synchronises the card at both ends, so these
    runs are slower and give only the breakdown)."""
    run(None)
    totals = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(None)
        torch.cuda.synchronize()
        totals.append(time.perf_counter() - t0)
    runs = []
    for _ in range(n):
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(timings)
        torch.cuda.synchronize()
        timings["total"] = time.perf_counter() - t0
        runs.append(timings)
    return totals, {k: statistics.median(r[k] for r in runs)
                    for k in runs[0]}


def phase_profile(label: str, run) -> None:
    """One run() under torch.profiler: the device's busy share of the
    run's wall time and the device operations that take the most of it.
    The profiler's own cost lengthens the wall time, so the share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        print("profiled run: no device events; device busy share not "
              "measured")
        return
    busy = sum(e.device_time_total for e in ops) / 1e6
    by_name = {}
    for e in ops:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    print(f"profiled {label}: wall {wall:.5f} s, device busy "
          f"{busy:.5f} s ({100.0 * busy / wall:.1f}%), {len(ops)} device "
          f"operations")
    for name, (n, t) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:10]:
        print(f"  {t / 1e3:9.3f} ms {n:5d}x  {name[:100]}")


def band_operands(band, f_set):
    """The first chunk of the band as the band scan stages it: its route
    (precision, mid-carrier template planes, mid start table) and the
    quantized [C, 2, n] capture planes the fused kernel reads.  Prints
    the host seconds of each staging step (one run, synchronised)."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.device import to_capture
    from lte_cell_scanner_tpu_torch.models.search import SearchConfig
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.parallel.carriers import (
        _plan_scan_bands, plan_carrier_inputs)
    dev = torch.device("cuda")
    caps = [c for c, _, _ in band[:CHUNK]]
    fcs = [fc for _, fc, _ in band[:CHUNK]]
    t0 = time.perf_counter()
    cap, tmpl, starts, _n, _c = plan_carrier_inputs(caps, fcs, f_set, fcs,
                                                    FS_WORK)
    t1 = time.perf_counter()
    route = _plan_scan_bands(tmpl, starts, caps, SearchConfig(), dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if route.mid_starts is None:
        fail("band staging did not pick the fused v4 route")
    cap_t = to_capture(cap, dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"staging of {len(caps)} carriers ({route.kern.precision}): "
          f"stack and plans {t1 - t0:.5f} s, route (grid check, operands) "
          f"{t2 - t1:.5f} s, upload {t3 - t2:.5f} s")
    if route.kern.precision == "int8":
        return route, corr_cuda.capture_planes_int8(cap_t)
    return route, corr_cuda.capture_planes_bf16(cap_t)


def fold_ops(planes, taps, starts) -> float:
    """Useful operations of one fused launch: 8 per tap, template,
    fold-output lag, period and carrier (one complex multiply-add is 4
    real ones)."""
    return 8.0 * planes.shape[0] * taps.shape[1] * 9600 * starts.shape[1] \
        * taps.shape[2]


def fold_bound(precision: str, planes, taps, starts):
    """(bound_ms, bound_by) of one fused launch: the useful operations
    over the tensor-core peak of the operand type, against the inputs read
    once and the f32 output written once over HBM bandwidth."""
    n_c = planes.shape[0]
    n_t = taps.shape[1]
    ops = fold_ops(planes, taps, starts)
    in_bytes = sum(x.numel() * x.element_size()
                   for x in (planes, taps, starts))
    out_bytes = n_c * n_t * 9600 * 4
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    t_ops = ops / PEAK_OPS[precision]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fold_library_call(planes, taps):
    """The correlation only (Re and Im of every lag, without |.|^2 and
    the fold) of the whole [C, 2, n] stack as one cuDNN bf16 conv1d with
    [2T, 2, 137] weights: the nearest single PyTorch call, a yardstick."""
    x = planes.to(torch.bfloat16)
    t = taps.to(torch.bfloat16)
    w = torch.cat([torch.stack([t[0], -t[1]], dim=1),
                   torch.stack([t[1], t[0]], dim=1)], dim=0).contiguous()
    return lambda: torch.nn.functional.conv1d(x, w)


def check_fold_kernel(precision: str, route, planes, ruler: float,
                      ptxas: str) -> dict:
    from lte_cell_scanner_tpu_torch.ops import corr_fold_cuda
    wrapper = corr_fold_cuda.corr_fold_int8 if precision == "int8" \
        else corr_fold_cuda.corr_fold_bf16
    plain = corr_fold_cuda.corr_fold_int8_plain if precision == "int8" \
        else corr_fold_cuda.corr_fold_bf16_plain
    taps, starts = route.kern.taps, route.mid_starts
    got = wrapper(planes, taps, starts)
    torch.cuda.synchronize()
    ref = plain(planes, taps, starts)
    shape = (planes.shape[0], taps.shape[1], 9600)
    if tuple(got.shape) != shape or got.dtype != torch.float32:
        fail(f"v4 {precision} kernel: shape/dtype {tuple(got.shape)} "
             f"{got.dtype}")
    if not bool(torch.isfinite(got).all()):
        fail(f"v4 {precision} kernel: non-finite output")
    err = (got - ref).abs()
    max_abs_err = float(err.max())
    ref_max = float(ref.max())
    print(f"v4 {precision} kernel vs plain at C = {shape[0]}, T = "
          f"{shape[1]}, n_comb = {starts.shape[1]}: max |err| "
          f"{max_abs_err:.3e} (map max {ref_max:.3e}), "
          f"{int((err > 0).sum())} of {got.numel()} entries differ")
    if precision == "int8":
        if max_abs_err != 0.0:
            fail("v4 int8 kernel is not bit-equal to its plain version")
    elif max_abs_err > 1e-5 * ref_max:
        fail("v4 bf16 kernel disagrees with its plain version beyond "
             "1e-5 x max")
    del got, ref, err

    ms = time_cuda(lambda: wrapper(planes, taps, starts), reps=10,
                   per_rep=5, warmup=2)
    plain_ms = time_cuda(lambda: plain(planes, taps, starts), reps=3,
                         per_rep=1, warmup=1)
    library_ms = time_cuda(fold_library_call(planes, taps), reps=3,
                           per_rep=2, warmup=1)
    bound_ms, bound_by = fold_bound(precision, planes, taps, starts)
    print(f"v4 {precision} kernel: {ms:.4f} ms per {shape[0]}-carrier "
          f"launch ({ms / shape[0]:.4f} ms per carrier); plain "
          f"{plain_ms:.4f} ms; library conv1d (correlation only) "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    useful = fold_ops(planes, taps, starts) / (ms * 1e-3) / 1e12
    peak = PEAK_OPS[precision] / 1e12
    print(f"v4 {precision} kernel: {useful:.1f} useful {UNIT[precision]}, "
          f"{100.0 * useful / peak:.1f}% of the data-sheet {peak:.0f}, "
          f"{100.0 * useful / ruler:.1f}% of this card's ruler "
          f"{ruler:.1f} (bench_corr_v2 peak)")
    print(f"v4 {precision} kernel: ptxas {ptxas}")
    return {"name": f"pss_corr_fold_{precision}", "route": "cuda",
            "source": FOLD_SOURCE, "replaces": FOLD_REPLACES[precision],
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "useful_tflops": useful,
            "share_of_peak": useful / peak, "share_of_ruler": useful / ruler}


def expect_band(cell_lists, band, label: str) -> None:
    from lte_cell_scanner_tpu_torch.sim.scenarios import (
        BAND_CELL_CARRIERS, TWO_CELL_TRUTH, band_offset)
    if len(cell_lists) != len(band):
        fail(f"{label}: {len(cell_lists)} cell lists for {len(band)} "
             f"carriers")
    for k, (cells, (_c, fc, _p)) in enumerate(zip(cell_lists, band)):
        if k not in BAND_CELL_CARRIERS:
            if cells:
                fail(f"{label}: cells on the noise carrier {fc / 1e6:.1f} "
                     f"MHz: {cells}")
            continue
        ids = sorted(c.n_id_cell() for c in cells)
        if ids != sorted(TWO_CELL_TRUTH):
            fail(f"{label}: {fc / 1e6:.1f} MHz decoded {ids}")
        for c in cells:
            truth = TWO_CELL_TRUTH[c.n_id_cell()]
            if (c.n_rb_dl != 6 or c.n_ports != truth["n_ports"]
                    or c.sfn not in (truth["sfn"], truth["sfn"] + 1)):
                fail(f"{label}: wrong MIB for {c}")
            off = c.freq_superfine - band_offset(fc)
            print(f"  {fc / 1e6:.1f} MHz cell {c.n_id_cell()}: n_rb "
                  f"{c.n_rb_dl}, ports {c.n_ports}, SFN {c.sfn}, "
                  f"freq_superfine - offset {off:+.3f} Hz")
            if not abs(off) < 50.0:
                fail(f"{label}: freq_superfine {c.freq_superfine} for "
                     f"{c}")


def run_band_path(label: str, band, f_set, precision: str,
                  counts: dict) -> None:
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import cell_search
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.parallel.carriers import scan_band
    from lte_cell_scanner_tpu_torch.sim.scenarios import BAND_CELL_CARRIERS

    corr_cuda.reset_launch_counts()
    cell_lists = scan_band(band, f_set, FS_WORK, device="cuda",
                           max_carriers_per_program=CHUNK)
    torch.cuda.synchronize()
    launched = dict(corr_cuda.LAUNCHES)
    print(f"{label}: launches {launched}")
    name = f"pss_corr_fold_{precision}"
    n_chunks = -(-len(band) // CHUNK)
    if launched[name] != n_chunks:
        fail(f"{label}: {launched[name]} launches of {name}, expected "
             f"{n_chunks}")
    if sum(launched.values()) != launched[name]:
        fail(f"{label}: the band scan launched another kernel: {launched}")
    counts[name] = launched[name]
    expect_band(cell_lists, band, label)

    for k in BAND_CELL_CARRIERS:
        cap, fc, fcp = band[k]
        ref = {c.n_id_cell(): c for c in cell_search(
            cap, f_set, fc, fcp, FS_WORK, device="cuda")}
        for c in cell_lists[k]:
            r = ref.get(c.n_id_cell())
            if r is None or (c.n_id_1, c.cp_type, c.sfn, c.n_ports) != \
                    (r.n_id_1, r.cp_type, r.sfn, r.n_ports):
                fail(f"{label}: {fc / 1e6:.1f} MHz cell {c} differs from "
                     f"the single-carrier search {r}")
            print(f"  {fc / 1e6:.1f} MHz cell {c.n_id_cell()}: vs "
                  f"cell_search d(freq_superfine) "
                  f"{c.freq_superfine - r.freq_superfine:+.4f} Hz, "
                  f"d(frame_start) {c.frame_start - r.frame_start:+.4f}")

    totals, stages = timed_runs(lambda timings: scan_band(
        band, f_set, FS_WORK, device="cuda", max_carriers_per_program=CHUNK,
        timings=timings), 3)
    total = statistics.median(totals)
    print(f"{label}: seconds per {len(band)}-carrier band {total:.5f} "
          f"(median of 3 after a warm-up; "
          + ", ".join(f"{t:.5f}" for t in totals) + ")")
    print(f"{label}: carriers_per_s {len(band) / total:.3f}")
    print(f"{label}: seconds per band by stage (median of 3 more, each "
          f"stage synchronised): " + ", ".join(
              f"{k} {v:.5f}" for k, v in stages.items()))
    return cell_lists, len(band) / total


KAL_FOFF = 31e3            # kalibrate's simulated crystal offset (Hz)
TRACKER_F_OFF = 200.0      # bench_tracker's MultiCellStream offset (Hz)
TRACKER_SNR_DB = 12.0      # bench_tracker's --snr default (dB)
TRACKER_RUNS = 2           # timed segments per tracker run
TRACKER_SECONDS = 2.0      # stream-seconds per timed segment
# the TPU package's device-loop tolerances (tests/test_tracker.py:917-930)
DL_TOL = {"frame_timing": (0.0, 1e-6), "frequency_offset": (1e-9, 1e-6)}
# the 400 ms stream's offset register, card end to end vs the CPU (Hz):
# between the complex64 searcher's seed (2.123e-5) and a bf16 seed's
E2E_OFFSET_HZ = 1e-4


class _Recorded:
    """A stream that keeps what it hands out, so a second run can replay
    the same samples."""

    def __init__(self, src):
        self.src = src
        self.parts = []

    def take(self, n: int) -> np.ndarray:
        x = self.src.take(n)
        self.parts.append(x)
        return x


class _Replay:
    """The samples a _Recorded stream handed out, then its source's
    next ones, which the recording keeps as well (so a later replay
    stays continuous)."""

    def __init__(self, rec: _Recorded):
        self.rec = rec
        self.pending = np.concatenate(rec.parts or [np.zeros(0, np.complex64)])

    def take(self, n: int) -> np.ndarray:
        x = self.pending[:n]
        self.pending = self.pending[n:]
        if len(x) < n:
            x = np.concatenate([x, self.rec.take(n - len(x))])
        return x


def count_launches(label: str, expect, counts: dict) -> dict:
    """read_launches, each kernel of ``expect`` at least once, the counts
    added to ``counts``."""
    launched = read_launches(label, expect)
    for k, v in launched.items():
        counts[k] = counts.get(k, 0) + v
    return launched


def check_tracked(label: str, res: dict, want_ids) -> None:
    ids = sorted(c["n_id_cell"] for c in res["tracked"])
    print(f"{label}: tracked {ids}, offset register "
          f"{res['frequency_offset']:.3f} Hz; " + "; ".join(
              f"cell {c['n_id_cell']} health {c['health']:.1f}% MIB "
              f"{'synced' if c['mib_synced'] else 'NOT synced'} frame "
              f"timing {c['frame_timing']:.3f}" for c in res["tracked"]))
    if ids != sorted(want_ids):
        fail(f"{label}: tracked {ids}, expected {sorted(want_ids)}")
    for c in res["tracked"]:
        if not (c["mib_synced"] and c["health"] > 99.0):
            fail(f"{label}: cell {c['n_id_cell']} not held: {c}")
    if abs(res["frequency_offset"] - TRACKER_F_OFF) > 50.0:
        fail(f"{label}: offset register {res['frequency_offset']} Hz")


def print_tracker_run(label: str, res: dict, smi: str) -> None:
    split = ", ".join(f"{k} {v:.3f}" for k, v in
                      res["split_ms_per_stream_s"].items())
    print(f"{label}: realtime_factor {res['value']:.4f} (best of "
          f"{len(res['factors'])}: " + ", ".join(
              f"{f:.4f}" for f in res["factors"]) + f") on {smi}")
    print(f"{label}: tick split, ms per stream-second: {split}")
    print(f"{label}: tick median {res['median_tick_ms']:.3f} ms, worst "
          f"{res['worst_tick_ms']:.3f} ms (a tick is "
          f"{res['tick_ms_stream']:.3f} ms of stream); "
          f"{res['searches_integrated']} searches integrated, "
          f"{res['ticks_search_in_flight']} ticks with a search in flight"
          + ("" if res["worst_tick_ms_search_in_flight"] is None else
             f", worst of those {res['worst_tick_ms_search_in_flight']:.3f}"
             f" ms") + f"; warmup {res['warmup_s']:.2f} s, acquisition "
          f"{res['acquisition_stream_s']:.3f} s of stream")


def searcher_maps(cap_float, cap_adc, records: dict) -> None:
    """The background searcher's T = 3 maps (one hypothesis) on the main
    path's operands at full capture length, against their plain
    versions, timed beside them with their bound."""
    from lte_cell_scanner_tpu_torch.constants import CAPLENGTH, PSS_TD_LEN
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    n_lags = CAPLENGTH - (PSS_TD_LEN - 1)
    f1 = np.array([TRACKER_F_OFF])
    for precision, cap in (("bf16", cap_float), ("int8", cap_adc)):
        kern, cap_q = kernel_operands(cap, f1)
        if kern.precision != precision or kern.taps.shape[1] != 3:
            fail(f"searcher staging: {kern.precision}, T = "
                 f"{kern.taps.shape[1]}")
        err = map_parity(precision, kern, cap_q, n_lags)
        wrapper = corr_cuda.corr_pow_int8 if precision == "int8" \
            else corr_cuda.corr_pow_bf16
        plain = corr_cuda.corr_pow_int8_plain if precision == "int8" \
            else corr_cuda.corr_pow_bf16_plain
        ms = time_cuda(lambda: wrapper(cap_q, kern.taps, n_lags,
                                       packed=kern.packed))
        words = corr_cuda.capture_words(cap_q[None])[0]
        out = torch.empty((3, n_lags), dtype=torch.bfloat16,
                          device=cap_q.device)
        bare_ms = time_cuda(lambda: corr_cuda._launch_tc(
            f"pss_corr_{precision}", words, kern.packed, out, 3, n_lags))
        plain_ms = time_cuda(lambda: plain(cap_q, kern.taps, n_lags))
        library_ms = time_cuda(library_call(cap_q, kern.taps, n_lags))
        bound_ms, bound_by = bound(precision, cap_q, kern.taps, n_lags)
        print(f"searcher map T = 3 ({precision}, {n_lags} lags): wrapper "
              f"{ms:.4f} ms, bare launch {bare_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; library conv1d "
              f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}); "
              f"max |err| {err:.3e}; grid "
              f"{corr_cuda.map_tc_grid(f'pss_corr_{precision}', 3, n_lags)}")
        records[precision]["searcher_t3"] = {
            "max_abs_err": err, "ms": ms, "bare_ms": bare_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        del kern, cap_q, words, out


def kalibrate_maps(cap_float, cap_adc) -> None:
    """kalibrate's +-120 ppm grid (T = 111 templates) on the main path's
    operands at full capture length: the bf16 map of the float capture
    and the int8 map of the ADC-grid capture (the u8 stream's route)
    against their plain versions."""
    from lte_cell_scanner_tpu_torch.constants import CAPLENGTH, PSS_TD_LEN
    from lte_cell_scanner_tpu_torch.models.search import \
        default_f_search_set
    n_lags = CAPLENGTH - (PSS_TD_LEN - 1)
    f_set = default_f_search_set(FC, 120.0)
    for precision, cap in (("bf16", cap_float), ("int8", cap_adc)):
        kern, cap_q = kernel_operands(cap, f_set)
        if kern.precision != precision or kern.taps.shape[1] != 111:
            fail(f"kalibrate staging: {kern.precision}, T = "
                 f"{kern.taps.shape[1]}")
        err = map_parity(precision, kern, cap_q, n_lags)
        print(f"kalibrate map T = 111 ({precision}, {n_lags} lags): max "
              f"|err| {err:.3e}")
        del kern, cap_q


TICK_RTOL = 1e-9           # the tick on the card vs the CPU, x max


def tick_against_cpu() -> None:
    """One device-loop tick (4 cells x 256 symbols, 2 ports) of the
    card's program against the port's float64 CPU program on the same
    staged inputs, on both wire routes: a block on the 8-bit ADC grid
    (float16 planes, the u8 stream's route) and a Gaussian block
    (float64 planes).  Both compute in complex128, so this is cuFFT
    against pocketfft in float64.  The packed vector's demodulated rows
    (CRS and special rows, from the block) and its last 4 entries (each
    cell's final phase, from the metadata alone) are held apart, each
    within TICK_RTOL of its largest value."""
    from lte_cell_scanner_tpu_torch.tracker.device_loop import (
        _tick_program, download)
    from tools_torch.bench_tracker_device import staged_tick
    for adc, wire in ((True, torch.float16), (False, torch.float64)):
        args = staged_tick(4, 256, "cuda", adc_grid=adc)
        if args[0].dtype != wire:
            fail(f"tick staging: planes {args[0].dtype}, expected {wire}")
        got = download(_tick_program(*args))
        ref = _tick_program(*staged_tick(4, 256, "cpu", adc_grid=adc)) \
            .numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            fail(f"tick on the card ({wire}): shape {got.shape}, finite "
                 f"{np.isfinite(got).all()}")
        for part, sl in (("rows", slice(None, -4)),
                         ("final phases", slice(-4, None))):
            err = float(np.abs(got[sl] - ref[sl]).max())
            scale = float(np.abs(ref[sl]).max())
            print(f"device-loop tick (4 cells x 256 symbols, {wire} planes) "
                  f"on the card vs the float64 CPU program, {part}: max "
                  f"|diff| {err:.3e} of max |value| {scale:.3e} "
                  f"({err / scale:.3e} relative; bound {TICK_RTOL:g})")
            if not err <= TICK_RTOL * scale:
                fail(f"the card's tick ({wire} planes) disagrees with the "
                     f"CPU program in its {part}")


def _track_stream(sig, dev: str, search_device=None, reseed=None):
    """A device-loop TrackerRunner on ``dev`` fed ``sig`` in blocks of
    10000; ``search_device`` runs its searcher elsewhere, and ``reseed``
    maps the first acquisition's freq_superfine (the offset register's
    seed) to another value.  Returns the runner and the seed it used."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.tracker import TrackerRunner
    from lte_cell_scanner_tpu_torch.tracker import runner as trunner
    real = trunner.search_once
    seeds = []

    def search_once(*a, **k):
        if search_device is not None:
            k = {**k, "device": search_device}
        cells = real(*a, **k)
        if cells and not seeds:
            for tc in cells:
                if reseed is not None:
                    tc.freq_superfine = reseed(tc.freq_superfine)
            seeds.append(cells[0].freq_superfine)
        return cells

    trunner.search_once = search_once
    try:
        r = TrackerRunner(FC, FC, FS_WORK, device_loop=True, device=dev)
        for i in range(0, len(sig), 10000):
            r.process_block(sig[i: i + 10000])
        r.close()
    finally:
        trunner.search_once = real
    return r, seeds[0] if seeds else float("nan")


def _bf16(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float64).to(torch.bfloat16))


def trajectory_against_cpu() -> None:
    """The 400 ms stream of tests/test_tracker.py:23-35 through the
    card's device loop and the CPU's, both float64.  The first
    acquisition seeds the offset register from the searcher's
    freq_superfine, and the card's searcher is the complex64 (bf16
    kernel) cell_search, so the runs are compared three ways:
    - end to end: frame timing within the TPU package's device-loop
      tolerance (DL_TOL) of the CPU run's, the offset register within
      E2E_OFFSET_HZ of it (the complex64 seed, which the loop forgets
      only slowly, keeps it beyond DL_TOL);
    - from the same acquisition (the card run's searcher on the CPU), so
      that the runs differ only in their ticks: both within DL_TOL;
    - a control, the same acquisition with its seed rounded to bf16: it
      must end beyond E2E_OFFSET_HZ, or that limit would not catch a
      searcher that seeds the register at bf16 precision."""
    from lte_cell_scanner_tpu_torch.cell import CpType
    from lte_cell_scanner_tpu_torch.sim import (apply_freq_offset, awgn,
                                                create_dl_sig)
    rng = np.random.default_rng(11)
    sig = create_dl_sig(CpType.NORMAL, 400, 0, 92, 1, 0.4, rng=rng,
                        n_ports=2, sfn=4)
    sig = awgn(apply_freq_offset(sig, 300.0), 5.0, rng=rng)
    ref, ref_seed = _track_stream(sig, "cpu")
    if [c.n_id_cell for c in ref.cells] != [277]:
        fail(f"400 ms stream: CPU tracked {[c.n_id_cell for c in ref.cells]}")
    tr = ref.cells[0]
    e2e = {**DL_TOL, "frequency_offset": (0.0, E2E_OFFSET_HZ)}
    runs = (("end to end", None, None, e2e, True),
            ("the same acquisition", "cpu", None, DL_TOL, True),
            ("control: the seed rounded to bf16", "cpu", _bf16, e2e, False))
    for label, search_device, reseed, tol, must_hold in runs:
        card, seed = _track_stream(sig, "cuda", search_device, reseed)
        ids = [c.n_id_cell for c in card.cells]
        if ids != [277]:
            fail(f"400 ms stream ({label}): card tracked {ids}")
        tg = card.cells[0]
        if not (tg.health_pct() > 99.0
                and card.processors[277].mib_fifo_synchronized
                and abs(card.state.frequency_offset - 300.0) < 50.0):
            fail(f"400 ms stream on the card ({label}): health "
                 f"{tg.health_pct()}, offset {card.state.frequency_offset}")
        print(f"400 ms stream ({label}): offset register seeded at "
              f"{seed:.9f} Hz, CPU run {ref_seed:.9f} Hz (|diff| "
              f"{abs(seed - ref_seed):.3e})")
        beyond = []
        for name, g, w in (("frame_timing", tg.frame_timing,
                            tr.frame_timing),
                           ("frequency_offset", card.state.frequency_offset,
                            ref.state.frequency_offset)):
            rtol, atol = tol[name]
            ok = abs(g - w) <= atol + rtol * abs(w)
            print(f"400 ms stream ({label}), card vs float64 CPU device "
                  f"loop: {name} {g:.9f} vs {w:.9f}, |diff| "
                  f"{abs(g - w):.3e} ({'within' if ok else 'BEYOND'} "
                  f"rtol {rtol:g} atol {atol:g})")
            if not ok:
                beyond.append(name)
        print(f"400 ms stream ({label}): health {tg.health_pct():.1f}% vs "
              f"{tr.health_pct():.1f}%, MIB failures "
              f"{tg.mib_decode_failures} vs {tr.mib_decode_failures}, sync "
              f"SP av rel diff {abs(tg.sync_sp_av / tr.sync_sp_av - 1):.3e},"
              f" CRS NP av rel diff "
              f"{float(np.max(np.abs(tg.crs_np_av / tr.crs_np_av - 1))):.3e}")
        if must_hold and beyond:
            fail(f"400 ms stream ({label}): {beyond} beyond the limit")
        if not must_hold and "frequency_offset" not in beyond:
            fail(f"400 ms stream ({label}): the offset register ends within "
                 f"{E2E_OFFSET_HZ:g} Hz of the CPU run's, so that limit "
                 f"would not catch a bf16 seed")


def phase_tracker(cap_float, cap_adc, records: dict, smi: str) -> dict:
    """Phase 9; returns the tracker path's launch counts and the 4-cell
    stream it recorded."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.io import native
    from lte_cell_scanner_tpu_torch.io.capture import SimSource
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.tracker.runner import kalibrate
    from tools_torch.bench_tracker import (CELL_PLAN, MultiCellStream,
                                           bench_one)
    t_phase = time.perf_counter()
    lib = native.load()
    if native.get_lib() is not lib:
        fail("the native runtime is not the library the tracker uses")
    print(f"native runtime loaded: {native.LIB_PATH.name}")
    counts = {}

    src = SimSource(freq_offset=KAL_FOFF, coupled_fc=FC, seed=5)
    corr_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    fo = kalibrate(lambda: src.capture(FC)[0], FC, FC, FS_WORK, ppm=120.0,
                   max_tries=2, device="cuda")
    secs = time.perf_counter() - t0
    count_launches("kalibrate (+-120 ppm, T = 111)", {"pss_corr_bf16"},
                     counts)
    print(f"kalibrate: offset {fo:.3f} Hz (simulated {KAL_FOFF:.0f} Hz) in "
          f"{secs:.3f} s")
    if abs(fo - KAL_FOFF) > 50.0:
        fail(f"kalibrate found {fo} Hz")

    kalibrate_maps(cap_float, cap_adc)
    searcher_maps(cap_float, cap_adc, records)

    want = [3 * n_id_1 + 1 for n_id_1, _s, _f in CELL_PLAN[:4]]
    rec = _Recorded(MultiCellStream(4, TRACKER_SNR_DB, f_off=TRACKER_F_OFF))
    corr_cuda.reset_launch_counts()
    res4 = bench_one(4, TRACKER_RUNS, TRACKER_SECONDS, device="cuda",
                     stream=rec, verbose=False)
    count_launches("tracker, 4 cells x 2 ports, inline searcher",
                     {"pss_corr_int8", "pss_corr_bf16"}, counts)
    check_tracked("tracker, 4 cells x 2 ports", res4, want)
    print_tracker_run("tracker, 4 cells x 2 ports, inline searcher", res4,
                      smi)

    corr_cuda.reset_launch_counts()
    res_async = bench_one(4, TRACKER_RUNS, TRACKER_SECONDS, device="cuda",
                          stream=_Replay(rec), search_async=True,
                          verbose=False)
    count_launches("tracker, 4 cells x 2 ports, async searcher",
                     {"pss_corr_int8", "pss_corr_bf16"}, counts)
    check_tracked("tracker, 4 cells x 2 ports, async searcher", res_async,
                  want)
    print_tracker_run("tracker, 4 cells x 2 ports, async searcher",
                      res_async, smi)

    corr_cuda.reset_launch_counts()
    res1 = bench_one(1, TRACKER_RUNS, TRACKER_SECONDS, device="cuda",
                     verbose=False)
    count_launches("tracker, 1 cell x 2 ports",
                     {"pss_corr_int8", "pss_corr_bf16"}, counts)
    check_tracked("tracker, 1 cell x 2 ports", res1, want[:1])
    print_tracker_run("tracker, 1 cell x 2 ports", res1, smi)

    tick_against_cpu()
    trajectory_against_cpu()
    during = res_async["worst_tick_ms_search_in_flight"]
    print(f"tracker summary on {smi}: realtime_factor 4 cells "
          f"{res4['value']:.4f} (async searcher {res_async['value']:.4f}), "
          f"1 cell {res1['value']:.4f}; worst tick {res4['worst_tick_ms']:.3f}"
          f" ms inline, with an async search in flight "
          + ("not measured (no search in flight in the timed ticks)"
             if during is None else f"{during:.3f} ms"))
    print(f"phase 9: {time.perf_counter() - t_phase:.2f} s; launches "
          f"{counts}")
    return counts, rec


class FakeDongle:
    """Enough of librtlsdr's function surface to serve recorded u8 bytes
    as a live dongle would: filler (code 127) through the AGC settle,
    ``payload`` from the second buffer reset on (the first capture's
    own), then filler again; an R820T-style tuner (fc_programmed is the
    requested frequency, as for a replayed file).  ``pace`` reads at the
    dongle's own rate (1.92 Msps, two bytes a sample) once the payload
    runs."""

    def __init__(self, payload: np.ndarray, pace: bool = False):
        self.payload = np.ascontiguousarray(payload, np.uint8)
        self.pace = pace
        self.pos = 0
        self.resets = 0
        self.rate = None

    def rtlsdr_get_device_count(self):
        return 1

    def rtlsdr_get_device_name(self, idx):
        return b"chip_smoke fake dongle"

    def rtlsdr_open(self, dev_p, idx):
        return 0

    def rtlsdr_close(self, dev):
        return 0

    def rtlsdr_set_sample_rate(self, dev, rate):
        self.rate = rate
        return 0

    def rtlsdr_get_sample_rate(self, dev):
        return self.rate

    def rtlsdr_set_center_freq(self, dev, freq):
        return 0

    def rtlsdr_get_tuner_type(self, dev):
        return 5

    def rtlsdr_set_tuner_gain_mode(self, dev, mode):
        return 0

    def rtlsdr_reset_buffer(self, dev):
        self.resets += 1
        return 0

    def rtlsdr_read_sync(self, dev, buf, n, n_read_p):
        import ctypes
        out = np.full(n, 127, np.uint8)
        if self.resets >= 2:
            part = self.payload[self.pos: self.pos + n]
            out[: len(part)] = part
            self.pos += len(part)
            if self.pace:
                time.sleep(n / (2.0 * self.rate))
        ctypes.memmove(buf, out.tobytes(), n)
        n_read_p._obj.value = n
        return 0


def check_peaks(out: str):
    """(location, diff, dropped) rows of a ``check`` table."""
    rows = []
    for ln in out.splitlines():
        parts = ln.split()
        if len(parts) >= 3 and all(p.lstrip("-").isdigit()
                                   for p in parts[:3]):
            rows.append(tuple(int(p) for p in parts[:3]))
    return rows


def surface_check(cap_float, cap_adc, tmp: str, counts: dict) -> None:
    """``cli.py check`` on the card: the two-cell capture as u8 and .it
    files (clean: cell 277's sync peaks every 10 ms, no drop), then a
    copy with 500 samples cut out at 30 ms (exit 2, the drop found
    within 2 samples of 500)."""
    import os
    from lte_cell_scanner_tpu_torch import cli
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.utils.itfile import write_itfile
    from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8
    u8 = os.path.join(tmp, "check.u8")
    it = os.path.join(tmp, "check.it")
    cut = os.path.join(tmp, "check_cut.it")
    complex_to_iq_u8(cap_adc).tofile(u8)
    write_itfile(it, {"capbuf": cap_float,
                      "fc": np.array([int(FC)], dtype=np.int32)})
    at = int(0.030 * 1.92e6)
    write_itfile(cut, {"capbuf": np.concatenate([cap_float[:at],
                                                 cap_float[at + 500:]]),
                       "fc": np.array([int(FC)], dtype=np.int32)})
    argv = ["-f", "739e6", "--cell-id", "277", "--foff", "35e3"]
    period = 1.92e6 * 0.010 * (FC - 35e3) / FC
    for label, path, want_rc in (("u8", u8, 0), (".it", it, 0),
                                 ("500 samples cut", cut, 2)):
        corr_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        rc, out = run_captured(cli.main, ["check", path] + argv)
        secs = time.perf_counter() - t0
        count_launches(f"check ({label})", set(), counts)
        rows = check_peaks(out)
        print(f"check ({label}): exit {rc} in {secs:.3f} s; "
              + out.strip().splitlines()[0] + "; peaks (location, diff, "
              "dropped) " + ", ".join(str(r) for r in rows)
              + "; " + out.strip().splitlines()[-1])
        if rc != want_rc or len(rows) < 6:
            fail(f"check ({label}): exit {rc}, expected {want_rc}:\n{out}")
        if want_rc == 0:
            if "(capture is CLEAN)" not in out or any(
                    abs(d - period) > 2.5 or abs(n) > 2
                    for _loc, d, n in rows):
                fail(f"check ({label}): not 10 ms peaks without a drop")
        else:
            drops = [n for _loc, _d, n in rows if abs(n) > 2]
            if len(drops) != 1 or abs(drops[0] - 500) > 2:
                fail(f"check ({label}): drops {drops}, expected one of "
                     f"500 +- 2")


def surface_live_search(cap_adc, tmp: str, counts: dict) -> None:
    """``search`` with no source named opens the dongle: through a fake
    librtlsdr serving the two-cell ADC capture's u8 bytes, the table of
    --load-files on the same bytes, with one pss_corr_int8 launch."""
    import os
    from lte_cell_scanner_tpu_torch.io import rtlsdr
    from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8
    raw = complex_to_iq_u8(cap_adc)
    u8 = os.path.join(tmp, "live.u8")
    raw.tofile(u8)
    base = ["search", "-s", "739e6", "-p", "100"]
    _c, replay = run_cli("search --load-files (same bytes)",
                         base + ["--load-files", u8],
                         {"pss_corr_int8": 1}, {})
    real = rtlsdr.load_librtlsdr
    rtlsdr.load_librtlsdr = lambda: FakeDongle(raw)
    try:
        got, live = run_cli("live search (fake dongle)", base,
                            {"pss_corr_int8": 1}, counts)
    finally:
        rtlsdr.load_librtlsdr = real
    if live != replay:
        fail(f"live search printed {live}, --load-files {replay}")
    if sorted(got) != [271, 277]:
        fail(f"live search decoded {sorted(got)}")


def surface_live_track(counts: dict) -> None:
    """``track`` with no source named, through a fake dongle paced at
    1.92 Msps serving 2 s of one cell (277, +200 Hz, 12 dB, 8-bit grid):
    the runner must hold cell 277 (health > 99%, MIB synced), the
    reader must fill the native ring and drop nothing."""
    from lte_cell_scanner_tpu_torch import cli
    from lte_cell_scanner_tpu_torch.io import native, rtlsdr
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.tracker import TrackerRunner
    from lte_cell_scanner_tpu_torch.utils.rtl import complex_to_iq_u8
    from tools_torch.bench_tracker import MultiCellStream
    raw = complex_to_iq_u8(MultiCellStream(1, TRACKER_SNR_DB,
                                           f_off=TRACKER_F_OFF)
                           .take(int(2.0 * 1.92e6)))
    seen = {"rings": [], "dropped": [], "runners": []}
    real = (rtlsdr.load_librtlsdr, rtlsdr.RtlSdrSource._make_ring,
            rtlsdr._AsyncReader.stop, TrackerRunner.close)

    def make_ring(self, capacity):
        ring = real[1](self, capacity)
        seen["rings"].append(type(ring).__name__)
        return ring

    def stop(self):
        seen["dropped"].append((self.dropped_bytes, self.overruns))
        real[2](self)

    def close(self):
        seen["runners"].append(self)
        real[3](self)

    rtlsdr.load_librtlsdr = lambda: FakeDongle(raw, pace=True)
    rtlsdr.RtlSdrSource._make_ring = make_ring
    rtlsdr._AsyncReader.stop = stop
    TrackerRunner.close = close
    corr_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc, out = run_captured(cli.main, ["track", "-f", "739e6",
                                          "--no-tui", "--duration", "1.5"])
    finally:
        (rtlsdr.load_librtlsdr, rtlsdr.RtlSdrSource._make_ring,
         rtlsdr._AsyncReader.stop, TrackerRunner.close) = real
    secs = time.perf_counter() - t0
    # kalibrate and the searcher on the dongle's u8 bytes: int8; the
    # warmup's searches: bf16
    count_launches("live track (fake dongle)",
                {"pss_corr_int8", "pss_corr_bf16"}, counts)
    tail = out.strip().splitlines()
    print(f"live track (fake dongle, 1.5 s of stream): exit {rc} in "
          f"{secs:.2f} s; rings {seen['rings']}, reader (dropped bytes, "
          f"overruns) {seen['dropped']}; " + " | ".join(
              ln.strip() for ln in tail[-6:]))
    if rc != 0 or len(seen["runners"]) != 1:
        fail(f"live track: exit {rc}:\n{out}")
    runner = seen["runners"][0]
    ids = [c.n_id_cell for c in runner.cells]
    if ids != [277]:
        fail(f"live track: tracked {ids}")
    health = runner.cells[0].health_pct()
    synced = runner.processors[277].mib_fifo_synchronized
    print(f"live track: cell 277 health {health:.1f}%, MIB "
          f"{'synced' if synced else 'NOT synced'}, offset register "
          f"{runner.state.frequency_offset:.3f} Hz")
    if not (health > 99.0 and synced):
        fail("live track: cell 277 not held")
    if seen["rings"] != [native.SampleRing.__name__]:
        fail(f"live track: the reader filled {seen['rings']}, not the "
             f"native ring")
    if seen["dropped"] != [(0, 0)] or " / usb " in out:
        fail(f"live track: the ring dropped {seen['dropped']}")


MC_KNEE = {-14.0: 0.72, -12.0: 1.0}   # docs/SENSITIVITY.md, golden path


def surface_monte_carlo(counts: dict) -> None:
    """tools_torch/monte_carlo.py's production path on the card, bf16
    and int8 (--adc-grid): 10 trials at -10 dB all successes without a
    false alarm, 3 at -30 dB all thresh1_fail; then 25 trials at -14
    and -12 dB (seed 7) printed beside the TPU package's golden-path
    rates (docs/SENSITIVITY.md), not gated."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from tools_torch import monte_carlo
    for adc, name in ((False, "pss_corr_bf16"), (True, "pss_corr_int8")):
        label = f"monte carlo ({'int8, ADC grid' if adc else 'bf16'})"
        for trials, snr, seed in ((10, -10.0, 14), (3, -30.0, 12)):
            corr_cuda.reset_launch_counts()
            t0 = time.perf_counter()
            res = monte_carlo.run_config(trials, snr, False, seed,
                                         corr_backend="kernel",
                                         adc_grid=adc, device="cuda")
            secs = time.perf_counter() - t0
            launched = count_launches(f"{label} {snr:g} dB", {name}, counts)
            print(f"{label}: {json.dumps(res)} in {secs:.2f} s")
            if launched[name] != trials:
                fail(f"{label}: {launched[name]} launches for {trials} "
                     f"trials")
            if snr == -10.0 and not (res["success"] == 1.0
                                     and res["false_alarm"] == 0.0):
                fail(f"{label}: -10 dB")
            if snr == -30.0 and res["thresh1_fail"] != 1.0:
                fail(f"{label}: -30 dB")
        for snr, golden in MC_KNEE.items():
            corr_cuda.reset_launch_counts()
            res = monte_carlo.run_config(25, snr, False, 7,
                                         corr_backend="kernel",
                                         adc_grid=adc, device="cuda")
            count_launches(f"{label} {snr:g} dB knee", {name}, counts)
            print(f"{label} {snr:g} dB, 25 trials, seed 7: success "
                  f"{res['success']:.2f}, thresh1_fail "
                  f"{res['thresh1_fail']:.2f}, thresh2_fail "
                  f"{res['thresh2_fail']:.2f}, false alarm "
                  f"{res['false_alarm']:.2f} (the TPU package's golden "
                  f"path on the CPU, docs/SENSITIVITY.md: success "
                  f"{golden:.2f})")


def surface_benches(counts: dict) -> None:
    """The bench tools on the card, each line printed (with the card's
    name and power limit), launch counts zeroed before and read after."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from tools_torch import bench_carriers, bench_front_stages, bench_search
    runs = (
        ("bench_search", bench_search.main, ["--repeats", "3", "--json"],
         {"pss_corr_bf16"}),
        ("bench_carriers (float band)", bench_carriers.main,
         ["--batches", "16,64", "--repeats", "3", "--json"],
         {"pss_corr_fold_bf16"}),
        ("bench_carriers (ADC-grid band)", bench_carriers.main,
         ["--batches", "16,64", "--repeats", "3", "--adc-grid", "--json"],
         {"pss_corr_fold_int8"}),
        ("bench_carriers --full-chain (float band)", bench_carriers.main,
         ["--batches", "64", "--repeats", "2", "--full-chain", "--json"],
         {"pss_corr_fold_bf16"}),
        ("bench_front_stages", bench_front_stages.main, ["--json"],
         {"pss_corr_bf16"}))
    for label, main, argv, expect in runs:
        corr_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_tool(label, main, argv)
        count_launches(label, expect, counts)
        print(f"{label}: {time.perf_counter() - t0:.2f} s")
        if not str(res.get("device", "")).startswith("NVIDIA"):
            fail(f"{label}: no card name and power limit in its line")
        if label.startswith("bench_carriers --full-chain") and \
                res["rows"][0]["cell_ids"] != [271, 277]:
            fail(f"{label}: decoded {res['rows'][0]['cell_ids']}")


def phase_surface(cap_float, cap_adc) -> dict:
    """Phase 9b: check, live search and track, the Monte-Carlo harness
    and the bench tools on the card; returns their launch counts."""
    import tempfile
    t_phase = time.perf_counter()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        surface_check(cap_float, cap_adc, tmp, counts)
        surface_live_search(cap_adc, tmp, counts)
    surface_live_track(counts)
    surface_monte_carlo(counts)
    surface_benches(counts)
    print(f"phase 9b: {time.perf_counter() - t_phase:.2f} s; launches "
          f"{counts}")
    return counts


# phase 11: the public staged API on the card

SURFACE_FF_HZ = 0.1        # staged vs fused freq_fine on the card (Hz)
SURFACE_REL = 1e-5         # ce_interp_hex, interpft vs their references


class _FusedCalls:
    """Keeps every sss_foe_batch_fused call of ``module`` while active:
    (peaks, capture stack, carrier indices, thresh2_n_sigma, compat,
    result)."""

    def __init__(self, module):
        self.module = module
        self.calls = []

    def __enter__(self):
        real = self.real = self.module.sss_foe_batch_fused

        def fused(cells, capbuf_stack, carrier_idx, thresh2_n_sigma,
                  fs_programmed, compat="production", skip_ids=frozenset()):
            out = real(cells, capbuf_stack, carrier_idx, thresh2_n_sigma,
                       fs_programmed, compat=compat, skip_ids=skip_ids)
            self.calls.append((list(cells), capbuf_stack, list(carrier_idx),
                               thresh2_n_sigma, compat, out))
            return out

        self.module.sss_foe_batch_fused = fused
        return self

    def __exit__(self, *exc):
        self.module.sss_foe_batch_fused = self.real


def staged_against_fused(label: str, calls, multi: bool) -> float:
    """Each recorded fused call's peaks through the staged pair (the
    ``_multi`` pair over the capture stack with ``multi``): n_id_1, CP
    and frame_start equal to the fused result, freq_fine within
    SURFACE_FF_HZ.  Returns the largest freq_fine gap (Hz)."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models import sss_detect as sd
    worst, n_acc, n_peaks = 0.0, 0, 0
    if not calls:
        fail(f"{label}: the path ran no fused SSS/FOE")
    for peaks, stack, ci, thresh2, compat, fused in calls:
        if multi:
            det = sd.sss_detect_batch_multi(peaks, stack, ci, thresh2,
                                            FS_WORK, compat)
        else:
            det = sd.sss_detect_batch(peaks, stack[0], thresh2, FC, FC,
                                      FS_WORK, compat)
        keep = [i for i, c in enumerate(det) if c.n_id_1 >= 0]
        acc = [det[i] for i in keep]
        if multi:
            foe = sd.pss_sss_foe_batch_multi(acc, stack,
                                             [ci[i] for i in keep],
                                             FS_WORK, compat)
        else:
            foe = sd.pss_sss_foe_batch(acc, stack[0], FC, FC, FS_WORK,
                                       compat)
        for i, c in zip(keep, foe):
            det[i] = c
        for g, f in zip(det, fused):
            if (g.n_id_1, g.cp_type, g.frame_start) != \
                    (f.n_id_1, f.cp_type, f.frame_start):
                fail(f"{label}: staged {g} differs from fused {f}")
        for i in keep:
            worst = max(worst, abs(det[i].freq_fine - fused[i].freq_fine))
        n_acc += len(keep)
        n_peaks += len(peaks)
    print(f"{label}: staged pair == fused on {n_peaks} peaks ({n_acc} "
          f"accepted) in n_id_1, CP, frame_start; largest freq_fine gap "
          f"{worst:.6g} Hz")
    if not n_acc:
        fail(f"{label}: no peak accepted")
    if worst > SURFACE_FF_HZ:
        fail(f"{label}: freq_fine {worst} Hz from the fused path")
    return worst


def surface_staged(cap_float, cap_adc, band_float, band_adc, f_set,
                   counts: dict) -> dict:
    """11a and 11b: the staged pairs against the fused path on the peaks
    of the single-carrier and the band path; returns the gaps."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models import search
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.parallel import carriers
    gaps = {}
    for name, cap, precision in (("float capture", cap_float, "bf16"),
                                 ("ADC-grid capture", cap_adc, "int8")):
        corr_cuda.reset_launch_counts()
        with _FusedCalls(search) as rec:
            search.cell_search(cap, f_set, FC, FC, FS_WORK, device="cuda")
        count_launches(f"11a {name}", {f"pss_corr_{precision}"}, counts)
        gaps[name] = staged_against_fused(f"11a {name}", rec.calls, False)
    for name, band, precision in (("float band", band_float, "bf16"),
                                  ("ADC-grid band", band_adc, "int8")):
        corr_cuda.reset_launch_counts()
        with _FusedCalls(carriers) as rec:
            carriers.scan_band(band, f_set, FS_WORK, device="cuda",
                               max_carriers_per_program=CHUNK)
        count_launches(f"11b {name}", {f"pss_corr_fold_{precision}"},
                       counts)
        gaps[name] = staged_against_fused(f"11b {name}", rec.calls, True)
    return gaps


def surface_ce_interp() -> None:
    """11c: ce_interp_hex and pbch_extract on the card on the tfg
    vector."""
    import pathlib

    from lte_cell_scanner_tpu_torch.cell import Cell, CpType
    from lte_cell_scanner_tpu_torch.models import chan_est, mib
    from lte_cell_scanner_tpu_torch.models.rs import RsDl
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.utils.itfile import read_itfile
    vec = pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
    tfg_h = torch.from_numpy(read_itfile(str(vec / "test_tfg.it"))["tfg"])
    tfg = tfg_h.to("cuda", torch.complex64)
    # the vector's cell: 277, normal CP (BASELINE.md)
    cell = Cell(fc_requested=FC, fc_programmed=FC, ind=8674, freq=40e3,
                n_id_2=1, n_id_1=92, cp_type=CpType.NORMAL,
                frame_start=17448.525, freq_fine=39684.0775)
    rs_dl = RsDl(277, 6, CpType.NORMAL)
    n_ofdm = int(tfg.shape[0])
    corr_cuda.reset_launch_counts()
    ces = []
    for port in range(4):
        raw, rs_set, shifts = chan_est._extract_raw_ce(rs_dl, tfg, port)
        filt = chan_est._hex_filter(raw, int(shifts[0]), int(shifts[1]))
        got = chan_est.ce_interp_hex(filt, rs_set, shifts, n_ofdm,
                                     cell.n_symb_dl(), port)
        ref, _np = chan_est.chan_est(cell, rs_dl, tfg, port, interp="hex")
        if got.device.type != "cuda":
            fail("11c: ce_interp_hex left the card")
        rel = float((got - ref).abs().max() / ref.abs().max())
        print(f"11c ce_interp_hex port {port}: {tuple(got.shape)} within "
              f"{rel:.3g} x max of chan_est(interp='hex') on the card")
        if not rel <= SURFACE_REL:
            fail(f"11c: ce_interp_hex port {port} {rel} x max")
        ces.append(ref)
    sym, ce = mib.pbch_extract(cell, tfg, ces)
    sym_h, ce_h = mib.pbch_extract(cell, tfg.cpu(), [c.cpu() for c in ces])
    if not (torch.equal(sym.cpu(), sym_h) and torch.equal(ce.cpu(), ce_h)):
        fail("11c: pbch_extract on the card differs from the CPU's")
    print(f"11c pbch_extract: {tuple(sym.shape)} symbols, CE "
          f"{tuple(ce.shape)}, equal to the CPU's gather")
    read_launches("11c", set())


def surface_interpft() -> None:
    """11d: interpft on the card against interpft_host on the sync
    template's 128-sample bodies (x1024) and a CP-length PSS (x7)."""
    from lte_cell_scanner_tpu_torch.models.pss import pss_td
    from lte_cell_scanner_tpu_torch.models.sss import sss_td
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.ops.dsp import interpft, interpft_host
    corr_cuda.reset_launch_counts()
    for name, x, n_y in (("PSS body", pss_td(1)[9:], 1024 * 128),
                         ("SSS body", sss_td(92, 1, 0)[9:], 1024 * 128),
                         ("PSS with CP", pss_td(2), 7 * 137)):
        ref = interpft_host(np.asarray(x), n_y)
        got = interpft(torch.from_numpy(np.asarray(x, np.complex64)).cuda(),
                       n_y).cpu().numpy()
        rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        print(f"11d interpft {name} ({len(x)} -> {n_y}): within {rel:.3g}"
              f" x max of interpft_host")
        if got.shape != ref.shape or not rel <= SURFACE_REL:
            fail(f"11d: interpft {name} {got.shape} {rel} x max")
    read_launches("11d", set())


def surface_tracker_host(rec, smi: str, counts: dict) -> dict:
    """11e: bench_one at 4 cells off the device loop, serial and with a
    pool of 4, on phase 9's recorded stream."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from tools_torch.bench_tracker import CELL_PLAN, bench_one
    want = [3 * n_id_1 + 1 for n_id_1, _s, _f in CELL_PLAN[:4]]
    rates = {}
    for label, parallel in (("device loop off", 0),
                            ("device loop off, parallel=4", 4)):
        corr_cuda.reset_launch_counts()
        res = bench_one(4, TRACKER_RUNS, TRACKER_SECONDS, verbose=False,
                        parallel=parallel, device_loop=False, device="cuda",
                        stream=_Replay(rec))
        count_launches(f"11e tracker, {label}",
                       {"pss_corr_int8", "pss_corr_bf16"}, counts)
        check_tracked(f"11e tracker, 4 cells x 2 ports, {label}", res, want)
        print_tracker_run(f"11e tracker, 4 cells x 2 ports, {label}", res,
                          smi)
        rates[label] = res["value"]
    return rates


def phase_public_api(cap_float, cap_adc, band_float, band_adc, f_set,
                     rec, smi: str) -> dict:
    """Phase 11; returns its launch counts."""
    t_phase = time.perf_counter()
    counts = {}
    gaps = surface_staged(cap_float, cap_adc, band_float, band_adc, f_set,
                          counts)
    surface_ce_interp()
    surface_interpft()
    rates = surface_tracker_host(rec, smi, counts)
    print(f"phase 11 on {smi}: {time.perf_counter() - t_phase:.2f} s; "
          f"staged vs fused freq_fine gaps (Hz) " + ", ".join(
              f"{k} {v:.6g}" for k, v in gaps.items())
          + "; realtime_factor off the device loop " + ", ".join(
              f"{k}: {v:.4f}" for k, v in rates.items())
          + f"; launches {counts}")
    return counts


# phase 10: the multi-device layouts on the one card
MH_TIMEOUT = 600           # seconds the two ranks of phase 10a may take
MD_POW_REL = 2e-2          # pss_pow of a multi-device band vs phase 7
MD_FRAME = 1e-3            # frame_start (samples) of the same
GRID_MAP_REL = 1e-5        # a grid's collapsed map vs one device, x max
GRID_F32_REL = 2e-5        # f32 operands vs the exact route, x max
GRID_ARGMAX = 0.999        # share of lags whose argmax must agree
GRID_F4 = np.array([-5e3, 0.0, 5e3, 10e3])   # tests/test_sharded.py:28


def _band_cell(c) -> dict:
    """A band cell's compared fields, from a Cell or a worker's record."""
    if isinstance(c, dict):
        return c
    return {"n_id_cell": c.n_id_cell(), "cp": c.cp_type.value,
            "fc": c.fc_requested, "frame_start": float(c.frame_start),
            "pss_pow": float(c.pss_pow),
            "freq_superfine": float(c.freq_superfine),
            "n_ports": c.n_ports, "n_rb_dl": c.n_rb_dl, "sfn": c.sfn}


def expect_band_cells(label: str, got, want) -> None:
    """Deduplicated band cells against phase 7's single-process ones: ID,
    CP, SFN, ports, n_rb and fc exactly, frame_start within MD_FRAME
    samples, pss_pow within MD_POW_REL relative (each chunk's operands
    come from its own middle carrier, at bf16)."""
    def order(cells):
        return sorted((_band_cell(c) for c in cells),
                      key=lambda c: (c["fc"], c["n_id_cell"]))
    got, want = order(got), order(want)
    exact = ("n_id_cell", "cp", "sfn", "n_ports", "n_rb_dl", "fc")
    if [[g[k] for k in exact] for g in got] != \
            [[w[k] for k in exact] for w in want]:
        fail(f"{label}: cells {got} differ from phase 7's {want}")
    d_frame = max(abs(g["frame_start"] - w["frame_start"])
                  for g, w in zip(got, want))
    d_pow = max(abs(g["pss_pow"] - w["pss_pow"]) / w["pss_pow"]
                for g, w in zip(got, want))
    print(f"{label}: {len(got)} cells as phase 7's; frame_start within "
          f"{d_frame:.3e} samples, pss_pow within {d_pow:.3e} relative")
    if not (d_frame <= MD_FRAME and d_pow <= MD_POW_REL):
        fail(f"{label}: frame_start {d_frame} or pss_pow {d_pow} beyond "
             f"{MD_FRAME} / {MD_POW_REL}")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_ranks(tmp: str) -> list:
    """Two tools_torch/multihost_worker.py ranks over gloo on this card,
    on phase 7's band in the CLI's strided split; both are killed if
    either fails or outlasts MH_TIMEOUT.  Returns their JSON results."""
    import os
    import pathlib
    root = pathlib.Path(__file__).resolve().parent
    port = _free_port()
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tools_torch" / "multihost_worker.py"),
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r), "--out", outs[r], "--device", "cuda",
         "--band", "scenario"],
        cwd=str(root), stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    t_end = time.monotonic() + MH_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > t_end:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            fail(f"rank {r} of the two-rank band exited {p.returncode} "
                 f"(killed after {MH_TIMEOUT} s, or after its peer failed, "
                 f"when negative):\n{text[-3000:]}")
    return [json.load(open(o)) for o in outs]


def phase_two_ranks(band_cells: dict, band_rates: dict, smi: str,
                    counts: dict) -> None:
    """10a: two ranks on the one card."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r0, r1 = run_two_ranks(tmp)
    print(f"10a: two ranks over gloo on one card, {r0['device']} and "
          f"{r1['device']}, in {time.perf_counter() - t0:.2f} s wall on "
          f"{smi} (each made the band in {r0['band_made_s']:.2f} / "
          f"{r1['band_made_s']:.2f} s)")
    for name, prec, grid in (("float", "bf16", 0), ("adc", "int8", 1)):
        a, b = r0[name], r1[name]
        label = f"10a two-rank {name} band ({a['carriers']} + " \
            f"{b['carriers']} carriers)"
        if a["merged"] != b["merged"]:
            fail(f"{label}: the ranks merged different lists")
        expect_band_cells(label, a["merged"], band_cells[name])
        if a["verdicts"] != b["verdicts"] or len(a["verdicts"]) != 1:
            fail(f"{label}: route verdicts {a['verdicts']} vs "
                 f"{b['verdicts']}")
        flags = a["verdicts"][0]
        print(f"{label}: gathered route verdict {flags} on both ranks")
        if any(f[0] != grid or f[1] == 0 for f in flags):
            fail(f"{label}: expected the fused v4 {prec} route on both")
        kern = f"pss_corr_fold_{prec}"
        for r, res in enumerate((a, b)):
            if res["launches"] != {kern: 1}:
                fail(f"{label}: rank {r} launched {res['launches']}, "
                     f"expected {kern} once")
            counts[kern] = counts.get(kern, 0) + 1
        secs = [statistics.median(res["seconds"]) for res in (a, b)]
        rate = a["band_carriers"] / max(secs)
        print(f"{label}: carriers_per_s {rate:.3f} (the slower rank's "
              f"median band of {len(a['seconds'])}: " + ", ".join(
                  f"{s:.5f}" for s in secs) + f" s) vs phase 7's one "
              f"process {band_rates[name]:.3f}, one card ({smi}), a "
              f"multi-device layout: not a multi-card result")


def phase_device_list(band_float, f_set, band_cells: dict, smi: str,
                      counts: dict) -> None:
    """10b: one process over the device list [cuda:0, cuda:0]."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import dedup
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.parallel.carriers import (
        make_carrier_mesh, scan_band)
    mesh = make_carrier_mesh(devices=["cuda:0", "cuda:0"])
    label = "10b float band over [cuda:0, cuda:0]"
    corr_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    lists = scan_band(band_float, f_set, FS_WORK, mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = read_launches(label, {"pss_corr_fold_bf16"})
    if launched["pss_corr_fold_bf16"] != 2:
        fail(f"{label}: expected one v4 launch per device block")
    counts["pss_corr_fold_bf16"] = counts.get("pss_corr_fold_bf16", 0) + 2
    expect_band(lists, band_float, label)
    expect_band_cells(label, dedup(lists), band_cells["float"])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scan_band(band_float, f_set, FS_WORK, mesh=mesh)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    print(f"{label}: first run {secs:.3f} s, then " + ", ".join(
        f"{t:.5f}" for t in times) + f" s: carriers_per_s "
        f"{len(band_float) / statistics.median(times):.3f} on {smi} (one "
        f"card, a multi-device layout)")


def _grid_maps(label: str, cap, f_set, grid, precision=None):
    """The grid's collapsed map against the one-device front end on the
    card (the bf16 map kernel; the exact route for f32 operands)."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.xcorr import xcorr_pss
    from lte_cell_scanner_tpu_torch.parallel.sharded import (
        plan_sharded_bands, plan_sharded_inputs, sharded_xcorr)
    inp = plan_sharded_inputs(cap, f_set, FC, FC, FS_WORK, grid,
                              dtype=np.complex128)
    bands = plan_sharded_bands(inp[1], grid, precision or "bf16")
    pow_g, frq_g = (x.cpu().numpy() for x in sharded_xcorr(
        grid, inp[0], inp[1], inp[2], 2, inp[3], inp[4], 0, bands))
    ref = xcorr_pss(cap, f_set, 2, FC, FC, FS_WORK, lean=True,
                    device="cuda",
                    corr_backend="exact" if precision == "f32" else "auto")
    pow_r = ref.xc_incoherent_collapsed_pow
    err = float(np.max(np.abs(pow_g - pow_r)) / np.max(pow_r))
    same = float(np.mean(frq_g == ref.xc_incoherent_collapsed_frq))
    bar = GRID_F32_REL if precision == "f32" else GRID_MAP_REL
    print(f"{label}: collapsed map within {err:.3e} x max of the "
          f"one-device front end (bar {bar:g}), argmax equal on "
          f"{100 * same:.3f}% of lags")
    if not (err <= bar and same >= GRID_ARGMAX):
        fail(f"{label}: the grid's map disagrees with one device")


def _expect_like(label: str, cells, want) -> None:
    key = sorted((c.n_id_cell(), c.n_id_1, c.cp_type, c.sfn, c.n_ports,
                  c.n_rb_dl) for c in cells)
    ref = sorted((c.n_id_cell(), c.n_id_1, c.cp_type, c.sfn, c.n_ports,
                  c.n_rb_dl) for c in want)
    if key != ref:
        fail(f"{label}: cells {cells} differ from phase 4's {want}")


def phase_grids(cap_float, f_set, float_cells, smi: str,
                counts: dict) -> None:
    """10c: the (t x f) front end at full width."""
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import cell_search
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.parallel.sharded import make_mesh
    grid41 = make_mesh(4, 1, ["cuda:0"] * 4)
    grid42 = make_mesh(4, 2, ["cuda:0"] * 8)
    f4 = GRID_F4 + 35e3        # about the two-cell capture's offset
    for label, grid, fs, n in (
            ("10c cell_search over a (4 x 1) grid, T = 93", grid41, f_set,
             4),
            ("10c cell_search over a (4 x 2) grid, T = 12", grid42, f4, 8)):
        corr_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        cells = cell_search(cap_float, fs, FC, FC, FS_WORK, mesh=grid)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read_launches(label, {"pss_corr_bf16"})
        if launched["pss_corr_bf16"] != n:
            fail(f"{label}: expected {n} launches, one per device")
        counts["pss_corr_bf16"] = counts.get("pss_corr_bf16", 0) + n
        expect_cells(cells, label)
        _expect_like(label, cells, float_cells)
        print(f"{label}: {secs:.3f} s (first run) on {smi}")
    _grid_maps("10c (4 x 1) grid, T = 93", cap_float, f_set, grid41)
    _grid_maps("10c (4 x 2) grid, 4 hypotheses", cap_float, f4, grid42)
    corr_cuda.reset_launch_counts()
    _grid_maps("10c (4 x 1) grid, f32 operands", cap_float, f_set, grid41,
               "f32")
    launched = read_launches("10c f32 operands", {"pss_corr_f32"})
    if launched["pss_corr_f32"] != 4:
        fail("10c f32 operands: expected 4 pss_corr_f32 launches")
    counts["pss_corr_f32"] = counts.get("pss_corr_f32", 0) + 4

    # s_per_carrier, one device and the (4 x 1) grid in turns
    runs = {"one device": lambda: cell_search(cap_float, f_set, FC, FC,
                                              FS_WORK, device="cuda"),
            "(4 x 1) grid": lambda: cell_search(cap_float, f_set, FC, FC,
                                                FS_WORK, mesh=grid41)}
    times = {k: [] for k in runs}
    for k in list(runs) * 6:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[k]()
        torch.cuda.synchronize()
        times[k].append(time.perf_counter() - t0)
    print("10c s_per_carrier (median of 5 after a warm-up, in turns) on "
          f"{smi}, one card: " + "; ".join(
              f"{k} {statistics.median(v[1:]):.5f}" for k, v in
              times.items()) + " (the grid is a multi-device layout on one "
          "card, not a multi-card result)")


def phase_tracker_grid(smi: str, counts: dict) -> None:
    """10d: the tracker with its searcher's front end over a (4 x 1)
    grid, on the stream of tests/test_tracker.py:485-500 (CELL_PLAN's
    first cell: 277, +300 Hz, 5 dB, 400 ms)."""
    from lte_cell_scanner_tpu_torch.cell import CpType
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.parallel.sharded import make_mesh
    from lte_cell_scanner_tpu_torch.sim import (apply_freq_offset, awgn,
                                                create_dl_sig)
    from lte_cell_scanner_tpu_torch.tracker import TrackerRunner
    rng = np.random.default_rng(11)
    sig = create_dl_sig(CpType.NORMAL, 400, 0, 92, 1, 0.4, rng=rng,
                        n_ports=2, sfn=4)
    sig = awgn(apply_freq_offset(sig, 300.0), 5.0, rng=rng)
    label = "10d tracker, searcher over a (4 x 1) grid"
    corr_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    r = TrackerRunner(FC, FC, FS_WORK, device="cuda",
                      search_mesh=make_mesh(4, 1, ["cuda:0"] * 4))
    for i in range(0, len(sig), 10000):
        r.process_block(sig[i: i + 10000])
    r.close()
    secs = time.perf_counter() - t0
    launched = read_launches(label, {"pss_corr_bf16"})
    if launched["pss_corr_bf16"] % 4:
        fail(f"{label}: searches did not launch once per time block")
    counts["pss_corr_bf16"] = counts.get("pss_corr_bf16", 0) \
        + launched["pss_corr_bf16"]
    ids = [c.n_id_cell for c in r.cells]
    fo = r.state.frequency_offset
    print(f"{label}: tracked {ids}, offset register {fo:.3f} Hz; " + "; ".join(
        f"cell {c.n_id_cell} n_rb {c.n_rb_dl} health {c.health_pct():.1f}%"
        for c in r.cells) + f"; {secs:.2f} s for 0.4 s of stream on {smi}")
    if ids != [277] or r.cells[0].n_rb_dl != 6 \
            or not r.cells[0].health_pct() > 99.0 or abs(fo - 300.0) > 50.0:
        fail(f"{label}: the cell was not held")


def phase_multidevice(cap_float, f_set, float_cells, band_float,
                      band_cells: dict, band_rates: dict, smi: str) -> dict:
    """Phase 10; returns its launch counts (10a-10d)."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from tools_torch import bench_kernels
    t_phase = time.perf_counter()
    counts = {}
    steps = (("10a", lambda: phase_two_ranks(band_cells, band_rates, smi,
                                             counts)),
             ("10b", lambda: phase_device_list(band_float, f_set,
                                               band_cells, smi, counts)),
             ("10c", lambda: phase_grids(cap_float, f_set, float_cells, smi,
                                         counts)),
             ("10d", lambda: phase_tracker_grid(smi, counts)))
    for name, step in steps:
        t0 = time.perf_counter()
        step()
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s on {smi}")
    t0 = time.perf_counter()
    corr_cuda.reset_launch_counts()
    run_tool("10e bench_kernels sharded_1x1", bench_kernels.main, [
        "--variants", "front_lean,sharded_1x1,sharded_1x1_kernel",
        "--repeats", BENCH_REPEATS])
    read_launches("10e bench_kernels sharded_1x1", {"pss_corr_bf16"})
    print(f"phase 10e: {time.perf_counter() - t0:.2f} s on {smi}")
    print(f"phase 10: {time.perf_counter() - t_phase:.2f} s; launches "
          f"{counts} (one card: multi-device layouts, not a multi-card "
          f"result)")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from lte_cell_scanner_tpu_torch.constants import CAPLENGTH, PSS_TD_LEN
    from lte_cell_scanner_tpu_torch.models.search import default_f_search_set
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,
                                                          band_captures,
                                                          two_cell_capture)

    smi = phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32: matmul off, cudnn off")
    logs = phase_build()
    ptxas = tc_ptxas(logs["pss_corr_fold"], "pss_corr_fold_kernel",
                     "pss_corr_fold.cu", FOLD_TC)
    map_ptxas = tc_ptxas(logs["pss_corr"], "map_tc_kernel", "pss_corr.cu",
                         MAP_TC)
    print(f"map_tc_kernel resident blocks per SM: "
          f"{corr_cuda.map_tc_blocks_per_sm()}")

    f_set = default_f_search_set(FC, PPM)
    cap_float = two_cell_capture(seed=0, f_off=35e3, fc=FC)
    cap_adc = adc_quantize(cap_float)
    if corr_cuda.is_adc_grid(cap_float) or not corr_cuda.is_adc_grid(cap_adc):
        fail("capture routing: float/ADC grid check")
    n_lags = CAPLENGTH - (PSS_TD_LEN - 1)
    print(f"full width: T = {3 * len(f_set)} templates, {CAPLENGTH} "
          f"samples, {n_lags} lags")

    records = {}
    for precision, cap in (("bf16", cap_float), ("int8", cap_adc)):
        kern, cap_q = kernel_operands(cap, f_set)
        if kern.precision != precision:
            fail(f"staging picked {kern.precision} for the {precision} "
                 f"capture")
        records[precision] = check_kernel(precision, kern, cap_q, n_lags,
                                          map_ptxas[precision])
        del kern, cap_q
    ab_records = check_ab_kernels(ab_operands(cap_float, cap_adc, f_set),
                                  n_lags, map_ptxas["sum"])
    torch.cuda.empty_cache()

    counts = {}
    float_cells = run_main_path("float capture", cap_float, f_set, "bf16",
                                counts)
    adc_cells = run_main_path("ADC-grid capture", cap_adc, f_set, "int8",
                              counts)
    file_counts = {}
    phase_files(cap_float, cap_adc, f_set, float_cells, adc_cells,
                file_counts)
    from lte_cell_scanner_tpu_torch.constants import FS_WORK
    from lte_cell_scanner_tpu_torch.models.search import cell_search
    phase_profile("cell_search (float capture)", lambda: cell_search(
        cap_float, f_set, FC, FC, FS_WORK, device="cuda"))
    ab_counts = {}
    run_ab_path(cap_float, f_set, ab_counts)
    rulers = phase_benches(ab_counts)

    t0 = time.perf_counter()
    band_float, band_adc = band_captures()
    print(f"band: {len(band_float)} carriers, "
          f"{band_float[0][1] / 1e6:.1f}-{band_float[-1][1] / 1e6:.1f} MHz, "
          f"made in {time.perf_counter() - t0:.2f} s")
    fold_records = {}
    for precision, band in (("bf16", band_float), ("int8", band_adc)):
        route, planes = band_operands(band, f_set)
        if route.kern.precision != precision:
            fail(f"band staging picked {route.kern.precision} for the "
                 f"{precision} band")
        fold_records[precision] = check_fold_kernel(
            precision, route, planes, rulers[precision], ptxas[precision])
        del route, planes
        torch.cuda.empty_cache()

    from lte_cell_scanner_tpu_torch.parallel.carriers import scan_band
    from lte_cell_scanner_tpu_torch.models.search import dedup
    band_cells, band_rates = {}, {}
    for name, label, band, precision in (
            ("float", "float band", band_float, "bf16"),
            ("adc", "ADC-grid band", band_adc, "int8")):
        lists, band_rates[name] = run_band_path(label, band, f_set,
                                                precision, counts)
        band_cells[name] = dedup(lists)
    phase_profile("scan_band (float band)", lambda: scan_band(
        band_float, f_set, FS_WORK, device="cuda",
        max_carriers_per_program=CHUNK))

    tracker_counts, stream = phase_tracker(cap_float, cap_adc, records, smi)
    tools_counts = phase_surface(cap_float, cap_adc)
    md_counts = phase_multidevice(cap_float, f_set, float_cells, band_float,
                                  band_cells, band_rates, smi)
    api_counts = phase_public_api(cap_float, cap_adc, band_float, band_adc,
                                  f_set, stream, smi)

    # each map_tc_kernel instance against its ruler of phase 5b
    for rec, key in ((records["bf16"], "bf16"), (records["int8"], "int8"),
                     (ab_records["pss_corr_bf16_f32out"], "bf16_f32out"),
                     (ab_records["pss_corr_int8_scaled"], "int8"),
                     (ab_records["pss_corr_sum_bf16"], "bf16")):
        ruler = rulers[key]
        rec["share_of_ruler"] = rec["useful_tflops"] / ruler
        unit = UNIT["int8" if key == "int8" else "bf16"]
        print(f"{rec['name']}: {rec['useful_tflops']:.1f} useful "
              f"{unit} (wrapper), "
              f"{rec['bare_useful_tflops']:.1f} (bare launch): "
              f"{100.0 * rec['share_of_ruler']:.1f}% and "
              f"{100.0 * rec['bare_useful_tflops'] / ruler:.1f}% of this "
              f"card's {key} ruler {ruler:.1f} (bench_corr_v2 peak)")
    kernels = []
    for rec in (records["bf16"], records["int8"], fold_records["bf16"],
                fold_records["int8"]):
        rec["launches"] = counts[rec["name"]]
        kernels.append(rec)
    for name, rec in ab_records.items():
        rec["launches"] = ab_counts[name]
        kernels.append(rec)
    for rec in kernels:
        rec["file_launches"] = file_counts.get(rec["name"], 0)
        rec["tracker_launches"] = tracker_counts.get(rec["name"], 0)
        rec["tools_launches"] = tools_counts.get(rec["name"], 0)
        rec["multidevice_launches"] = md_counts.get(rec["name"], 0)
        rec["surface_launches"] = api_counts.get(rec["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
