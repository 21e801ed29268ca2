"""Smoke run of the PyTorch/CUDA cell scanner on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from ``lte_cell_scanner_tpu_torch/csrc``
     with nvcc (sm_90a): ``cuda_build.build``, one nvcc per source (two
     sources, ``pss_corr.cu`` and ``pss_corr_fold.cu``, both including
     ``hankel_mma.cuh``), all started together; the ptxas register and
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
     warm-up), and seconds by stage (staging, front_end, sss_foe, decode,
     total; median of 3 more runs, each stage synchronised);
  8. one band scan under torch.profiler (float band): busy share and top
     device operations;
  9. the five map_tc_kernel instances' useful rates against this card's
     rulers of phase 5b (bf16 matmul, bf16 matmul with f32 output for
     pss_corr_bf16_f32out, int8 _int_mm); one JSON line of kernel records
     (all nine: the four above and the five of the A/B path, whose
     launches are those of phase 5b), then the result line.

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
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = list(zip(SOURCES, pool.map(build, SOURCES)))
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


def check_kernel(precision: str, kern, cap_q, n_lags: int,
                 ptxas: str) -> dict:
    """The tensor-core map kernel of ``precision`` on the main path's
    operands (the taps packed once by KernelOperands) against its plain
    version, then timed: the wrapper (capture words built per call), the
    bare launch on words built once, the plain version and the library
    yardstick; its bound and useful rate."""
    from lte_cell_scanner_tpu_torch.ops import corr_cuda
    wrapper = corr_cuda.corr_pow_int8 if precision == "int8" \
        else corr_cuda.corr_pow_bf16
    plain = corr_cuda.corr_pow_int8_plain if precision == "int8" \
        else corr_cuda.corr_pow_bf16_plain
    name = f"pss_corr_{precision}"
    n_t = kern.taps.shape[1]
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

    del got, ref, g, r, err
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


def run_tool(label: str, main, argv) -> dict:
    """One run of a tools_torch bench's main(argv) on the card: its JSON
    line echoed and parsed; fails unless it exits 0."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue().strip()
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
          f"{capbuf.shape[0] / stages['front_end']:.1f}")


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
    cap, tmpl, starts, _n = plan_carrier_inputs(caps, fcs, f_set, fcs,
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
    run_main_path("float capture", cap_float, f_set, "bf16", counts)
    run_main_path("ADC-grid capture", cap_adc, f_set, "int8", counts)
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
    run_band_path("float band", band_float, f_set, "bf16", counts)
    run_band_path("ADC-grid band", band_adc, f_set, "int8", counts)
    phase_profile("scan_band (float band)", lambda: scan_band(
        band_float, f_set, FS_WORK, device="cuda",
        max_carriers_per_program=CHUNK))

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
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
