"""Kernel bench of the port's correlation kernels on one NVIDIA GPU: the
counterpart of tools/bench_corr_v2.py (v1 banded vs v2 im2col vs v3 and
the TPU probes), on the same operands the front end would hand each
kernel.

    python3 tools_torch/bench_corr_v2.py [--ppm 100] [--repeats 10]
        [--variants peak,bw,v1,v2_128_16,...] [--samples N]
        [--device cuda|cpu] [--skip-rulers]

Variants (the TPU tool's names; what each runs here, "tc" on the tensor
cores):

  peak      this card's tensor-core yardsticks, library calls used only
            as rulers: torch.matmul bf16 4096^3 with bf16 output,
            torch.mm with f32 output (out_dtype) and torch._int_mm int8
            with int32 output
  bw        the HBM read rate: torch.sum of a 1 GiB f32 tensor (20x the
            50 MB L2)
  v1        v1 with bf16 bands (v1_operands): pss_corr_bf16_f32out (tc)
  v2_M_T    v2, f32 map: pss_corr_bf16_f32out (tc)
  v2b_M_T   v2, bf16 map (the production route): pss_corr_bf16 (tc)
  v3_M_T    v3, f32 map (v3_operands): pss_corr_bf16_f32out (tc)
  v3b_M_T   v3, bf16 map: pss_corr_bf16 (tc)
  v2sum     the sum probe: pss_corr_sum_bf16 (tc)
  v2s_M_T   the per-chunk probe: pss_corr_bf16 (tc) once per T templates
  v2i_M     the int8 probe on the 8-bit ADC-grid capture:
            pss_corr_int8_scaled (tc)

M (rows per block) is the TPU kernels' tiling, and so is T except in
v2s: both are accepted and kept in the result names, and the CUDA kernels
ignore them (a tensor-core block is 32 templates walking 256-lag tiles).
v2 and v3 differ on the TPU only in how the map reaches the [template,
lag] layout, which the CUDA kernels write directly, so v2_M_T and v3_M_T
time one kernel.  The
tensor-core variants take the taps packed once (KernelOperands.packed, or
pack_map_taps for v2sum and v2i) and build the capture's words in each
call.

The capture is the port's two-cell 739 MHz capture (seed 0) at +-ppm,
its first --samples samples.  Each time is the median over --repeats
windows of 5 back-to-back calls timed with CUDA events after a warm-up
(on the CPU: the host clock around one call).  Prints one JSON line with
the device's name, ``{name}_ms`` and ``{name}_useful_tflops`` (8 T n_lags
137 operations per call) for each variant, and the rulers' rates.  A
variant that fails raises, so the process exits non-zero.  --skip-rulers
leaves out peak and bw (for runs on the CPU, where they would time the
CPU's BLAS).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from lte_cell_scanner_tpu_torch.constants import FS_WORK, PSS_TD_LEN  # noqa: E402
from lte_cell_scanner_tpu_torch.models.search import default_f_search_set  # noqa: E402
from lte_cell_scanner_tpu_torch.models.xcorr import (  # noqa: E402
    KernelOperands, pss_templates, v1_operands, v3_operands)
from lte_cell_scanner_tpu_torch.ops import corr_cuda  # noqa: E402
from lte_cell_scanner_tpu_torch.sim.scenarios import (adc_quantize,  # noqa: E402
                                                      two_cell_capture)

FC = 739e6
DEFAULT_VARIANTS = "peak,bw,v1,v2_128_16,v2b_128_16,v3_128_16,v3b_128_16," \
    "v2sum,v2s_128_16,v2i_128"
RULERS = ("peak", "bw")


def time_ms(fn, device: torch.device, repeats: int, per_rep: int = 5
            ) -> float:
    """Median milliseconds of one fn() call (see the module docstring)."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def bench_capture(samples: int) -> np.ndarray:
    """The first ``samples`` samples of the two-cell capture (seed 0)."""
    return two_cell_capture(seed=0, f_off=35e3, fc=FC)[:samples]


def _finite(out: torch.Tensor, name: str) -> None:
    if not bool(torch.isfinite(out.float()).all()) or not bool(out.any()):
        raise RuntimeError(f"{name}: non-finite or all-zero output")


def _rulers(res: dict, variants, device, repeats: int) -> None:
    n = 4096
    flops = 2.0 * n ** 3
    if "peak" in variants:
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(n, n, generator=gen).to(device, torch.bfloat16)
        w = (torch.randn(n, n, generator=gen) / 64).to(device, torch.bfloat16)
        xi = torch.randint(-127, 128, (n, n), generator=gen,
                           dtype=torch.int8).to(device)
        # column-major B: the layout cuBLASLt's int8 path takes natively
        wi = torch.randint(-127, 128, (n, n), generator=gen,
                           dtype=torch.int8).to(device).t().contiguous().t()
        for key, fn in (
                ("peak_bf16_tflops", lambda: torch.matmul(x, w)),
                ("peak_bf16_f32out_tflops",
                 lambda: torch.mm(x, w, out_dtype=torch.float32)),
                ("peak_int8_tops", lambda: torch._int_mm(xi, wi))):
            res[key] = flops / (time_ms(fn, device, repeats) * 1e-3) / 1e12
    if "bw" in variants:
        big = torch.ones(1 << 28, dtype=torch.float32, device=device)
        ms = time_ms(lambda: big.sum(), device, repeats)
        res["bw_read_GBps"] = big.numel() * 4 / (ms * 1e-3) / 1e9


def result_name(variant: str) -> str:
    """The result's name of a timed variant, as the TPU tool names it:
    ``{name}_ms`` and ``{name}_useful_tflops`` in the JSON line."""
    kind, *tiling = variant.split("_")
    if variant in ("v1", "v2sum"):
        return f"{variant}_bf16"
    if kind in ("v2", "v2b", "v3", "v3b", "v2s") and len(tiling) == 2:
        m, t_chunk = (int(x) for x in tiling)
        return f"{kind}_bf16_{m}_{t_chunk}"
    if kind == "v2i" and len(tiling) == 1:
        return f"v2i_int8_{int(tiling[0])}_16"
    raise ValueError(f"unknown variant {variant!r}")


def run(args) -> dict:
    device = torch.device(args.device)
    variants = args.variants.split(",")
    for v in variants:
        if v not in RULERS:
            result_name(v)

    capbuf = bench_capture(args.samples)
    n_lags = capbuf.shape[0] - (PSS_TD_LEN - 1)
    f_set = default_f_search_set(FC, args.ppm)
    tmpl = pss_templates(f_set, FC, FC, FS_WORK).reshape(-1, PSS_TD_LEN)
    n_t = tmpl.shape[0]
    useful = 8.0 * n_t * n_lags * PSS_TD_LEN
    res = {"device": device_name(device), "n_templates": n_t,
           "n_lags": n_lags, "repeats": args.repeats,
           "useful_gflop_per_call": useful / 1e9}
    if args.skip_rulers:
        res["rulers_skipped"] = [v for v in variants if v in RULERS]
    else:
        _rulers(res, variants, device, args.repeats)

    cap = torch.from_numpy(capbuf.astype(np.complex64)).to(device)
    cap_b = corr_cuda.capture_planes_bf16(cap)
    taps_b = corr_cuda.template_planes_bf16(tmpl, device)

    def add(name, fn):
        _finite(fn(), name)
        ms = time_ms(fn, device, args.repeats)
        res[f"{name}_ms"] = ms
        res[f"{name}_useful_tflops"] = useful / (ms * 1e-3) / 1e12

    for v in variants:
        if v in RULERS:
            continue
        kind, *tiling = v.split("_")
        name = result_name(v)
        if v == "v2sum":
            packed = corr_cuda.pack_map_taps(taps_b)
            add(name, lambda packed=packed: corr_cuda.corr_pow_sum_bf16(
                cap_b, taps_b, n_lags, packed))
        elif kind == "v2s":
            add(name, lambda t_chunk=int(tiling[1]):
                corr_cuda.corr_pow_bf16_per_chunk(cap_b, taps_b, n_lags,
                                                  t_chunk))
        elif kind == "v2i":
            cap_i = corr_cuda.capture_planes_int8(torch.from_numpy(
                adc_quantize(capbuf).astype(np.complex64)).to(device))
            taps_i, _scale = corr_cuda.template_planes_int8(tmpl, device)
            packed = corr_cuda.pack_map_taps(taps_i)
            inv = corr_cuda.probe_inv(tmpl)
            add(name, lambda cap_i=cap_i, taps_i=taps_i, inv=inv,
                packed=packed: corr_cuda.corr_pow_int8_scaled(
                    cap_i, taps_i, n_lags, inv, packed))
        else:
            # the front end's routes: v1, v2 and v3 with bf16 operands
            kern = {"v1": lambda: v1_operands(tmpl, "bf16", device),
                    "v2": lambda: KernelOperands("bf16", taps_b, None,
                                                 torch.float32),
                    "v2b": lambda: KernelOperands("bf16", taps_b, None),
                    "v3": lambda: v3_operands(tmpl, device, torch.float32),
                    "v3b": lambda: v3_operands(tmpl, device,
                                               torch.bfloat16)}[kind]()
            add(name, lambda kern=kern: corr_cuda.corr_pow_bf16(
                cap_b, kern.taps, n_lags, kern.out_dtype, kern.packed))
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ppm", type=float, default=100.0)
    ap.add_argument("--repeats", type=int, default=10,
                    help="timed windows per variant")
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--samples", type=int, default=None,
                    help="capture samples (default: all 153600)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-rulers", action="store_true",
                    help="leave out the peak and bw probes")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
