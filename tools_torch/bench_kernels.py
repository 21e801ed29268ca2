"""A/B of the port's correlation front end on one NVIDIA GPU: the
counterpart of tools/bench_kernels.py (the exact correlation against the
kernel routes, and the front end on each).

    python3 tools_torch/bench_kernels.py [--ppm 100] [--repeats 10]
        [--variants front_lean,exact_pow,...] [--samples N]
        [--device cuda|cpu] [--parity-only]

Variants (default +-100 ppm grid, 93 templates, the port's two-cell
739 MHz capture, seed 0):

  front_lean     the front end as ``xcorr_core(lean=True)`` on the
                 production v2 route (bf16 map: pss_corr_bf16): correlation,
                 k_factor fold, delay spread, collapse, sp_est and the
                 refinement slab
  exact_pow      ``ops/corr.correlate`` ("dot", complex64 on the card) and
                 |.|^2: the TPU tool's xla_pow
  v1_f32         the v1 route's map with f32 operands: pss_corr_f32 (CUDA
                 cores)
  v1_bf16        the v1 route's map with bf16 operands: pss_corr_bf16_f32out
                 (tensor cores, the taps packed once)
  front_lean_v1  ``xcorr_core(lean=True)`` with v1 bf16 operands
  sharded_1x1    the (t x f) front end of ``parallel/sharded.py`` on a
                 (1 x 1) grid (halo, block fold, collapse, sp_incoherent
                 and the pre-delay-spread fold), exact correlation: what
                 the grid's bookkeeping costs beside front_lean
  sharded_1x1_kernel  the same with the grid's kernel operands
                 (pss_corr_bf16 on the 280-sample halo-extended block)

Each time is the median over --repeats windows of 5 back-to-back calls
timed with CUDA events after a warm-up (on the CPU: the host clock around
one call); ``{name}_useful_tflops`` counts 8 T n_lags 137 operations per
call.  TF32 is off.  --parity-only prints instead each kernel route's max
|error| against exact_pow over exact_pow's max (v1_f32, v1_bf16, and v2
bf16, the production map), and exits non-zero when one exceeds its bar:
1e-4 for f32 operands, 2e-2 for bf16 (tests/test_xcorr.py:195).  A
variant that fails raises, so the process exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from lte_cell_scanner_tpu_torch.constants import FS_WORK, PSS_TD_LEN  # noqa: E402
from lte_cell_scanner_tpu_torch.models.search import default_f_search_set  # noqa: E402
from lte_cell_scanner_tpu_torch.models.xcorr import (  # noqa: E402
    _front_staging, v1_operands, xcorr_core)
from lte_cell_scanner_tpu_torch.ops import corr_cuda  # noqa: E402
from lte_cell_scanner_tpu_torch.ops.corr import correlate  # noqa: E402
from tools_torch.bench_corr_v2 import (FC, bench_capture,  # noqa: E402
                                       device_name, time_ms)

VARIANTS = ("front_lean", "exact_pow", "v1_f32", "v1_bf16", "front_lean_v1",
            "sharded_1x1", "sharded_1x1_kernel")
PARITY_BARS = {"v1_f32": 1e-4, "v1_bf16": 2e-2, "v2_bf16": 2e-2}
DS_COMB_ARM = 2


def _sharded(capbuf: np.ndarray, f_set, device, kernel: bool):
    """The (1 x 1) grid's front end with its aux outputs, the capture
    padded and on the device once."""
    from lte_cell_scanner_tpu_torch.device import to_capture
    from lte_cell_scanner_tpu_torch.parallel.sharded import (
        make_mesh, plan_sharded_bands, plan_sharded_inputs, sharded_xcorr)
    grid = make_mesh(1, 1, [device])
    padded, tmpl, starts, n_comb_xc, n_lags = plan_sharded_inputs(
        capbuf, f_set, FC, FC, FS_WORK, grid, dtype=np.complex64)
    padded = to_capture(padded, device)
    n_comb_sp = (len(capbuf) - 136 - 137) // 9600
    bands = plan_sharded_bands(tmpl, grid) if kernel else ()
    return lambda: sharded_xcorr(grid, padded, tmpl, starts, DS_COMB_ARM,
                                 n_comb_xc, n_lags, n_comb_sp, bands)


def _setup(args):
    device = torch.device(args.device)
    capbuf = bench_capture(args.samples)
    f_set = default_f_search_set(FC, args.ppm)
    cap_t, templates, starts, kern, _n = _front_staging(
        capbuf, f_set, FC, FC, FS_WORK, "kernel", device, None, True)
    cap_t = cap_t.to(torch.complex64)
    if kern.precision != "bf16":
        raise RuntimeError("the bench capture must take the bf16 route")
    tmpl_flat = templates.reshape(-1, PSS_TD_LEN).to(torch.complex64)
    v1 = {p: v1_operands(tmpl_flat.cpu().numpy(), p, device)
          for p in ("f32", "bf16")}
    return device, cap_t, tmpl_flat, starts, kern, v1


def _maps(cap_t, tmpl_flat, kern, v1):
    """Each route's correlation-power map, as functions of no argument."""
    n_lags = cap_t.shape[0] - (PSS_TD_LEN - 1)
    cap_f = corr_cuda.capture_planes_f32(cap_t)
    cap_b = corr_cuda.capture_planes_bf16(cap_t)

    def exact_pow():
        xc = correlate(cap_t, tmpl_flat)
        return xc.real ** 2 + xc.imag ** 2
    return {"exact_pow": exact_pow,
            "v1_f32": lambda: corr_cuda.corr_pow_f32(cap_f, v1["f32"].taps,
                                                     n_lags),
            "v1_bf16": lambda: corr_cuda.corr_pow_bf16(
                cap_b, v1["bf16"].taps, n_lags, torch.float32,
                v1["bf16"].packed),
            "v2_bf16": lambda: corr_cuda.corr_pow_bf16(
                cap_b, kern.taps, n_lags, packed=kern.packed)}


def parity(args) -> dict:
    device, cap_t, tmpl_flat, _starts, kern, v1 = _setup(args)
    maps = _maps(cap_t, tmpl_flat, kern, v1)
    ref = maps.pop("exact_pow")().double()
    scale = float(ref.max())
    res = {"device": device_name(device)}
    for name, fn in maps.items():
        res[f"{name}_maxerr"] = float((fn().double() - ref).abs().max()) \
            / scale
    return res


def run(args) -> dict:
    variants = args.variants.split(",")
    for v in variants:
        if v not in VARIANTS:
            raise ValueError(f"unknown variant {v!r}")
    device, cap_t, tmpl_flat, starts, kern, v1 = _setup(args)
    n_lags = cap_t.shape[0] - (PSS_TD_LEN - 1)
    useful = 8.0 * tmpl_flat.shape[0] * n_lags * PSS_TD_LEN
    res = {"device": device_name(device), "n_templates": tmpl_flat.shape[0],
           "n_lags": n_lags, "repeats": args.repeats}

    def front(k):
        return lambda: xcorr_core(cap_t, None, starts, DS_COMB_ARM, False,
                                  True, k)
    capbuf = bench_capture(args.samples)
    f_set = default_f_search_set(FC, args.ppm)
    fns = dict(_maps(cap_t, tmpl_flat, kern, v1),
               front_lean=front(kern), front_lean_v1=front(v1["bf16"]),
               sharded_1x1=_sharded(capbuf, f_set, device, False),
               sharded_1x1_kernel=_sharded(capbuf, f_set, device, True))
    for v in variants:
        out = fns[v]()
        outs = out if isinstance(out, tuple) else (out,)
        for o in outs:
            if o is not None and not bool(torch.isfinite(o.float()).all()):
                raise RuntimeError(f"{v}: non-finite output")
        ms = time_ms(fns[v], device, args.repeats)
        res[f"{v}_ms"] = ms
        res[f"{v}_tflops"] = useful / (ms * 1e-3) / 1e12
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ppm", type=float, default=100.0)
    ap.add_argument("--repeats", type=int, default=10,
                    help="timed windows per variant")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--samples", type=int, default=None,
                    help="capture samples (default: all 153600)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parity-only", action="store_true",
                    help="only each kernel route's max error against "
                         "exact_pow")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.parity_only:
        print(json.dumps(run(args)), flush=True)
        return 0
    res = parity(args)
    print(json.dumps(res), flush=True)
    bad = [k for k, bar in PARITY_BARS.items() if not
           res[f"{k}_maxerr"] <= bar]
    if bad:
        print(f"FAIL: parity beyond the bar for {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
