"""Fused PSS correlation + k_factor fold kernels (CUDA,
``csrc/pss_corr_fold.cu``), their plain PyTorch versions, the operand
packing the kernels read, and the host gate that routes a band scan to
them.

The counterpart of the TPU package's v4 route
(``ops/corr_pallas.py::corr_fold_core_v4``): for C carriers sharing one
[n_f, n_comb] fold-start table s (the band's middle carrier) and the
T = 3 * n_f templates (template t reads row t mod n_f), the RAW folded
power sums

    out[c, t, l] = sum_m |sum_k tap[t, k] * x[c, s[t mod n_f, m] + l + k]|^2

for l in [0, 9600), x reading as zero outside the capture.  The caller
multiplies by f32(1 / n_comb), times the int8 power scale.

- ``corr_fold_bf16`` replaces ``_corr_kernel_v4``: bf16 operands, f32
  products and sums (``mma.sync`` m16n8k16 bf16 -> f32).
- ``corr_fold_int8`` replaces ``_corr_kernel_v4_int8``: int8 operands
  (the quantizers of ``ops/corr_cuda.py``), exact int32 period sums
  (``mma.sync`` m16n8k32 s8 -> s32) cast to f32 before squaring.

Each period's power is fma(re, re, im * im), one rounding for the sum,
as the TPU kernel's ``xr * xr + xi * xi`` is contracted where the TPU
package's tests run it (the Pallas interpreter); the int8 route then
equals the interpreted TPU kernel bit for bit.

The kernels compute each hypothesis's correlation as a real product on
the tensor cores: a Hankel A [lag, 288] of the capture (K interleaves Re
and Im of 144 taps, the last 7 zero) times B [288, 8] holding Re and Im
columns of the hypothesis's three PSS (columns 6-7 zero), 71% of it
useful work.  The wrapper builds both operands before the launch:
``pack_fold_taps`` (B, column-major, as the kernel's fragments read it)
and ``capture_words`` (one 32-bit word per sample, the layout the kernel
stages with 16-byte ``cp.async`` copies; defined in ``ops/corr_cuda.py``,
whose map kernels read the same words).  Both are part of each wrapper
call.

Each wrapper launches its kernel for CUDA tensors (raising on any launch
error, and with a ``ValueError`` before the launch when the start table
spreads past what a block stages) and takes the plain version only for
CPU tensors; launches count in ``corr_cuda.LAUNCHES``.

The host gate (``v4_kv_for`` and its helpers, numpy copies of the TPU
package's) decides between this fused route and the v2 kernels with the
exact per-carrier fold, as the TPU package does.  The kv window widths
(256/384) are the TPU kernel's row windows; the CUDA kernel reads the
start table directly and takes no window argument.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import HALF_FRAME_LEN, PSS_TD_LEN
from . import corr_cuda
# shared with the map kernels; re-exported for this module's callers
from .corr_cuda import TAPS_PAD, capture_words  # noqa: F401

W_V4 = 80                # lags per row of the TPU kernel
KV_V2 = 256              # its default row window
KV_V4_WIDE = 384         # its wide row window (long captures)
# the CUDA kernel's block (csrc/pss_corr_fold.cu: kWarps, kTileLags)
_HYP_PER_BLOCK = 4       # hypotheses per block, one per warp
_TILE_LAGS = 256         # fold-output lags per block
# a block's span at zero start spread: 256 lags + 143 taps, and up to 3
# words that align its first 16-byte copy
_SPAN_BASE = 3 + _TILE_LAGS + TAPS_PAD - 1
_SPAN_MAX = 4096         # words per span: two spans in 32 KB of shared memory


# ---------------------------------------------------------------------------
# Host gate (corr_pallas.py:626-672)
# ---------------------------------------------------------------------------

def v4_back_shift(kv: int = KV_V2) -> int:
    """Centered base back-shift B of a K-sample row window: the delta
    window is [-B, (K - 216) - B] (216 = 79 lags + 137 taps)."""
    return (kv - (W_V4 - 1) - PSS_TD_LEN) // 2


def delta_table(start_idx: np.ndarray) -> np.ndarray:
    """[n_f, n_comb] fold deviations delta(f, m) = start_idx(f, m) -
    9600 m."""
    start_idx = np.asarray(start_idx)
    m = np.arange(start_idx.shape[1], dtype=np.int64)
    return start_idx.astype(np.int64) - HALF_FRAME_LEN * m[None, :]


def v4_applicable(start_idx, kv: int = KV_V2, margin: int = 0) -> bool:
    """True when every fold deviation fits the delta window of a K = kv
    row span, shrunk by ``margin`` samples at each end (the multi-process
    band gates at margin 1, so that ranks whose middle carriers differ
    cannot disagree near the window's edge)."""
    b = v4_back_shift(kv)
    d = delta_table(start_idx)
    return bool(d.min() >= -b + margin
                and d.max() <= (kv - (W_V4 - 1) - PSS_TD_LEN) - b - margin)


def v4_kv_for(start_idx, margin: int = 0):
    """The narrowest row window whose delta window, shrunk by
    ``margin``, admits this fold-start table (256, then 384), or None:
    the v2 route."""
    for kv in (KV_V2, KV_V4_WIDE):
        if v4_applicable(start_idx, kv=kv, margin=margin):
            return kv
    return None


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _fold_plain(cap: torch.Tensor, taps: torch.Tensor, starts: torch.Tensor,
                exact: bool) -> torch.Tensor:
    """Per carrier: the correlation of ``corr_cuda._re_im`` over a
    zero-padded capture, the period power fma(re, re, im * im) in f32,
    and the f32 fold in period order at the shared start table."""
    n_c, _, n_cap = cap.shape
    n_f, n_comb = starts.shape
    st = starts.to(device=cap.device, dtype=torch.int64)
    lo = min(0, int(st.min()))
    hi = max(n_cap, int(st.max()) + HALF_FRAME_LEN + PSS_TD_LEN - 1)
    rows = st.repeat(taps.shape[1] // n_f, 1) - lo          # [T, n_comb]
    lags = torch.arange(HALF_FRAME_LEN, device=cap.device)
    wdt = torch.float64 if exact else torch.float32
    w = taps.to(wdt)
    out = torch.empty((n_c, taps.shape[1], HALF_FRAME_LEN),
                      dtype=torch.float32, device=cap.device)
    for c in range(n_c):
        x = torch.zeros((2, hi - lo), dtype=wdt, device=cap.device)
        x[:, -lo: n_cap - lo] = cap[c]
        re, im = corr_cuda._re_im(x, w, hi - lo - (PSS_TD_LEN - 1))
        re = re.float()
        im = im.float()
        # fma(re, re, im*im): re^2 is exact in float64 and so is its sum
        # with the f32 im*im when both are integers (the int8 route), so
        # the one rounding to f32 is the fused one
        p = (re.double() * re.double() + (im * im).double()).float()
        acc = torch.zeros_like(out[c])
        for m in range(n_comb):
            acc = acc + torch.gather(p, 1, rows[:, m, None] + lags)
        out[c] = acc
    return out


def corr_fold_bf16_plain(cap: torch.Tensor, taps: torch.Tensor,
                         starts: torch.Tensor) -> torch.Tensor:
    """Plain version of the bf16 kernel: f32 products of the bf16
    operands widened to f32 (TF32 must be off for CUDA matmuls, which is
    PyTorch's default), f32 fold."""
    return _fold_plain(cap, taps, starts, exact=False)


def corr_fold_int8_plain(cap: torch.Tensor, taps: torch.Tensor,
                         starts: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 kernel: integer-exact sums (float64
    holds every one exactly), cast to f32, then the kernel's roundings --
    bit for bit."""
    return _fold_plain(cap, taps, starts, exact=True)


# ---------------------------------------------------------------------------
# Kernel operands
# ---------------------------------------------------------------------------

def pack_fold_taps(taps: torch.Tensor) -> torch.Tensor:
    """Template planes [2, 3 n_f, 137] (bf16 or int8) -> the kernel's B
    operand [n_f, 8, 288] of the same type: for hypothesis f, column n and
    K index 2k + c (tap k < 144, c = 0 for the capture's Re, 1 for its
    Im), column 2p is Re and column 2p + 1 is Im of PSS p:

        B[f, 2p, 2k] = tr,  B[f, 2p, 2k + 1] = -ti,
        B[f, 2p + 1, 2k] = ti,  B[f, 2p + 1, 2k + 1] = tr

    of template p n_f + f.  Columns 6-7 and taps 137-143 are zero.  Each
    column is contiguous (the "col" B of ``mma.sync``), so one fragment
    register is one aligned 32-bit load.  The int8 taps are clipped to
    +-127, so the negation is exact."""
    n_f = taps.shape[1] // 3
    tr = taps[0].reshape(3, n_f, PSS_TD_LEN).transpose(0, 1)   # [f, p, k]
    ti = taps[1].reshape(3, n_f, PSS_TD_LEN).transpose(0, 1)
    b = taps.new_zeros((n_f, 4, 2, TAPS_PAD, 2))     # [f, p, re/im col, k, c]
    b[:, :3, 0, :PSS_TD_LEN, 0] = tr
    b[:, :3, 0, :PSS_TD_LEN, 1] = -ti
    b[:, :3, 1, :PSS_TD_LEN, 0] = ti
    b[:, :3, 1, :PSS_TD_LEN, 1] = tr
    return b.reshape(n_f, 8, 2 * TAPS_PAD)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from ..cuda_build import load
        lib = load("pss_corr_fold")
        for fn in (lib.pss_corr_fold_bf16, lib.pss_corr_fold_int8):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cap: torch.Tensor, taps: torch.Tensor, starts: torch.Tensor,
           dtype: torch.dtype) -> None:
    if not cap.device == taps.device == starts.device:
        raise ValueError("capture, templates and starts must be on one "
                         "device")
    if cap.dtype != dtype or taps.dtype != dtype:
        raise TypeError(f"expected {dtype} operands, got {cap.dtype} and "
                        f"{taps.dtype}")
    if starts.dtype != torch.int32:
        raise TypeError(f"starts must be int32, got {starts.dtype}")
    if cap.dim() != 3 or cap.shape[1] != 2 or cap.shape[0] < 1:
        raise ValueError(f"capture planes must be [C, 2, n], got "
                         f"{tuple(cap.shape)}")
    if starts.dim() != 2 or min(starts.shape) < 1:
        raise ValueError(f"starts must be [n_f, n_comb], got "
                         f"{tuple(starts.shape)}")
    if taps.dim() != 3 or taps.shape[0] != 2 \
            or taps.shape[1] != 3 * starts.shape[0] \
            or taps.shape[2] != PSS_TD_LEN:
        raise ValueError(f"template planes must be [2, 3 * n_f, "
                         f"{PSS_TD_LEN}] for n_f = {starts.shape[0]}, got "
                         f"{tuple(taps.shape)}")
    if not (cap.is_contiguous() and taps.is_contiguous()
            and starts.is_contiguous()):
        raise ValueError("operands must be contiguous")


def _span_capacity(starts: torch.Tensor) -> int:
    """Words one block stages per period (a multiple of 4): a lag
    tile's span plus the largest start spread over the hypotheses of any
    block.  Raises ValueError past the kernel's ``_SPAN_MAX``."""
    n_f, n_comb = starts.shape
    pad = -n_f % _HYP_PER_BLOCK
    st = starts.to(torch.int64)
    if pad:
        st = torch.cat([st, st[-1:].expand(pad, n_comb)])
    st = st.reshape(-1, _HYP_PER_BLOCK, n_comb)
    spread = int((st.amax(dim=1) - st.amin(dim=1)).max())
    span = -(-(_SPAN_BASE + spread) // 4) * 4
    if span > _SPAN_MAX:
        raise ValueError(f"fold starts spread over {spread} samples within "
                         f"{_HYP_PER_BLOCK} hypotheses; the kernel stages "
                         f"at most {_SPAN_MAX - _SPAN_BASE}")
    return span


def _launch(name: str, cap: torch.Tensor, taps: torch.Tensor,
            starts: torch.Tensor) -> torch.Tensor:
    if cap.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {cap.device}")
    n_c = cap.shape[0]
    n_f, n_comb = starts.shape
    span = _span_capacity(starts)
    words = capture_words(cap)
    b = pack_fold_taps(taps)
    out = torch.empty((n_c, taps.shape[1], HALF_FRAME_LEN),
                      dtype=torch.float32, device=cap.device)
    with torch.cuda.device(cap.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_kernels(), name)(
            words.data_ptr(), b.data_ptr(), starts.data_ptr(),
            out.data_ptr(), int(n_c), int(words.shape[1]), int(n_f),
            int(n_comb), int(span), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    corr_cuda.LAUNCHES[name] += 1
    return out


def corr_fold_bf16(cap: torch.Tensor, taps: torch.Tensor,
                   starts: torch.Tensor) -> torch.Tensor:
    """Raw folded powers [C, T, 9600] (f32) from bf16 capture planes
    [C, 2, n], bf16 template planes [2, T, 137] and the shared int32
    fold-start table [n_f, n_comb] (T = 3 n_f)."""
    _check(cap, taps, starts, torch.bfloat16)
    if cap.device.type == "cpu":
        return corr_fold_bf16_plain(cap, taps, starts)
    return _launch("pss_corr_fold_bf16", cap, taps, starts)


def corr_fold_int8(cap: torch.Tensor, taps: torch.Tensor,
                   starts: torch.Tensor) -> torch.Tensor:
    """UNSCALED raw folded powers [C, T, 9600] (f32) from int8 capture
    planes [C, 2, n], int8 template planes [2, T, 137] and the shared
    int32 fold-start table [n_f, n_comb] (T = 3 n_f)."""
    _check(cap, taps, starts, torch.int8)
    if cap.device.type == "cpu":
        return corr_fold_int8_plain(cap, taps, starts)
    return _launch("pss_corr_fold_int8", cap, taps, starts)
