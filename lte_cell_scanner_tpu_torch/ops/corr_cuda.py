"""PSS correlation-power kernels (CUDA, ``csrc/pss_corr.cu``) and their
plain PyTorch versions.

The counterpart of the TPU package's production v2 correlation route
(``ops/corr_pallas.py::corr_pow_core_v2`` with ``post="xla"``): for all
T = 3 * n_f templates and all lags, p[t, l] = |sum_m tmpl[t, m] *
cap[l + m]|^2 as a bf16 [T, n_lags] map.

- ``corr_pow_bf16`` replaces ``_corr_kernel_v2``: bf16 operands, f32
  accumulation.  Float and simulated captures.
- ``corr_pow_int8`` replaces ``_corr_kernel_v2_int8``: int8 operands,
  exact integer accumulation, UNSCALED output; ``template_planes_int8``
  returns the power scale the caller applies after the fold.  Captures
  on the 8-bit ADC grid (``is_adc_grid``).

Each wrapper launches its kernel for CUDA tensors (raising on any launch
error) and takes the plain version only for CPU tensors.  ``LAUNCHES``
counts kernel launches per wrapper, for these two kernels and the fused
correlation-plus-fold kernels of ``ops/corr_fold_cuda.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import PSS_TD_LEN

LAUNCHES = {"pss_corr_bf16": 0, "pss_corr_int8": 0,
            "pss_corr_fold_bf16": 0, "pss_corr_fold_int8": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def is_adc_grid(capbuf, tol: float = 1e-5) -> bool:
    """True when every sample sits on the reference dongle's
    (x - 127)/128 8-bit grid (capbuf.cpp:174) with |k| <= 128 -- the
    precondition for the int8 correlation route.

    The positive full-scale code k = +128 (a saturated ADC sample) is
    not int8-representable and the int8 quantizer clips it to 127: a
    1-LSB error on exactly the saturated samples, far below the ~0.4%
    template quantization that already bounds the route's accuracy.
    Host-side numpy check, made before the capture is uploaded."""
    c = np.asarray(capbuf)
    for p in (c.real, c.imag):
        k = p * 128.0
        if np.max(np.abs(k)) > 128.0 + tol:
            return False
        if np.max(np.abs(k - np.round(k))) > tol:
            return False
    return True


# ---------------------------------------------------------------------------
# Operand quantizers
# ---------------------------------------------------------------------------

def _planes_f32(templates) -> np.ndarray:
    tf = np.asarray(templates).reshape(-1, PSS_TD_LEN).astype(np.complex64)
    return np.stack([tf.real, tf.imag])                    # [2, T, 137] f32


def template_planes_bf16(templates, device) -> torch.Tensor:
    """[T, 137] complex templates -> bf16 (re, im) planes [2, T, 137],
    rounded through complex64 as the TPU band builder does."""
    return torch.from_numpy(_planes_f32(templates)).to(
        device=device, dtype=torch.bfloat16)


def template_planes_int8(templates, device):
    """(int8 planes [2, T, 137], power_scale): taps round(t * s_g) with
    s_g = 127 / max(|Re|, |Im|) over all templates (the same s_g as the
    TPU package's bands_v2_int8_for_templates), and power_scale =
    (1 / (s_g * 128))^2, which undoes both the tap and the capture
    quantization in one multiply on powers."""
    planes = _planes_f32(templates)
    s_g = 127.0 / float(np.max(np.abs(planes)))
    q = np.clip(np.round(planes * s_g), -127, 127).astype(np.int8)
    scale = np.float32((1.0 / (s_g * 128.0)) ** 2)
    return torch.from_numpy(q).to(device), scale


def capture_planes_bf16(capbuf: torch.Tensor) -> torch.Tensor:
    """Complex capture [..., n] -> bf16 (re, im) planes [..., 2, n]
    (through f32)."""
    return torch.stack([capbuf.real, capbuf.imag], dim=-2).float() \
        .to(torch.bfloat16).contiguous()


def capture_planes_int8(capbuf: torch.Tensor) -> torch.Tensor:
    """ADC-grid capture [..., n] -> int8 planes [..., 2, n]: k =
    clip(round(128 x), -127, 127), round half to even (the saturated +128
    clips to 127)."""
    p = torch.stack([capbuf.real, capbuf.imag], dim=-2).float()
    return torch.clamp(torch.round(p * 128.0), -127.0, 127.0) \
        .to(torch.int8).contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _re_im(cap: torch.Tensor, taps: torch.Tensor, n_lags: int):
    """(Re, Im) of the correlation as two [T, n_lags] matrix products of
    the [n_lags, 274] window matrix [cap_re | cap_im]."""
    win = torch.cat([cap[0].unfold(0, PSS_TD_LEN, 1)[:n_lags],
                     cap[1].unfold(0, PSS_TD_LEN, 1)[:n_lags]], dim=1)
    w_re = torch.cat([taps[0], -taps[1]], dim=1)           # [T, 274]
    w_im = torch.cat([taps[1], taps[0]], dim=1)
    return w_re @ win.T, w_im @ win.T


def corr_pow_bf16_plain(cap: torch.Tensor, taps: torch.Tensor,
                        n_lags: int) -> torch.Tensor:
    """Plain version of the bf16 kernel: the bf16 operands widened to
    f32, f32 accumulation (TF32 must be off for CUDA matmuls, which is
    PyTorch's default), re^2 + im^2 rounded to bf16."""
    re, im = _re_im(cap.float(), taps.float(), n_lags)
    return (re * re + im * im).to(torch.bfloat16)


def corr_pow_int8_plain(cap: torch.Tensor, taps: torch.Tensor,
                        n_lags: int) -> torch.Tensor:
    """Plain version of the int8 kernel: integer-exact sums (float64
    holds every partial sum, all integers below 2^23, exactly), cast to
    f32, then re*re + im*im as separate f32 operations and a bf16 store
    -- the kernel's rounding, bit for bit."""
    re, im = _re_im(cap.double(), taps.double(), n_lags)
    re = re.float()
    im = im.float()
    return (re * re + im * im).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from ..cuda_build import load
        lib = load("pss_corr")
        for fn in (lib.pss_corr_bf16, lib.pss_corr_int8):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cap: torch.Tensor, taps: torch.Tensor, n_lags: int,
           dtype: torch.dtype) -> None:
    if cap.device != taps.device:
        raise ValueError("capture and templates must be on one device")
    if cap.dtype != dtype or taps.dtype != dtype:
        raise TypeError(f"expected {dtype} operands, got {cap.dtype} and "
                        f"{taps.dtype}")
    if cap.dim() != 2 or cap.shape[0] != 2:
        raise ValueError(f"capture planes must be [2, n], got "
                         f"{tuple(cap.shape)}")
    if taps.dim() != 3 or taps.shape[0] != 2 or taps.shape[2] != PSS_TD_LEN:
        raise ValueError(f"template planes must be [2, T, {PSS_TD_LEN}], got "
                         f"{tuple(taps.shape)}")
    if not 0 < n_lags <= cap.shape[1] - (PSS_TD_LEN - 1):
        raise ValueError(f"n_lags={n_lags} does not fit a capture of "
                         f"{cap.shape[1]} samples")
    if not (cap.is_contiguous() and taps.is_contiguous()):
        raise ValueError("operands must be contiguous")


def _launch(name: str, cap: torch.Tensor, taps: torch.Tensor,
            n_lags: int) -> torch.Tensor:
    if cap.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {cap.device}")
    out = torch.empty((taps.shape[1], n_lags), dtype=torch.bfloat16,
                      device=cap.device)
    with torch.cuda.device(cap.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_kernels(), name)(
            cap.data_ptr(), taps.data_ptr(), out.data_ptr(),
            int(cap.shape[1]), int(taps.shape[1]), int(n_lags), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def corr_pow_bf16(cap: torch.Tensor, taps: torch.Tensor,
                  n_lags: int) -> torch.Tensor:
    """bf16 correlation-power map [T, n_lags] from bf16 capture planes
    [2, n] and template planes [2, T, 137]."""
    _check(cap, taps, n_lags, torch.bfloat16)
    if cap.device.type == "cpu":
        return corr_pow_bf16_plain(cap, taps, n_lags)
    return _launch("pss_corr_bf16", cap, taps, n_lags)


def corr_pow_int8(cap: torch.Tensor, taps: torch.Tensor,
                  n_lags: int) -> torch.Tensor:
    """UNSCALED int8 correlation-power map [T, n_lags] (bf16) from int8
    capture planes [2, n] and template planes [2, T, 137]."""
    _check(cap, taps, n_lags, torch.int8)
    if cap.device.type == "cpu":
        return corr_pow_int8_plain(cap, taps, n_lags)
    return _launch("pss_corr_int8", cap, taps, n_lags)
