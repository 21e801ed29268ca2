"""PSS correlation-power kernels (CUDA, ``csrc/pss_corr.cu``) and their
plain PyTorch versions.

The counterpart of the TPU package's correlation routes that produce the
[template, lag] power map (``ops/corr_pallas.py``): for all T = 3 * n_f
templates and all lags, p[t, l] = |sum_m tmpl[t, m] * cap[l + m]|^2.

- ``corr_pow_bf16`` replaces ``_corr_kernel_v2`` (the production route,
  bf16 map: ``pss_corr_bf16``) and ``_corr_kernel_v3``: bf16 operands,
  f32 accumulation; ``out_dtype=torch.float32`` (``pss_corr_bf16_f32out``)
  is v1 with bf16 bands and v3 with f32 output.  Float and simulated
  captures.
- ``corr_pow_f32`` replaces v1 (``_corr_kernel``) and v2 with f32 bands:
  f32 operands and sums, f32 map.
- ``corr_pow_int8`` replaces ``_corr_kernel_v2_int8``: int8 operands,
  exact integer accumulation, UNSCALED output; ``template_planes_int8``
  returns the power scale the caller applies after the fold.  Captures
  on the 8-bit ADC grid (``is_adc_grid``).
- ``corr_pow_int8_scaled`` replaces the int8 probe of
  ``tools/bench_corr_v2.py`` (``_kern_i8``): the int8 map times the power
  scale inside the kernel.
- ``corr_pow_sum_bf16`` replaces that tool's ``_sum_kernel``: the bf16 map
  summed in the kernel, no map written.
- ``corr_pow_bf16_per_chunk`` is that tool's per-chunk probe: the bf16
  kernel launched once per chunk of templates.

Every map of bf16 or int8 operands (``pss_corr_bf16``,
``pss_corr_bf16_f32out``, ``pss_corr_int8``, ``pss_corr_int8_scaled``)
runs on the tensor cores: one kernel template, the Hankel product of
``csrc/hankel_mma.cuh`` (shared with the fused kernels of
``ops/corr_fold_cuda.py``) of the capture's 32-bit words
(``capture_words``) and the packed taps of four templates per n8 column
group (``pack_map_taps``), with the entry point's epilogue.  The wrapper
builds the words for each call and packs the taps unless the caller
passes them packed (``KernelOperands.packed`` in ``models/xcorr.py``
packs them once).  ``pss_corr_f32`` and ``pss_corr_sum_bf16`` take
(re, im) planes and run on the CUDA cores.

Each wrapper launches its kernel for CUDA tensors (raising on any launch
error) and takes the plain version only for CPU tensors.  ``LAUNCHES``
counts kernel launches per wrapper, for these kernels and the fused
correlation-plus-fold kernels of ``ops/corr_fold_cuda.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import PSS_TD_LEN

LAUNCHES = {"pss_corr_bf16": 0, "pss_corr_int8": 0,
            "pss_corr_f32": 0, "pss_corr_bf16_f32out": 0,
            "pss_corr_int8_scaled": 0, "pss_corr_sum_bf16": 0,
            "pss_corr_bf16_per_chunk": 0,
            "pss_corr_fold_bf16": 0, "pss_corr_fold_int8": 0}

# The sum probe's TPU geometry (tools/bench_corr_v2.py:205-239): rows of
# W = 120 lags in row blocks of 128 rows, templates in chunks of 16, and
# the first 8 lags of each row (the (8, 128) output tile's sublanes).
SUM_ROW_LAGS = 120
SUM_BLOCK_LAGS = 128 * SUM_ROW_LAGS
SUM_T_CHUNK = 16
SUM_COLS = 8

# The tensor-core kernels' operands (csrc/hankel_mma.cuh: kTapsPad, kGuard)
TAPS_PAD = 144           # taps per template on the K axis (7 zero)
_GUARD = 4               # zero words before sample 0
MAP_GROUP = 4            # templates per n8 column group of the map kernels


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


def template_planes_f32(templates, device) -> torch.Tensor:
    """[T, 137] complex templates -> f32 (re, im) planes [2, T, 137],
    through complex64 as the TPU package's band matrices are."""
    return torch.from_numpy(_planes_f32(templates)).to(device)


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


def probe_inv(templates) -> np.float32:
    """The int8 probe's power scale (tools/bench_corr_v2.py:349-352):
    (1 / (128 s_g))^2 with s_g and the square taken in f32, as the probe
    takes them (one f32 step from template_planes_int8's scale at most)."""
    s_g = 127.0 / np.max(np.abs(_planes_f32(templates)))
    return np.float32(1.0 / (128.0 * s_g)) ** 2


def capture_planes_f32(capbuf: torch.Tensor) -> torch.Tensor:
    """Complex capture [..., n] -> f32 (re, im) planes [..., 2, n]."""
    return torch.stack([capbuf.real, capbuf.imag], dim=-2).float() \
        .contiguous()


def capture_planes_bf16(capbuf: torch.Tensor) -> torch.Tensor:
    """Complex capture [..., n] -> bf16 (re, im) planes [..., 2, n]
    (through f32)."""
    return capture_planes_f32(capbuf).to(torch.bfloat16)


def capture_planes_int8(capbuf: torch.Tensor) -> torch.Tensor:
    """ADC-grid capture [..., n] -> int8 planes [..., 2, n]: k =
    clip(round(128 x), -127, 127), round half to even (the saturated +128
    clips to 127)."""
    p = torch.stack([capbuf.real, capbuf.imag], dim=-2).float()
    return torch.clamp(torch.round(p * 128.0), -127.0, 127.0) \
        .to(torch.int8).contiguous()


# ---------------------------------------------------------------------------
# Operands of the tensor-core kernels
# ---------------------------------------------------------------------------

def capture_words(cap: torch.Tensor) -> torch.Tensor:
    """Capture planes [C, 2, n] -> the words the tensor-core kernels
    stage, one 32-bit word per sample, with 4 zero words before sample 0
    and zeros past the capture up to a whole number of 16-byte chunks.
    Word j of bf16 [C, n_w, 2] holds (Re, Im) of sample j - 4; word j of
    int8 [C, n_w, 4] holds (Re, Im) of samples j - 4 and j - 3, the two
    consecutive taps' worth that one m16n8k32 A register takes."""
    n_c, _, n_cap = cap.shape
    n_w = -(-(n_cap + _GUARD) // 4) * 4
    pair = cap.dtype == torch.int8
    x = F.pad(cap.transpose(1, 2), (0, 0, _GUARD, n_w + pair - _GUARD - n_cap))
    if not pair:
        return x
    # each int8 (Re, Im) sample as one int16; word j = samples j, j + 1
    samples = x.view(torch.int16)[..., 0]
    return samples.unfold(1, 2, 1).contiguous().view(torch.int8)


def pack_map_taps(taps: torch.Tensor) -> torch.Tensor:
    """Template planes [2, T, 137] (bf16 or int8) -> the map kernels' B
    operand [ceil(T / 4), 8, 288] of the same type: for column group n,
    column 2q is Re and column 2q + 1 is Im of template t = 4n + q, and
    K index 2k + c (tap k < 144, c = 0 for the capture's Re, 1 for its
    Im):

        B[n, 2q, 2k] = tr,  B[n, 2q, 2k + 1] = -ti,
        B[n, 2q + 1, 2k] = ti,  B[n, 2q + 1, 2k + 1] = tr

    of template t.  Taps 137-143 and the columns of templates past T are
    zero.  Each column is contiguous (the "col" B of ``mma.sync``), so one
    fragment register is one aligned 32-bit load.  The int8 taps are
    clipped to +-127, so the negation is exact."""
    n_t = taps.shape[1]
    n_g = -(-n_t // MAP_GROUP)
    b = taps.new_zeros((n_g * MAP_GROUP, 2, TAPS_PAD, 2))  # [t, col, k, c]
    b[:n_t, 0, :PSS_TD_LEN, 0] = taps[0]
    b[:n_t, 0, :PSS_TD_LEN, 1] = -taps[1]
    b[:n_t, 1, :PSS_TD_LEN, 0] = taps[1]
    b[:n_t, 1, :PSS_TD_LEN, 1] = taps[0]
    return b.reshape(n_g, 2 * MAP_GROUP, 2 * TAPS_PAD)


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


def corr_pow_f32_plain(cap: torch.Tensor, taps: torch.Tensor,
                       n_lags: int) -> torch.Tensor:
    """Plain version of the f32-output kernels (``pss_corr_f32``,
    ``pss_corr_bf16_f32out``): the operands widened to f32, f32 sums (TF32
    must be off for CUDA matmuls, which is PyTorch's default), re^2 + im^2
    in f32."""
    re, im = _re_im(cap.float(), taps.float(), n_lags)
    return re * re + im * im


def corr_pow_bf16_plain(cap: torch.Tensor, taps: torch.Tensor,
                        n_lags: int) -> torch.Tensor:
    """Plain version of the bf16 kernel: the f32 map rounded to bf16."""
    return corr_pow_f32_plain(cap, taps, n_lags).to(torch.bfloat16)


def _int8_re_im(cap: torch.Tensor, taps: torch.Tensor, n_lags: int):
    """Integer-exact (Re, Im) of the int8 correlation (float64 holds every
    partial sum, all integers below 2^23, exactly), cast to f32."""
    re, im = _re_im(cap.double(), taps.double(), n_lags)
    return re.float(), im.float()


def corr_pow_int8_plain(cap: torch.Tensor, taps: torch.Tensor,
                        n_lags: int) -> torch.Tensor:
    """Plain version of the int8 kernel: the exact sums, then re*re +
    im*im as separate f32 operations and a bf16 store -- the kernel's
    rounding, bit for bit."""
    re, im = _int8_re_im(cap, taps, n_lags)
    return (re * re + im * im).to(torch.bfloat16)


def corr_pow_int8_scaled_plain(cap: torch.Tensor, taps: torch.Tensor,
                               n_lags: int, inv) -> torch.Tensor:
    """Plain version of the scaled int8 kernel: the exact sums, re*re +
    im*im, then times inv, each a separate f32 operation, and a bf16
    store -- the kernel's rounding, bit for bit."""
    re, im = _int8_re_im(cap, taps, n_lags)
    scale = torch.tensor(np.float32(inv), device=re.device)
    return ((re * re + im * im) * scale).to(torch.bfloat16)


def sum_shape(n_t: int, n_lags: int):
    """[n_rb, n_tc, 8, 16]: the sum probe's output for T = n_t templates
    and n_lags lags (whole row blocks of 15360 lags, chunks of 16)."""
    return (-(-n_lags // SUM_BLOCK_LAGS), -(-n_t // SUM_T_CHUNK), SUM_COLS,
            SUM_T_CHUNK)


def corr_pow_sum_bf16_plain(cap: torch.Tensor, taps: torch.Tensor,
                            n_lags: int) -> torch.Tensor:
    """Plain version of the sum probe, from the full f32 map of the
    zero-padded capture (lags past n_lags up to whole row blocks) and of
    the templates padded to whole chunks with zero taps:
    S[i, j, c, tc] = sum_{r < 128} p[16 j + tc, 15360 i + 120 r + c]."""
    n_rb, n_tc, _, _ = sum_shape(taps.shape[1], n_lags)
    span = n_rb * SUM_BLOCK_LAGS
    cap = F.pad(cap.float(),
                (0, max(0, span + PSS_TD_LEN - 1 - cap.shape[1])))
    taps = F.pad(taps.float(), (0, 0, 0, n_tc * SUM_T_CHUNK - taps.shape[1]))
    p = corr_pow_f32_plain(cap, taps, span).reshape(
        n_tc, SUM_T_CHUNK, n_rb, 128, SUM_ROW_LAGS)[..., :SUM_COLS]
    return p.sum(dim=3).permute(2, 0, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_lib = None
# the tensor-core entry points, in the order of pss_corr_map_tc_occupancy
MAP_TC_ENTRIES = ("pss_corr_bf16", "pss_corr_int8", "pss_corr_bf16_f32out",
                  "pss_corr_int8_scaled")
_PLANE_ENTRIES = ("pss_corr_f32", "pss_corr_sum_bf16")


def _kernels():
    global _lib
    if _lib is None:
        from ..cuda_build import load
        lib = load("pss_corr")
        head = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
        for name in MAP_TC_ENTRIES + _PLANE_ENTRIES:
            inv = [ctypes.c_float] if name == "pss_corr_int8_scaled" else []
            getattr(lib, name).argtypes = head + inv + [ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int
        lib.pss_corr_map_tc_occupancy.argtypes = [ctypes.c_void_p]
        lib.pss_corr_map_tc_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


def map_tc_blocks_per_sm() -> dict:
    """Resident blocks per SM of each tensor-core entry point on the
    current card, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    gives them (each launch sizes its grid from this)."""
    per_sm = (ctypes.c_int * len(MAP_TC_ENTRIES))()
    err = _kernels().pss_corr_map_tc_occupancy(per_sm)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return dict(zip(MAP_TC_ENTRIES, per_sm))


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


def _check_packed(packed: torch.Tensor, taps: torch.Tensor) -> None:
    want = (-(-taps.shape[1] // MAP_GROUP), 2 * MAP_GROUP, 2 * TAPS_PAD)
    if (packed.device != taps.device or packed.dtype != taps.dtype
            or tuple(packed.shape) != want or not packed.is_contiguous()):
        raise ValueError(f"packed taps must be pack_map_taps(taps): a "
                         f"contiguous {taps.dtype} {list(want)} on "
                         f"{taps.device}, got {packed.dtype} "
                         f"{list(packed.shape)} on {packed.device}")


def _run(name: str, device: torch.device, out: torch.Tensor, *args,
         count: Optional[str] = None) -> torch.Tensor:
    """Launch entry point ``name`` on ``device`` with ``args`` (pointers
    and integers; the stream is appended), writing ``out`` (allocated by
    the caller); counts the launch under ``count`` (default: ``name``)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_kernels(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[count or name] += 1
    return out


def _launch(name: str, cap: torch.Tensor, taps: torch.Tensor,
            out: torch.Tensor, n_lags: int) -> torch.Tensor:
    """A CUDA-core entry point on (re, im) planes."""
    return _run(name, cap.device, out, cap.data_ptr(), taps.data_ptr(),
                out.data_ptr(), int(cap.shape[1]), int(taps.shape[1]),
                int(n_lags))


def _launch_tc(name: str, words: torch.Tensor, packed: torch.Tensor,
               out: torch.Tensor, n_t: int, n_lags: int, *extra,
               count: Optional[str] = None) -> torch.Tensor:
    """A tensor-core entry point on one capture's words [n_w, 2 or 4]
    (``capture_words``) and the packed taps of n_t templates
    (``pack_map_taps``), ``extra`` after n_lags (the scaled map's inv): the
    bare launch, without building operands."""
    return _run(name, words.device, out, words.data_ptr(), packed.data_ptr(),
                out.data_ptr(), int(words.shape[0]), int(n_t), int(n_lags),
                *extra, count=count)


def _map(taps: torch.Tensor, n_lags: int, dtype: torch.dtype):
    return torch.empty((taps.shape[1], n_lags), dtype=dtype,
                       device=taps.device)


def _launch_map(name: str, cap: torch.Tensor, taps: torch.Tensor,
                n_lags: int, packed: Optional[torch.Tensor],
                dtype: torch.dtype, *extra) -> torch.Tensor:
    """The ``dtype`` map of a tensor-core entry point: the capture's words
    built here, the taps packed here unless ``packed`` is given."""
    words = capture_words(cap[None])[0]
    if packed is None:
        packed = pack_map_taps(taps)
    out = _map(taps, n_lags, dtype)
    return _launch_tc(name, words, packed, out, taps.shape[1], n_lags,
                      *extra)


def corr_pow_bf16(cap: torch.Tensor, taps: torch.Tensor, n_lags: int,
                  out_dtype: torch.dtype = torch.bfloat16,
                  packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Correlation-power map [T, n_lags] from bf16 capture planes [2, n]
    and template planes [2, T, 137], stored as ``out_dtype``: bf16
    (``pss_corr_bf16``) or f32 (``pss_corr_bf16_f32out``), both on the
    tensor cores; ``packed``: the taps already packed by
    ``pack_map_taps``."""
    _check(cap, taps, n_lags, torch.bfloat16)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    if packed is not None:
        _check_packed(packed, taps)
    f32 = out_dtype == torch.float32
    if cap.device.type == "cpu":
        plain = corr_pow_f32_plain if f32 else corr_pow_bf16_plain
        return plain(cap, taps, n_lags)
    return _launch_map("pss_corr_bf16_f32out" if f32 else "pss_corr_bf16",
                       cap, taps, n_lags, packed, out_dtype)


def corr_pow_bf16_per_chunk(cap: torch.Tensor, taps: torch.Tensor,
                            n_lags: int, t_chunk: int = 16) -> torch.Tensor:
    """The bf16 map of ``corr_pow_bf16`` with one launch of
    ``pss_corr_bf16`` per chunk of ``t_chunk`` templates, each writing
    its rows of one [T, n_lags] output (the per-chunk probe of
    tools/bench_corr_v2.py:268-328, which measures the cost of a launch
    per chunk against one launch).  The capture's words and each chunk's
    packed taps are built before the first launch: slices of one packing
    when chunks hold whole column groups."""
    _check(cap, taps, n_lags, torch.bfloat16)
    if t_chunk < 1:
        raise ValueError(f"t_chunk must be positive, got {t_chunk}")
    chunks = [taps[:, j: j + t_chunk] for j in range(0, taps.shape[1],
                                                      t_chunk)]
    if cap.device.type == "cpu":
        return torch.cat([corr_pow_bf16_plain(cap, c, n_lags)
                          for c in chunks])
    out = _map(taps, n_lags, torch.bfloat16)
    words = capture_words(cap[None])[0]
    if t_chunk % MAP_GROUP == 0:
        whole = pack_map_taps(taps)
        step = t_chunk // MAP_GROUP
        packed = [whole[i: i + step] for i in range(0, len(whole), step)]
    else:
        packed = [pack_map_taps(c) for c in chunks]
    j = 0
    for c, b in zip(chunks, packed):
        _launch_tc("pss_corr_bf16", words, b, out[j: j + c.shape[1]],
                   c.shape[1], n_lags, count="pss_corr_bf16_per_chunk")
        j += c.shape[1]
    return out


def corr_pow_f32(cap: torch.Tensor, taps: torch.Tensor,
                 n_lags: int) -> torch.Tensor:
    """f32 correlation-power map [T, n_lags] from f32 capture planes
    [2, n] and template planes [2, T, 137]."""
    _check(cap, taps, n_lags, torch.float32)
    if cap.device.type == "cpu":
        return corr_pow_f32_plain(cap, taps, n_lags)
    return _launch("pss_corr_f32", cap, taps,
                   _map(taps, n_lags, torch.float32), n_lags)


def corr_pow_int8(cap: torch.Tensor, taps: torch.Tensor, n_lags: int,
                  packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """UNSCALED int8 correlation-power map [T, n_lags] (bf16) from int8
    capture planes [2, n] and template planes [2, T, 137]
    (``pss_corr_int8``, tensor cores; ``packed``: the taps already packed
    by ``pack_map_taps``)."""
    _check(cap, taps, n_lags, torch.int8)
    if packed is not None:
        _check_packed(packed, taps)
    if cap.device.type == "cpu":
        return corr_pow_int8_plain(cap, taps, n_lags)
    return _launch_map("pss_corr_int8", cap, taps, n_lags, packed,
                       torch.bfloat16)


def corr_pow_int8_scaled(cap: torch.Tensor, taps: torch.Tensor, n_lags: int,
                         inv, packed: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """int8 correlation-power map [T, n_lags] times ``inv`` (an f32 power
    scale, (1 / (128 s_g))^2 to restore capture units), stored as bf16
    (``pss_corr_int8_scaled``, tensor cores; ``packed``: the taps already
    packed by ``pack_map_taps``)."""
    _check(cap, taps, n_lags, torch.int8)
    if packed is not None:
        _check_packed(packed, taps)
    if cap.device.type == "cpu":
        return corr_pow_int8_scaled_plain(cap, taps, n_lags, inv)
    return _launch_map("pss_corr_int8_scaled", cap, taps, n_lags, packed,
                       torch.bfloat16, float(np.float32(inv)))


def corr_pow_sum_bf16(cap: torch.Tensor, taps: torch.Tensor,
                      n_lags: int) -> torch.Tensor:
    """The sum probe: S [n_rb, n_tc, 8, 16] f32, S[i, j, c, tc] = the sum
    over the 128 rows r of row block i of p[16 j + tc, 15360 i + 120 r +
    c] for the bf16 map p, over whole row blocks of lags (the capture
    zero past its end) and whole chunks of templates (zero taps past T).
    The TPU probe writes S broadcast over the 8 rows of its (8, 128)
    output tile and keeps c < 8 because that tile holds 8 sublanes; the
    port keeps the same selection so that the checksum is the probe's.
    No power map is written."""
    _check(cap, taps, n_lags, torch.bfloat16)
    if cap.device.type == "cpu":
        return corr_pow_sum_bf16_plain(cap, taps, n_lags)
    shape = sum_shape(taps.shape[1], n_lags)
    sums = torch.zeros(shape, dtype=torch.float32, device=cap.device)
    return _launch("pss_corr_sum_bf16", cap, taps, sums,
                   shape[0] * SUM_BLOCK_LAGS)
