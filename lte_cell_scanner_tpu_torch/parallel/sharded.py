"""The PSS search front end over a (t x f) grid of devices.

The counterpart of the TPU package's ``parallel/sharded.py``, whose
``shard_map`` program runs over a 2-D device mesh.  Here one controller
drives a grid of ``torch.device``s (``make_mesh``):

- axis "t": the capture's lag axis in blocks of B = ceil(n_cap / n_t)
  samples.  The 137-tap correlation is overlap-save: block i reads the
  first ``_HALO`` samples of block i + 1 (copied from that block's
  device), the last block zeros;
- axis "f": the (PSS x frequency hypothesis) templates, each column of
  the grid correlating T / n_f of them (``plan_sharded_inputs`` lays
  them out PSS-major within each column);
- each device folds its lags mod 9600 at the global lag of its block;
  the folds are summed over "t" and the hypotheses collapsed over "f"
  (max, and the index of the largest column holding the max) on the
  grid's first device.

A grid may repeat a device: the blocking, halo and fold arithmetic are
then the same on one card (or the CPU) as over several.  Each device's
local correlation is the exact complex correlation, or with the
operands of ``plan_sharded_bands`` the CUDA map kernel of
``ops/corr_cuda.py`` (``pss_corr_bf16``; ``pss_corr_f32`` for f32
operands) at T / n_f templates and B lags.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..constants import HALF_FRAME_LEN, PSS_TD_LEN
from ..device import pick_devices, real_dtype, to_capture
from ..models.xcorr import (KernelOperands, combine_start_indices,
                            pss_templates)
from ..ops import corr_cuda
from ..ops.corr import correlate

_HALO = 280  # covers the 136-lag correlation halo and the 273-lag sp window


@dataclass
class DeviceGrid:
    """A (t x f) grid of devices: ``devices[i][j]`` holds time block i
    and template column j."""
    devices: List[List[torch.device]]

    @property
    def shape(self) -> Dict[str, int]:
        return {"t": len(self.devices), "f": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device the reductions and the back half run on."""
        return self.devices[0][0]


def make_mesh(n_time: int, n_hyp: int, devices=None) -> DeviceGrid:
    """The first n_time * n_hyp of ``devices`` (None = every visible
    card), row-major into an (n_time x n_hyp) grid; a list may repeat a
    device.  Raises when fewer are given or visible."""
    devs = pick_devices(n_time * n_hyp, devices, "(t x f) grid")
    return DeviceGrid([devs[i * n_hyp:(i + 1) * n_hyp]
                       for i in range(n_time)])


def _fold_local(xc2: torch.Tensor, lag0: int, n_comb_xc: int,
                starts: torch.Tensor, n_valid_lags: int) -> torch.Tensor:
    """Fold one block's powers into the half-frame accumulator.

    xc2 [T, B]: the block's squared correlations (T its templates);
    lag0: the global lag of its first column; starts [T, n_comb]: the
    fold starts of each template's hypothesis.  Lags at or past
    n_valid_lags are zeroed; each period m adds the 9600-lag window of
    the block that starts at global lag starts[:, m] (zeros outside the
    block).  Returns acc [T, 9600] / n_comb_xc."""
    n_t, b = xc2.shape
    lags = lag0 + torch.arange(b, device=xc2.device)
    xc2 = torch.where((lags < n_valid_lags)[None, :], xc2,
                      torch.zeros((), dtype=xc2.dtype, device=xc2.device))
    zeros = torch.zeros((n_t, HALF_FRAME_LEN), dtype=xc2.dtype,
                        device=xc2.device)
    padded = torch.cat([zeros, xc2, zeros], dim=1)
    base = torch.arange(HALF_FRAME_LEN, device=xc2.device)
    acc = torch.zeros_like(zeros)
    for m in range(n_comb_xc):
        off = torch.clamp(starts[:, m] - lag0 + HALF_FRAME_LEN, 0,
                          b + HALF_FRAME_LEN)
        acc = acc + torch.gather(padded, 1, off[:, None] + base)
    return acc / n_comb_xc


def plan_sharded_bands(tmpl_flat: np.ndarray, mesh: DeviceGrid,
                       precision: str = "bf16"
                       ) -> List[List[KernelOperands]]:
    """The CUDA map kernel's operands for each device of the grid: the
    rows of ``tmpl_flat`` (the ``plan_sharded_inputs`` layout) of the
    device's template column, quantized once per (device, column): bf16
    planes (``pss_corr_bf16``, bf16 map) or f32 planes
    (``pss_corr_f32``).  Pass them to ``sharded_xcorr`` to route each
    device's local correlation through the kernel."""
    n_f_axis = mesh.shape["f"]
    t_count = tmpl_flat.shape[0]
    if t_count % n_f_axis:
        raise ValueError(f"{t_count} templates do not divide over "
                         f"{n_f_axis} columns")
    t_loc = t_count // n_f_axis
    made: Dict[tuple, KernelOperands] = {}
    out = []
    for row in mesh.devices:
        ops = []
        for j, dev in enumerate(row):
            key = (dev, j)
            if key not in made:
                rows = np.asarray(tmpl_flat[j * t_loc:(j + 1) * t_loc])
                if precision == "bf16":
                    made[key] = KernelOperands(
                        "bf16", corr_cuda.template_planes_bf16(rows, dev),
                        None)
                elif precision == "f32":
                    made[key] = KernelOperands(
                        "f32", corr_cuda.template_planes_f32(rows, dev),
                        None, torch.float32)
                else:
                    raise ValueError(f"unknown precision {precision!r}")
            ops.append(made[key])
        out.append(ops)
    return out


def _local_power(cap_ext: torch.Tensor, tmpl_local, kern, b: int
                 ) -> torch.Tensor:
    """|correlation|^2 [T_local, b] of the halo-extended block cap_ext
    [b + _HALO]: the map kernel of ``kern``, or the exact correlation of
    the templates tmpl_local [T_local, 137]."""
    rdt = cap_ext.real.dtype
    if kern is None:
        xc = correlate(cap_ext, tmpl_local)[:, :b]
        return xc.real ** 2 + xc.imag ** 2
    if kern.precision == "f32":
        return corr_cuda.corr_pow_f32(corr_cuda.capture_planes_f32(cap_ext),
                                      kern.taps, b).to(rdt)
    return corr_cuda.corr_pow_bf16(corr_cuda.capture_planes_bf16(cap_ext),
                                   kern.taps, b, kern.out_dtype,
                                   kern.packed).to(rdt)


def sharded_xcorr(mesh: DeviceGrid, capbuf_blocks, templates, start_idx,
                  ds_comb_arm: int, n_comb_xc: int, n_valid_lags: int,
                  n_comb_sp: int = 0,
                  bands: Sequence[Sequence[KernelOperands]] = ()):
    """The front end over the grid.

    capbuf_blocks: [n_t * B] complex capture, zero-padded
    (``plan_sharded_inputs``), on the host or a device; templates:
    [3 * n_f, 137] in the column-major layout; start_idx: [3 * n_f,
    n_comb] fold starts.

    Returns (pow [3, 9600], frq [3, 9600]) on the grid's first device:
    the hypothesis-collapsed peak map (the reference's
    xc_incoherent_collapsed_{pow,frq}, searcher.cpp:349-383).  With
    n_comb_sp > 0 also sp_incoherent [9600] (the 274-sample running power
    over the same extended blocks, folded below n_comb_sp * 9600) and
    xc_incoherent_single [3, n_f, 9600] (the fold before delay-spread
    combining, gathered over the columns in order): what peak_search,
    Z_th1 and the refinement need.

    bands: the per-device kernel operands of ``plan_sharded_bands``
    ([n_t][n_f]); empty for the exact correlation."""
    n_t, n_f_axis = mesh.shape["t"], mesh.shape["f"]
    cap = capbuf_blocks if isinstance(capbuf_blocks, torch.Tensor) \
        else np.asarray(capbuf_blocks)
    b = len(cap) // n_t
    if b * n_t != len(cap) or b < _HALO:
        raise ValueError(f"a capture of {len(cap)} samples does not make "
                         f"{n_t} blocks of at least {_HALO}")
    tmpl = np.asarray(templates)
    starts = np.asarray(start_idx)
    t_loc = tmpl.shape[0] // n_f_axis
    first = mesh.first

    blocks = [[to_capture(cap[i * b:(i + 1) * b], dev) for dev in row]
              for i, row in enumerate(mesh.devices)]
    accs: List[List[torch.Tensor]] = [[] for _ in range(n_f_axis)]
    sp_parts = []
    for i, row in enumerate(mesh.devices):
        for j, dev in enumerate(row):
            # the halo: the next block's leading samples, from its device
            if i + 1 < n_t:
                halo = blocks[i + 1][j][:_HALO].to(dev)
            else:
                halo = torch.zeros(_HALO, dtype=blocks[i][j].dtype,
                                   device=dev)
            cap_ext = torch.cat([blocks[i][j], halo])
            cols = slice(j * t_loc, (j + 1) * t_loc)
            xc2 = _local_power(
                cap_ext, None if bands else to_capture(tmpl[cols], dev),
                bands[i][j] if bands else None, b)
            accs[j].append(_fold_local(
                xc2, i * b, n_comb_xc,
                torch.from_numpy(starts[cols]).to(dev), n_valid_lags))
            if n_comb_sp and j == 0:
                sp_parts.append(_sp_block(cap_ext, i * b, b, n_comb_sp))

    # the sum over "t", on the first device
    acc = [sum(a.to(first) for a in col) for col in accs]
    n_f_loc = t_loc // 3
    pow_loc, frq_loc = [], []
    for j, a in enumerate(acc):
        inc = a
        for d in range(1, ds_comb_arm + 1):
            inc = inc + torch.roll(a, d, dims=-1) + torch.roll(a, -d, dims=-1)
        inc = (inc / (2 * ds_comb_arm + 1)).reshape(3, n_f_loc,
                                                    HALF_FRAME_LEN)
        p, k = torch.max(inc, dim=1)                # first index on ties
        pow_loc.append(p)
        frq_loc.append(k + j * n_f_loc)
    # the collapse over "f": the global max, and the largest column's
    # index among the columns that hold it
    pow_stack = torch.stack(pow_loc)
    pow_glob = pow_stack.max(dim=0).values
    frq_glob = torch.where(pow_stack == pow_glob, torch.stack(frq_loc),
                           torch.full_like(frq_loc[0], -1)).max(dim=0).values
    if not n_comb_sp:
        return pow_glob, frq_glob
    sp_inc = torch.roll(sum(s.to(first) for s in sp_parts) / n_comb_sp, 137)
    single = torch.cat([a.reshape(3, n_f_loc, HALF_FRAME_LEN) for a in acc],
                       dim=1)
    return pow_glob, frq_glob, sp_inc, single


def _sp_block(cap_ext: torch.Tensor, lag0: int, b: int,
              n_comb_sp: int) -> torch.Tensor:
    """One block's share of sp_est (reference searcher.cpp:185-221): the
    274-sample running mean power at its b lags, the lags below
    n_comb_sp * 9600 folded mod 9600 -> [9600]."""
    rdt = real_dtype(cap_ext.device)
    p = cap_ext.real ** 2 + cap_ext.imag ** 2
    cs = torch.cat([torch.zeros(1, dtype=rdt, device=p.device),
                    torch.cumsum(p, 0)])
    sp = (cs[274: 274 + b] - cs[:b]) / 274.0
    lags = lag0 + torch.arange(b, device=p.device)
    sp = torch.where(lags < n_comb_sp * HALF_FRAME_LEN, sp,
                     torch.zeros((), dtype=rdt, device=p.device))
    # lags lag0 .. lag0 + b - 1 as whole half frames from a multiple of
    # 9600, then summed over the half frames (a fixed order)
    head = lag0 % HALF_FRAME_LEN
    n_rows = -(-(head + b) // HALF_FRAME_LEN)
    buf = torch.zeros(n_rows * HALF_FRAME_LEN, dtype=rdt, device=p.device)
    buf[head: head + b] = sp
    return buf.reshape(n_rows, HALF_FRAME_LEN).sum(dim=0)


def plan_sharded_inputs(capbuf: np.ndarray, f_search_set: np.ndarray,
                        fc_requested: float, fc_programmed: float,
                        fs_programmed: float, mesh: DeviceGrid,
                        dtype=np.complex64):
    """Pad and lay out the host inputs of ``sharded_xcorr``.

    Returns (capbuf_padded [n_t * B], templates [3 * n_f, 137], start_idx
    [3 * n_f, n_comb] int32, n_comb_xc, n_valid_lags).  The templates
    are PSS-major within each column of the grid (rows [column, pss,
    hypothesis]), so each column holds all 3 PSS of its hypotheses; n_f
    must divide evenly over the columns."""
    n_t = mesh.shape["t"]
    n_f = len(f_search_set)
    n_f_axis = mesh.shape["f"]
    if n_f % n_f_axis:
        raise ValueError(f"{n_f} hypotheses do not divide over {n_f_axis} "
                         f"columns")

    n_cap = len(capbuf)
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_comb_xc = (n_lags - 100) // HALF_FRAME_LEN

    b = int(np.ceil(n_cap / n_t))
    padded = np.zeros(b * n_t, dtype=dtype)
    padded[:n_cap] = capbuf

    tmpl = pss_templates(f_search_set, fc_requested, fc_programmed,
                         fs_programmed, dtype)         # [3, n_f, 137]
    starts = combine_start_indices(f_search_set, fc_requested, fc_programmed,
                                   fs_programmed, n_comb_xc)  # [n_f, n_comb]
    n_f_local = n_f // n_f_axis
    tmpl_rows = np.transpose(tmpl, (1, 0, 2))          # [n_f, 3, 137]
    tmpl_rows = tmpl_rows.reshape(n_f_axis, n_f_local, 3, PSS_TD_LEN)
    tmpl_rows = np.transpose(tmpl_rows, (0, 2, 1, 3))  # [col, 3, n_f_loc, 137]
    tmpl_flat = tmpl_rows.reshape(3 * n_f, PSS_TD_LEN)

    starts_rows = starts.reshape(n_f_axis, n_f_local, -1)
    starts_rows = np.broadcast_to(starts_rows[:, None],
                                  (n_f_axis, 3, n_f_local, starts.shape[1]))
    starts_flat = starts_rows.reshape(3 * n_f, -1).astype(np.int32)
    return padded, tmpl_flat, starts_flat, n_comb_xc, n_lags
