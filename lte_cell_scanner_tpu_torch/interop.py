"""Build the port's records from plain fields.

The search carries no trained weights; what passes between its stages is
the peak and cell list plus host-built tables, and the tracker carries
state (its tracked cells and the dongle-level registers).  These helpers
take plain numbers (for example ``dataclasses.asdict`` of another
implementation's cell, search configuration, tracked cell or global
state, with enums as members or their values) so a caller can feed one
stage's output into the port's later stages, or seed a tracker.  The
``taps_from_*`` helpers turn the TPU package's correlation band matrices
(as numpy arrays) back into the port's template planes, so the two
implementations can be fed the same quantized operands.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .cell import Cell, CpType, PhichDuration, PhichResource
from .constants import PSS_TD_LEN
from .models.search import SearchConfig
from .tracker.state import GlobalState, TrackedCell

_ENUMS = {"cp_type": CpType, "phich_duration": PhichDuration,
          "phich_resource": PhichResource}

# correlation-backend names of the TPU package -> the port's
_BACKENDS = {"auto": "auto", "xla": "exact", "pallas": "kernel",
             "exact": "exact", "kernel": "kernel"}


def _enum_value(cls, v):
    if isinstance(v, enum.Enum):
        v = v.value
    return cls(v)


def _record_from_fields(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    kw = {}
    for k, v in d.items():
        if k in _ENUMS:
            v = _enum_value(_ENUMS[k], v)
        elif isinstance(v, np.ndarray):
            v = v.copy()
        kw[k] = v
    return cls(**kw)


def cell_from_fields(d: dict) -> Cell:
    """A Cell from a mapping of its field names to plain values."""
    return _record_from_fields(Cell, d)


def tracked_cell_from_fields(d: dict) -> TrackedCell:
    """A TrackedCell from plain fields (its arrays copied)."""
    return _record_from_fields(TrackedCell, d)


def global_state_from_fields(d: dict) -> GlobalState:
    """A GlobalState from plain fields (``g`` as any sequence)."""
    d = dict(d)
    if "g" in d:
        d["g"] = tuple(float(x) for x in d["g"])
    return _record_from_fields(GlobalState, d)


def config_from_fields(d: dict) -> SearchConfig:
    """A SearchConfig from plain fields; corr_backend names are
    translated, skip_ids becomes a frozenset."""
    kw = {}
    for k, v in d.items():
        if k == "corr_backend":
            kw[k] = _BACKENDS[v]
        elif k == "skip_ids":
            kw[k] = frozenset(int(i) for i in v)
        else:
            kw[k] = v
    names = {f.name for f in dataclasses.fields(SearchConfig)}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"unknown SearchConfig fields: {sorted(unknown)}")
    return SearchConfig(**kw)


# The TPU package's band geometry (ops/corr_pallas.py): v1 stacks three
# 128-row Toeplitz planes per chunk of 16 templates, columns (c, tc)
# c-major; the v2/v3 im2col matrix has K = 256 rows per plane and columns
# (half, c, tc) (c-major) or (half, tc, c) (tc-major, v3) per chunk, with
# W = 120 lags c.
_T_CHUNK = 16
_V1_ROWS = 3 * 128
_V2_K = 256
_V2_W = 120


def _planes(re: np.ndarray, im: np.ndarray) -> torch.Tensor:
    """[2, T, 137] template planes, int8 kept, floats as f32."""
    p = np.stack([re, im])
    return torch.from_numpy(np.ascontiguousarray(
        p if p.dtype == np.int8 else p.astype(np.float32)))


def taps_from_bands(g_re, g_im) -> torch.Tensor:
    """The v1 band pair (g_re, g_im) [n_tc * 384, 128 * 16] of
    ``_bands_for`` (ops/corr_pallas.py:87-116), as numpy (bf16 bands
    widened to f32), -> the port's template planes [2, n_tc * 16, 137]
    (templates past T are the bands' zero padding).  Column c = 0 of
    template t = 16 j + tc holds its taps in rows 384 j + m:
    g[p, d, 0, t] = tmpl[t, 128 p + d]."""
    g_re = np.asarray(g_re)
    g_im = np.asarray(g_im)
    n_tc = g_re.shape[0] // _V1_ROWS
    rows = (np.arange(n_tc)[:, None] * _V1_ROWS
            + np.arange(PSS_TD_LEN)[None, :])             # [n_tc, 137]
    cols = np.arange(_T_CHUNK)                            # c = 0

    def taps(g):
        t = g[rows[:, None, :], cols[None, :, None]]      # [n_tc, 16, 137]
        return t.reshape(n_tc * _T_CHUNK, PSS_TD_LEN)
    return _planes(taps(g_re), taps(g_im))


def taps_from_v2_bands(g, t_count: int, tc_major: bool = False
                       ) -> torch.Tensor:
    """The v2/v3 im2col matrix g [512, n_tc * 3840] of ``_im2col_bands``
    (ops/corr_pallas.py:346-379; ``tc_major`` for v3's), as numpy (bf16
    widened to f32, or the int8 matrix of bands_v2_int8_for_templates),
    -> the port's template planes [2, t_count, 137] in g's type (int8
    stays int8).  Lag c = 0 of template t reads Re taps from half 0 and
    Im taps from half 1, rows 0..136: G[k, (0, 0, t)] = Re(tmpl[t, k]),
    G[k, (1, 0, t)] = Im(tmpl[t, k])."""
    g = np.asarray(g)
    t = np.arange(t_count)
    j, tc = t // _T_CHUNK, t % _T_CHUNK
    base = j * 2 * _V2_W * _T_CHUNK + (tc * _V2_W if tc_major else tc)
    half = _V2_W * _T_CHUNK
    k = np.arange(PSS_TD_LEN)[None, :]
    return _planes(g[k, base[:, None]], g[k, base[:, None] + half])
