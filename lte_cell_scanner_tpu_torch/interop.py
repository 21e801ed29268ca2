"""Build the port's records from plain fields.

The search carries no trained weights; what passes between its stages is
the peak and cell list plus host-built tables.  These helpers take plain
numbers (for example ``dataclasses.asdict`` of another implementation's
cell or search configuration, with enums as members or their values) so
a caller can feed one stage's output into the port's later stages.
"""

from __future__ import annotations

import dataclasses
import enum

from .cell import Cell, CpType, PhichDuration, PhichResource
from .models.search import SearchConfig

_ENUMS = {"cp_type": CpType, "phich_duration": PhichDuration,
          "phich_resource": PhichResource}

# correlation-backend names of the TPU package -> the port's
_BACKENDS = {"auto": "auto", "xla": "exact", "pallas": "kernel",
             "exact": "exact", "kernel": "kernel"}


def _enum_value(cls, v):
    if isinstance(v, enum.Enum):
        v = v.value
    return cls(v)


def cell_from_fields(d: dict) -> Cell:
    """A Cell from a mapping of its field names to plain values."""
    names = {f.name for f in dataclasses.fields(Cell)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown Cell fields: {sorted(unknown)}")
    kw = {k: (_enum_value(_ENUMS[k], v) if k in _ENUMS else v)
          for k, v in d.items()}
    return Cell(**kw)


def config_from_fields(d: dict) -> SearchConfig:
    """A SearchConfig from plain fields.  Fields of the TPU package's
    configuration that select behaviour the port does not have must hold
    the value the port implements (compat "production", interp "hex",
    batch_peaks True, no skip_ids); corr_backend names are translated."""
    fixed = {"compat": "production", "interp": "hex", "batch_peaks": True}
    kw = {}
    for k, v in d.items():
        if k in fixed:
            if v != fixed[k]:
                raise NotImplementedError(f"{k}={v!r} is not ported")
        elif k == "skip_ids":
            if v:
                raise NotImplementedError("skip_ids is not ported")
        elif k == "corr_backend":
            kw[k] = _BACKENDS[v]
        else:
            kw[k] = v
    names = {f.name for f in dataclasses.fields(SearchConfig)}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"unknown SearchConfig fields: {sorted(unknown)}")
    return SearchConfig(**kw)
