"""Tracing and diagnostics: the reference's debug machinery.

Behavioral contract (reference include/macros.h:22-72,
src/macros.cpp:23-25):

- ``ITPP_DEBUG_EXPORT(var)`` appends any variable to a global
  ``ITPP_DEBUG.it`` file in debug builds, so intermediates can be diffed
  against the MATLAB prototype offline -> here: a process-global
  :class:`DebugDump` that appends arrays (tensors are copied to the host)
  to an ``.it`` container, enabled by ``LTE_DEBUG_DUMP=<path>`` or
  programmatically.
- the per-stage wall clock of :class:`stage` (``--profile``, and the
  ``timings=`` dictionaries of ``cell_search`` and ``scan_band``).

The reference's verbosity printer, ``MARK``, its tic/toc timer and its
NaN poisoning have no caller in the port yet.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .itfile import _MAGIC, _pack_var


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class DebugDump:
    """Appends named arrays to an IT++ ``.it`` file for offline diffing.

    Repeated names get ``_1``, ``_2``, ... suffixes so every export
    survives (the reference's global it_file simply accumulates blocks).
    """

    def __init__(self, path: str):
        self.path = path
        self._names = set()
        if not os.path.exists(path) or os.path.getsize(path) < 5:
            with open(path, "wb") as f:
                f.write(_MAGIC + bytes([3]))
        else:
            # appending to an earlier run's dump: don't shadow its blocks
            from .itfile import read_itfile
            self._names = set(read_itfile(path))

    def export(self, name: str, arr) -> None:
        uname, n = name, 0
        while uname in self._names:
            n += 1
            uname = f"{name}_{n}"
        self._names.add(uname)
        with open(self.path, "ab") as f:
            f.write(_pack_var(uname, _host(arr)))


_dump: Optional[DebugDump] = None


def get_dump() -> Optional[DebugDump]:
    """The process-global dump (reference ITPP_DEBUG global it_file),
    lazily created from ``LTE_DEBUG_DUMP`` if set."""
    global _dump
    if _dump is None:
        path = os.environ.get("LTE_DEBUG_DUMP")
        if path:
            _dump = DebugDump(path)
    return _dump


def set_dump(dump: Optional[DebugDump]) -> None:
    global _dump
    _dump = dump


def debug_export(name: str, arr) -> None:
    """Append to the global dump when one is active; no-op otherwise
    (reference ITPP_DEBUG_EXPORT semantics: zero cost in release)."""
    d = get_dump()
    if d is not None:
        d.export(name, arr)


_profile: Optional[dict] = None


def enable_profiling(on: bool = True) -> None:
    """Turn on the per-stage profiler (the reference only carried
    commented-out Real_Timer scaffolding, searcher.cpp:143,173)."""
    global _profile
    _profile = {} if on else None


class stage:
    """Context manager adding a pipeline stage's wall seconds to the
    global profile (when profiling is enabled) and to ``timings`` (when a
    dict is given); a no-op otherwise.  With a CUDA ``device`` the card
    is synchronised at both ends of a recorded stage, so its seconds hold
    the stage's device work; elsewhere they time what the host does."""

    def __init__(self, name: str, device=None,
                 timings: Optional[Dict[str, float]] = None):
        self.name = name
        self.timings = timings
        self._cuda = device is not None \
            and torch.device(device).type == "cuda"
        self._device = device

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._on = _profile is not None or self.timings is not None
        if self._on:
            self._sync()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self._on:
            return
        self._sync()
        dt = time.perf_counter() - self._t0
        if _profile is not None:
            tot, n = _profile.get(self.name, (0.0, 0))
            _profile[self.name] = (tot + dt, n + 1)
        if self.timings is not None:
            self.timings[self.name] = self.timings.get(self.name, 0.0) + dt


def profile_report() -> str:
    if not _profile:
        return "(profiling not enabled or no stages recorded)"
    total = sum(t for t, _ in _profile.values())
    lines = [f"{'stage':<16s} {'total':>9s} {'calls':>6s} {'mean':>9s} "
             f"{'share':>6s}"]
    for name, (t, n) in sorted(_profile.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{name:<16s} {t * 1e3:8.1f}ms {n:6d} "
                     f"{t / n * 1e3:8.2f}ms {t / total * 100:5.1f}%")
    return "\n".join(lines)
