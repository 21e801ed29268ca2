"""Tracing and diagnostics: the reference's debug machinery.

Behavioral contract (reference include/macros.h:22-72,
src/macros.cpp:23-25):

- ``ITPP_DEBUG_EXPORT(var)`` appends any variable to a global
  ``ITPP_DEBUG.it`` file in debug builds, so intermediates can be diffed
  against the MATLAB prototype offline -> here: a process-global
  :class:`DebugDump` that appends arrays (tensors are copied to the host)
  to an ``.it`` container, enabled by ``LTE_DEBUG_DUMP=<path>`` or
  programmatically.
- the spans of :class:`stage`, the port's one timing primitive: the
  ``timings=`` dictionaries of ``cell_search``, ``scan_band`` and the
  tracker, the table of ``--profile``, and ranges on a recording
  ``torch.profiler``'s timeline.

The reference's verbosity printer, ``MARK``, its tic/toc timer and its
NaN poisoning have no caller in the port yet.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd.profiler import record_function

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
_open = threading.local()      # this thread's open spans' paths


def enable_profiling(on: bool = True) -> None:
    """Turn on the per-stage profiler (the reference only carried
    commented-out Real_Timer scaffolding, searcher.cpp:143,173)."""
    global _profile
    _profile = {} if on else None


_profiler_enabled = torch._C._autograd._profiler_enabled


class stage:
    """One span of the program, its one timing primitive.  A span feeds
    three sinks, each only when it is on:

    - ``timings``, a dict given by the caller: the span's wall seconds
      are added under ``name``;
    - the global profile of ``--profile`` (enable_profiling): seconds
      and calls under the path of the spans open on this thread, so
      that profile_report nests a span under the one enclosing it;
    - a ``torch.profiler`` range named ``name``, while a profiler is
      recording, for ``host=True`` spans alone.  Such a span encloses
      no device work: a range around launches shows on the device's
      timeline too, as an annotation that a trace reader would count
      as a device operation.  The range puts the span on the clock of
      the device trace.

    With no sink on, a span only tests for its sinks.  With a CUDA
    ``device`` the card is synchronised at both ends of a timed span,
    so its seconds hold the span's device work; elsewhere they time
    what the host does.  ``on`` says whether the span is timed."""

    __slots__ = ("name", "timings", "_device", "_host", "_t0", "_path",
                 "_range")

    def __init__(self, name: str, device=None,
                 timings: Optional[Dict[str, float]] = None,
                 host: bool = False):
        self.name = name
        self.timings = timings
        self._device = device if device is not None \
            and torch.device(device).type == "cuda" else None
        self._host = host

    @property
    def on(self) -> bool:
        return self._t0 is not None

    def __enter__(self):
        self._range = None
        if self._host and _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        if self.timings is None and _profile is None:
            self._t0 = None
            return self
        self._path = None
        if _profile is not None:
            paths = _open.__dict__.setdefault("paths", [])
            self._path = (paths[-1] if paths else ()) + (self.name,)
            paths.append(self._path)
        if self._device is not None:
            torch.cuda.synchronize(self._device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            if self._device is not None:
                torch.cuda.synchronize(self._device)
            dt = time.perf_counter() - self._t0
            if self._path is not None:
                _open.paths.pop()
                if _profile is not None:
                    tot, n = _profile.get(self._path, (0.0, 0))
                    _profile[self._path] = (tot + dt, n + 1)
            if self.timings is not None:
                self.timings[self.name] = \
                    self.timings.get(self.name, 0.0) + dt
        if self._range is not None:
            self._range.__exit__(*exc)


def profile_report() -> str:
    """The profile as a table: each span under the one that enclosed it,
    indented, siblings by total time; shares are of the top-level
    spans' sum, so a nested span is not counted twice."""
    if not _profile:
        return "(profiling not enabled or no stages recorded)"
    total = sum(t for path, (t, _) in _profile.items() if len(path) == 1)
    lines = [f"{'stage':<24s} {'total':>9s} {'calls':>6s} {'mean':>9s} "
             f"{'share':>6s}"]

    def rows(parent):
        kids = [(path, tn) for path, tn in _profile.items()
                if path[:-1] == parent]
        for path, (t, n) in sorted(kids, key=lambda kv: -kv[1][0]):
            name = "  " * (len(path) - 1) + path[-1]
            lines.append(f"{name:<24s} {t * 1e3:8.1f}ms {n:6d} "
                         f"{t / n * 1e3:8.2f}ms {t / total * 100:5.1f}%")
            rows(path)
    rows(())
    return "\n".join(lines)
