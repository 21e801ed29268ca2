"""Arithmetic the per-layer metric readers share (bench_port/metrics/).

A reader gets the traced run's record: ``spans`` (the program's stage
seconds summed over the window, from ``timings=``), ``steps`` (steps in
the window), ``units`` (stream samples), ``shapes`` (the driver's
shapes), and from the profiled stretch ``kernels`` ({name: (count,
seconds)}), ``profile_steps``, ``busy_s`` and ``window_s``.  A reader
that finds nothing to read returns None.
"""

from __future__ import annotations


def span_ms_per_stream_s(rec, *names, absent=None):
    """Milliseconds of the named spans per second of stream fed; a span
    that never ran reads ``absent``."""
    stream_s = rec["units"] / rec["shapes"]["fs"]
    if stream_s <= 0:
        return None
    if not any(n in rec["spans"] for n in names):
        return absent
    return 1e3 * sum(rec["spans"].get(n, 0.0) for n in names) / stream_s


def idle_pct(rec):
    """Share of the profiled stretch in which no device operation ran."""
    if rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])

