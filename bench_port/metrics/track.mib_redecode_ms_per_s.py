"""Runner.timings control.mib: the 40 ms MIB re-decodes, ms per
stream-second."""

from bench_port import readers

LAYER = "control loops (tracker/cell_tracker.py)"
UNIT = "ms/s"
MOVES = "realtime_factor"
SOURCE = "program_span"


def read(rec):
    return readers.span_ms_per_stream_s(rec, "control.mib")
