"""Share of the profiled stretch of stream in which no device operation
ran."""

from bench_port import readers

LAYER = "device (H100)"
UNIT = "%"
MOVES = "realtime_factor"
SOURCE = "device_trace"


def read(rec):
    return readers.idle_pct(rec)
