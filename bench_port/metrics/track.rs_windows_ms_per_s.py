"""Runner.timings control.rs: the RS-window chain of every cell's ports
(pending rows, window statistics, FOE/timing feedback, interpolation),
ms per stream-second."""

from bench_port import readers

LAYER = "control loops (tracker/cell_tracker.py)"
UNIT = "ms/s"
MOVES = "realtime_factor"
SOURCE = "program_span"


def read(rec):
    return readers.span_ms_per_stream_s(rec, "control.rs")
