"""Runner.timings program.launch: the launch of the tick's device program,
before the synchronise that ends "program", ms per stream-second."""

from bench_port import readers

LAYER = "tracker tick (tracker/device_loop.py)"
UNIT = "ms/s"
MOVES = "realtime_factor"
SOURCE = "program_span"


def read(rec):
    return readers.span_ms_per_stream_s(rec, "program.launch")
