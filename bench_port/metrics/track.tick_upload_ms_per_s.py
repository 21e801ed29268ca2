"""Runner.timings stage.upload: the tick's one upload (pinned staging and
the copy's launch), ms per stream-second."""

from bench_port import readers

LAYER = "tracker tick (tracker/device_loop.py)"
UNIT = "ms/s"
MOVES = "realtime_factor"
SOURCE = "program_span"


def read(rec):
    return readers.span_ms_per_stream_s(rec, "stage.upload")
