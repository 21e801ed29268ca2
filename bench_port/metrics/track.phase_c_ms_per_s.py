"""Runner.timings control.phase_c less control.mib: Phase C's dashboard
measurements, sync SNR and PBCH appends without the MIB re-decodes, ms
per stream-second."""

from bench_port import readers

LAYER = "control loops (tracker/cell_tracker.py)"
UNIT = "ms/s"
MOVES = "realtime_factor"
SOURCE = "program_span"


def read(rec):
    phase_c = readers.span_ms_per_stream_s(rec, "control.phase_c")
    if phase_c is None:
        return None
    return phase_c - readers.span_ms_per_stream_s(rec, "control.mib",
                                                  absent=0.0)
