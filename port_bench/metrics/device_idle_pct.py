"""Device: the share of the profiled slice in which no device operation
runs (1 - the union of their intervals / the slice), GPU user
annotations (NCCL's among them) left out. Not read where the trace's clock
disagrees with the slice's (profiling.py)."""

NAME = "device_idle_pct"
UNIT = "%"
LAYER = "device (one H100)"
SOURCE = "device_trace"
MOVES = "output_tok_s"


def read(rec):
    if rec.slice is None or not rec.slice.ops or not rec.slice.clock_ok:
        return None
    return 100.0 * (1.0 - rec.slice.busy_seconds() / rec.slice.seconds)
