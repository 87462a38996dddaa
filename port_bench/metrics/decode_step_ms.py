"""Decode dispatch: `PagedBatchEngine.step_n` over serving/pipeline.py's
in-flight ring. The window's wall time outside submit over the decode
steps launched in it, both outside the profiled slice."""

NAME = "decode_step_ms"
UNIT = "ms"
LAYER = "decode dispatch (serving/paged_engine.py PagedBatchEngine.step_n, serving/pipeline.py)"
SOURCE = "host_clock"
MOVES = "tpot_p90_ms"


def read(rec):
    steps = sum(d.n for d in rec.dispatches if not d.sliced)
    admit = sum(a.t1 - a.t0 for a in rec.admissions if not a.sliced)
    return (rec.host_seconds - admit) / steps * 1e3 if steps else None
