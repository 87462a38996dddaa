"""Admission: `PagedBatchEngine.submit` (bucketed prefill, prefix walk,
scatter into the pool, first token on the host). The median of the
harness's own span around each submit in the window, outside the
profiled slice."""

import statistics

NAME = "admit_ms_p50"
UNIT = "ms"
LAYER = "admission (serving/paged_engine.py PagedBatchEngine.submit)"
SOURCE = "program_span"
MOVES = "ttft_p90_ms"


def read(rec):
    spans = [(a.t1 - a.t0) * 1e3 for a in rec.admissions if not a.sliced]
    return statistics.median(spans) if spans else None
