"""Admission: the host's own time per admission. The median, over the
admitted requests of the window outside the profiled slice, of the
program's `serve.admission` duration less its `serve.first_token` wait
(the host waiting for the prefill's first token) (port_bench/spans.py)."""

import statistics

from port_bench import spans

NAME = "admit_host_ms_p50"
UNIT = "ms"
LAYER = "admission (serving/paged_engine.py PagedBatchEngine.submit)"
SOURCE = "program_span"
MOVES = "ttft_p90_ms"


def read(rec):
    spans.print_report(rec)
    got = spans.admit_host_ms(spans.program(rec))
    return statistics.median(got) if got else None
