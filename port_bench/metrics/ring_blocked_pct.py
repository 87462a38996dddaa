"""Decode dispatch, the in-flight ring (serving/pipeline.py): the share of
the window outside the profiled slice in which the host worked with no
decode chunk in flight. The ring's own counter, `host_blocked_s`, summed
over the program's spans (the dispatch and consume spans carry it) over
the seconds those spans cover (port_bench/spans.py)."""

from port_bench import spans

NAME = "ring_blocked_pct"
UNIT = "%"
LAYER = "decode dispatch (serving/paged_engine.py PagedBatchEngine.step_n, serving/pipeline.py)"
SOURCE = "program_counter"
MOVES = "output_tok_s"


def read(rec):
    spans.print_report(rec)
    return spans.ring_blocked_pct(spans.program(rec))
