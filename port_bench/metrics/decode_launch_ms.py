"""Decode dispatch: the host's seconds to launch one decode step. The
program's `serve.decode_launch` spans (the loop of forward_decode_paged
and the sampler in `PagedBatchEngine.step_n`) in the window outside the
profiled slice, their summed duration over their summed `steps`
(port_bench/spans.py). Nothing to read where the program has no such
span."""

from port_bench import spans

NAME = "decode_launch_ms"
UNIT = "ms"
LAYER = "decode dispatch (serving/paged_engine.py PagedBatchEngine.step_n, serving/pipeline.py)"
SOURCE = "program_span"
MOVES = "tpot_p90_ms"


def read(rec):
    spans.print_report(rec)
    return spans.decode_launch_ms(spans.program(rec))
