"""Device: the share of the profiled slice's idle seconds (no device
operation running) whose gap's middle lies inside one of the program's
spans, the device's stamps first moved onto the host's clock by the
least shift that puts no operation before its launching call. The rest is the harness's time between
its calls, which no change to the program can remove (port_bench/spans.py).
Not read where the trace's clock disagrees with the slice's."""

from port_bench import spans

NAME = "idle_in_program_pct"
UNIT = "%"
LAYER = "device (one H100)"
SOURCE = "device_trace"
MOVES = "output_tok_s"


def read(rec):
    spans.print_report(rec)
    return spans.idle_in_program_pct(spans.program(rec), rec.slice)
