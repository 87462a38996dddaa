"""Model step, the MoE FFN (models/llama.py moe_ffn): the share of the
host's decode launch time spent in its sections. The `moe_route`,
`moe_dispatch`, `moe_experts` and `moe_combine` seconds the program adds
to its `serve.decode_launch` spans, over those spans' duration, in the
window outside the profiled slice (port_bench/spans.py). Nothing to read
in a dense model."""

from port_bench import spans

NAME = "moe_launch_pct"
UNIT = "%"
LAYER = "model step (models/llama.py, models/quant.py, moe_ffn)"
SOURCE = "program_span"
MOVES = "output_tok_s"


def read(rec):
    spans.print_report(rec)
    return spans.moe_launch_pct(spans.program(rec))
