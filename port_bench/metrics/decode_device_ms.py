"""Model step: the device's seconds per decode step. The device seconds
of the slice's operations whose launching call lies inside a
`serve.decode_launch` span, over those spans' `steps` (port_bench/spans.py
ties each operation to its call). Where a kind's calls and operations
differ in number, the middle of the bounds their counts give
(spans.launched_in), read only where the bounds lie at most
spans.AMBIGUITY of it apart. Not read where the trace's clock disagrees
with the slice's."""

from port_bench import spans

NAME = "decode_device_ms"
UNIT = "ms"
LAYER = "model step (models/llama.py, models/quant.py, moe_ffn)"
SOURCE = "device_trace"
MOVES = "tpot_p90_ms"


def read(rec):
    spans.print_report(rec)
    return spans.decode_device_ms(spans.program(rec), rec.slice)
