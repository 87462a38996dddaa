"""Kernel csrc/int8_matmul.cu: the least time of the slice's calls (each
the larger of 2 m n k at the bf16 peak, the activations being bf16, and
its int8 weight, scales and bf16 input and output bytes once at the HBM
rate) over the profiled time of the kernel's launches. The calls are
reckoned from the slice's admissions and decode steps by the port's
routing (reckon.py); when their count differs from the launches the trace
holds, the routing has moved and nothing is reported."""

from port_bench import reckon

NAME = "int8_matmul_roofline"
UNIT = "%"
LAYER = "kernel csrc/int8_matmul.cu"
SOURCE = "device_trace"
MOVES = "output_tok_s"
PATTERN = r"int8_matmul_(small|tc|wg)"


def ideal(rec):
    """The least seconds of each call the slice should hold."""
    calls = []
    for a in rec.sliced_admissions:
        _, rows = reckon.admission(a.plen, a.hit, rec.block_size, rec.max_len)
        calls += reckon.prefill_matmul_calls(rec.shape, rows, rec.capacity_factor)
    for d in rec.sliced_dispatches:
        calls += reckon.decode_matmul_calls(rec.shape, rec.slots, rec.capacity_factor) * d.n
    return [reckon.int8_matmul_seconds(*c) for c in calls]


def read(rec):
    return reckon.roofline_share(rec.slice, PATTERN, ideal(rec))
