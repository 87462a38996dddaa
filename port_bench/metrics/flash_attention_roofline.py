"""Kernel csrc/flash_attention.cu: the least time of the slice's calls
(causal FLOPs of the padded prompt at the bf16 peak, or its bytes) over
the profiled time of the kernel's launches: one a layer per one-shot
prefill (a prefix miss). When the launch count differs, nothing is
reported; a slice with no miss has nothing to read."""

from port_bench import reckon

NAME = "flash_attention_roofline"
UNIT = "%"
LAYER = "kernel csrc/flash_attention.cu"
SOURCE = "device_trace"
MOVES = "ttft_p90_ms"
PATTERN = r"flash_fwd_kernel"


def ideal(rec):
    """The least seconds of each launch the slice should hold."""
    out = []
    for a in rec.sliced_admissions:
        route, rows = reckon.admission(a.plen, a.hit, rec.block_size, rec.max_len)
        if route == "one-shot":
            out += [reckon.flash_seconds(rec.shape, rows)] * rec.shape["n_layers"]
    return out


def read(rec):
    return reckon.roofline_share(rec.slice, PATTERN, ideal(rec))
