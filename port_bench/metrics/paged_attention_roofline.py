"""Kernel csrc/paged_attention.cu over the int8 pool: the least time of
the slice's calls (the live K/V rows of the active slots with their f32
scales, and every slot's q and output, once at the HBM rate) over the
profiled time of the kernel's launches: one a layer per decode step.
When the launch count differs from the steps', nothing is reported."""

from port_bench import reckon

NAME = "paged_attention_roofline"
UNIT = "%"
LAYER = "kernel csrc/paged_attention.cu (int8 pool)"
SOURCE = "device_trace"
MOVES = "output_tok_s"
PATTERN = r"decode_attention<.*PagedAddr"


def ideal(rec):
    """The least seconds of each launch the slice should hold: a chunk's
    keys spread evenly over its n steps (the sum is what counts)."""
    out = []
    for d in rec.sliced_dispatches:
        per = reckon.paged_attention_seconds(rec.shape, rec.slots, d.keys / d.n)
        out += [per] * (rec.shape["n_layers"] * d.n)
    return out


def read(rec):
    return reckon.roofline_share(rec.slice, PATTERN, ideal(rec))
