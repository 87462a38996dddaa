"""Admission's share of the card's peak: the model FLOPs its prefills
need (the prompt tokens computed, hits not counted, causal attention, the
lm_head for the last token; reckon.py) over the seconds of the window's
`submit` calls at the bf16 peak, outside the profiled slice. It bounds
what the flash kernel's roofline can move in time to first token."""

from port_bench import reckon

NAME = "admit_mfu_pct"
UNIT = "%"
LAYER = "admission (serving/paged_engine.py PagedBatchEngine.submit)"
SOURCE = "host_clock"
MOVES = "ttft_p90_ms"


def read(rec):
    adm = [a for a in rec.admissions if not a.sliced]
    seconds = sum(a.t1 - a.t0 for a in adm)
    flops = sum(reckon.prefill_flops(rec.shape, a.plen - a.hit, a.hit) for a in adm)
    return 100.0 * flops / (seconds * reckon.H100_BF16_FLOPS) if seconds and flops else None
