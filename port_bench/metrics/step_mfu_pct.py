"""Model step: models/llama.py's forwards, models/quant.py's products and
moe_ffn. The model FLOPs the window's tokens need (2 x the non-embedding
weights each token multiplies: attention, and the FFN or the router and
its top-k experts, not the padded dispatch; the lm_head for decode tokens
and each prompt's last; causal attention over each token's context;
prefix-cache hits not counted) over the window's seconds at the bf16
peak, outside the profiled slice (reckon.py)."""

from port_bench import reckon

NAME = "step_mfu_pct"
UNIT = "%"
LAYER = "model step (models/llama.py, models/quant.py, moe_ffn)"
SOURCE = "host_clock"
MOVES = "output_tok_s"


def read(rec):
    flops = sum(reckon.prefill_flops(rec.shape, a.plen - a.hit, a.hit)
                for a in rec.admissions if not a.sliced)
    flops += sum(reckon.decode_flops(rec.shape, d.n * d.active, d.keys)
                 for d in rec.dispatches if not d.sliced)
    return 100.0 * flops / (rec.host_seconds * reckon.H100_BF16_FLOPS) if flops else None
