"""The yardstick's arithmetic: the card's peaks, the model FLOPs a token
needs, and each kernel call's operations and bytes, reckoned from the
shapes the harness recorded (the kernels are launched through ctypes, so a
profiler sees their names and not their shapes).

The peaks and the decode byte count are chip_smoke.py's (H100_BF16_FLOPS,
H100_HBM_BYTES, `engine_bounds`: weights and every live K/V row read once a
step); the model FLOPs follow its MFU pattern, 2 N a token for serving.

The port's routing, as the program stands when this benchmark was written,
is written down here, since the reckoning follows it:
  * admission (serving/paged_engine.py `admission_route`): a miss prefills
    its prompt padded to a power-of-two bucket of at least one block
    (capped at max_len) with the flash kernel; a prefix hit prefills its
    suffix padded to a power of two of at least 8 rows through stock
    attention; the lm_head takes the last true row only;
  * a decode step runs every slot, active or not: each product and the
    lm_head have `slots` rows, and one paged-decode launch a layer;
  * a quantized product (models/quant.py `matmul`, `expert_einsum`) runs
    the int8_matmul kernel when it has at most 256 rows, else a
    dequantized F.linear; the MoE's experts each take batch x capacity
    rows, capacity = max(1, int(capacity_factor * S * top_k / E)).
Once a later change moves this routing, the counts here go stale: the
readers compare them with the profiler's launch counts and report nothing
when they differ.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
INT8_MATMUL_MAX_ROWS = 256
KV_SCALE_BYTES = 4        # one f32 scale per (token, kv head) for K and for V


def pow2_rows(n: int, floor: int) -> int:
    rows = floor
    while rows < n:
        rows *= 2
    return rows


def admission(plen: int, hit: int, block_size: int, max_len: int) -> tuple[str, int]:
    """(route, rows of the prefill forward) of admitting a plen-token
    prompt with `hit` cached tokens (no chunked prefill)."""
    if not hit:
        return "one-shot", min(pow2_rows(plen, block_size), max_len)
    return "suffix", pow2_rows(plen - hit, 8)


def warm_lengths(lens, block_size: int, max_len: int) -> list[int]:
    """One prompt length per prefill bucket that `lens` reach: the longest
    of `lens` in that bucket."""
    out = {}
    for n in lens:
        b = min(pow2_rows(n, block_size), max_len)
        out[b] = max(out.get(b, 0), n)
    return [out[b] for b in sorted(out)]


def capacity(shape: dict, cf: float, S: int) -> int:
    return max(1, int(cf * S * shape["top_k"] / shape["n_experts"]))


def products(shape: dict) -> list[tuple[str, int, int, int]]:
    """(name, F out, D in, copies) of one layer's weight products; an MoE
    layer's experts have `n_experts` copies each."""
    d, hd = shape["d_model"], shape["head_dim"]
    h, kv, f, e = shape["n_heads"], shape["n_kv_heads"], shape["d_ff"], shape["n_experts"]
    return [("wq", h * hd, d, 1), ("wk", kv * hd, d, 1), ("wv", kv * hd, d, 1),
            ("wo", d, h * hd, 1), ("w_gate", f, d, max(e, 1)), ("w_up", f, d, max(e, 1)),
            ("w_down", d, f, max(e, 1))]


def layer_params_touched(shape: dict) -> int:
    """Weights one token multiplies in one layer: attention, and the FFN's
    (MoE: the router and its top_k experts, not the padded dispatch)."""
    p = 0
    for name, F, D, copies in products(shape):
        expert = name.startswith("w_") and shape["n_experts"]
        p += F * D * (shape["top_k"] if expert else 1)
    if shape["n_experts"]:
        p += shape["n_experts"] * shape["d_model"]
    return p


def attention_flops(shape: dict, keys: float) -> float:
    """QK^T and PV of queries over `keys` (query, key) pairs in all layers."""
    return 4.0 * shape["n_heads"] * shape["head_dim"] * shape["n_layers"] * keys


def prefill_flops(shape: dict, computed: int, hit: int) -> float:
    """Model FLOPs of prefilling `computed` tokens behind `hit` cached ones:
    every layer for each, causal attention, the lm_head for the last."""
    keys = computed * hit + computed * (computed + 1) / 2
    head = 2.0 * shape["vocab_size"] * shape["d_model"]
    return 2.0 * shape["n_layers"] * layer_params_touched(shape) * computed + head \
        + attention_flops(shape, keys)


def decode_flops(shape: dict, tokens: int, keys: float) -> float:
    """Model FLOPs of `tokens` decode tokens attending over `keys` pairs."""
    per = 2.0 * (shape["n_layers"] * layer_params_touched(shape)
                 + shape["vocab_size"] * shape["d_model"])
    return per * tokens + attention_flops(shape, keys)


def int8_matmul_seconds(m: int, F: int, D: int) -> float:
    """The least time of one int8_matmul call: bf16 x [m, D] times int8 q
    [F, D] with f32 scales [F] into bf16 [m, F], each byte once."""
    nbytes = F * D + 4 * F + 2 * m * D + 2 * m * F
    return max(2.0 * m * F * D / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES)


def int8_matmul_calls(shape: dict, rows: int, expert_rows: int, head_rows: int):
    """The int8_matmul calls (m, F, D) of one forward whose products have
    `rows` rows, whose experts each have `expert_rows`, and whose lm_head
    has `head_rows`; products over the row limit run elsewhere."""
    calls = []
    for name, F, D, copies in products(shape):
        expert = name.startswith("w_") and shape["n_experts"]
        m = expert_rows if expert else rows
        if m <= INT8_MATMUL_MAX_ROWS:
            calls += [(m, F, D)] * (copies * shape["n_layers"])
    if head_rows <= INT8_MATMUL_MAX_ROWS:
        calls.append((head_rows, shape["vocab_size"], shape["d_model"]))
    return calls


def prefill_matmul_calls(shape: dict, rows: int, cf: float):
    """One admission's prefill forward of `rows` rows (its bucket)."""
    er = capacity(shape, cf, rows) if shape["n_experts"] else rows
    return int8_matmul_calls(shape, rows, er, 1)


def decode_matmul_calls(shape: dict, slots: int, cf: float):
    """One decode step over `slots` rows (batch slots x 1 position)."""
    er = slots * capacity(shape, cf, 1) if shape["n_experts"] else slots
    return int8_matmul_calls(shape, slots, er, slots)


def kv_row_bytes(shape: dict) -> int:
    """Bytes of one cached token of one layer in the int8 pool: K and V
    int8 rows and their f32 scales, over every kv head."""
    return shape["n_kv_heads"] * 2 * (shape["head_dim"] + KV_SCALE_BYTES)


def paged_attention_seconds(shape: dict, slots: int, keys: float) -> float:
    """The least time of one layer's paged-decode call: the live K/V rows
    (`keys` of them over the active slots) with their scales, and q and the
    output of every slot, each once."""
    qo = 2 * slots * shape["n_heads"] * shape["head_dim"] * 2
    return (keys * kv_row_bytes(shape) + qo) / H100_HBM_BYTES


def flash_seconds(shape: dict, S: int) -> float:
    """The least time of one layer's flash call over a padded prompt of S
    rows (B = 1, causal): its FLOPs or its q, k, v and output bytes."""
    h, kv, hd = shape["n_heads"], shape["n_kv_heads"], shape["head_dim"]
    flops = 4.0 * h * hd * S * (S + 1) / 2
    nbytes = 2 * S * hd * (2 * h + 2 * kv)
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES)


def roofline_share(sl, pattern: str, ideal: list) -> "float | None":
    """100 x the least time of a kernel's calls over the profiled time of
    its launches in slice `sl`; None when the slice holds none of them, or
    not as many as were reckoned (the routing moved, or the trace lost
    some)."""
    if sl is None:
        return None
    launches = sl.kernels(pattern)
    if not launches or len(launches) != len(ideal):
        return None
    return 100.0 * sum(ideal) / (sum(b - a for _, a, b in launches) / 1e9)
