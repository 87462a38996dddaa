#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lws_tpu_torch) on one GPU and hold its
kernels to their plain PyTorch versions.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # build + kernel checks only (no engine)
    python3 chip_smoke.py --profile    # every phase, and a torch.profiler breakdown
                                       # of steady decode steps of both paged engines
                                       # and the MoE engine, and of steady verify passes

Phases (each raises on failure; the script then exits non-zero and prints
no result line): 1-4 build and hold the kernels, 5-13 drive the engine
paths.
  1. the card (nvidia-smi name and power limit, CUDA version) and the build of
     every CUDA source in lws_tpu_torch/csrc/ for sm_90a, one nvcc per source,
     started together; the compile ledger (lws_tpu_torch/obs/device.py) must
     then hold exactly one `first` record per source that build compiled
     (all four when _build/ was cold, none when warm);
  2. the flash prefill kernel against reference_attention at the flagship's
     attention shapes (H=32, Hkv=8, D=128, bf16, causal): B=1 at several S
     (the paged engines' prefills, and S = 127, 129, 257 for ragged 128-row
     q tiles) and B=8, S=512 (the dense engine's), with
     times of the kernel, the plain version and, as a yardstick only,
     torch's scaled_dot_product_attention;
  3. the paged-decode kernel against its plain version (gather + dense
     attention) on the flagship pool (32 layers, block 16) with a scrambled
     table, block-boundary positions, a null row and a nonzero layer, timed
     at four sets of positions (all slots at 15, the standard mix, all at
     2047, and all at 2047 over 4 shared pool blocks, whose rows stay in
     L2): the bf16 pool, then the int8 pool with its scales (gather +
     dequantize);
  4. the int8_matmul kernel against its plain version at every row count the
     engine paths give it, derived from their routes (1, 8, 16, 40 = a verify
     pass of 8 slots x 5 tokens, 128 and 256), for the flagship's five
     product shapes, with two yardsticks
     timed beside it: torch._weight_int8pack_mm (PyTorch's own W8A16 call,
     held to the plain version first; a shape it refuses is printed) and the
     bf16 F.linear of the same shape (the product the bf16 flagship runs);
     at 128 and 256 rows also the dequantizing route that larger prefills
     take; the int8 dense-cache decode kernel against its plain
     version at B=8, T=2048 with mixed and scalar positions. Decode-shaped
     kernels are timed with the L2 cache scrubbed (a 256 MB read) between
     launches;
  5. the bf16 paged engine at full width: flagship_config("full") in bf16 from
     a seeded torch.Generator. Kernel-path prefill and decode-step logits are
     held to the plain path's on the same weights; then
     PagedBatchEngine(slots=8, max_len=2048, block_size=16) serves 8 greedy
     requests (prompts of 100..1000 tokens, 64 new tokens each), three
     rounds; then the telemetry cost: run_until_drained over the 8 requests
     with tracing on and off, alternated in pairs, both tok/s medians
     printed (not gated);
  6. the int8 paged engine: the bf16 model is freed, then
     flagship_config("full", kv_quant=True) with init_quantized_params (int8
     weights, int8 KV) serves the same requests the same way;
  7. prefix caching, chunked admission and speculative decoding on the same
     int8 model: PagedBatchEngine(slots=8, max_len=2048, block_size=16,
     prefix_cache=True, prefill_chunk=256, interleave_steps=8) serves a
     shared-system-prompt mix (a 200-token unrelated prompt, then a shared
     512-token prefix with suffixes of 40..1200 tokens), decoded plainly in
     round 1 and speculatively (gamma 4, 3-gram prompt lookup) in round 2,
     when every shareable block hits. Then, through the engine's own
     admission, the suffix route at 256 and 16 rows and the chunked hit and
     miss routes: their logits and the K/V rows they leave in the pool held
     to the one-shot prefill; a verify pass over the model's own greedy
     drafts held column by column to successive decode steps, all drafts
     accepted; and the device-resident loop held to the host-loop oracle on
     two fresh engines (token-identical streams);
  8. the dense Engine on the same int8 model: its batched prefill and one
     decode step held to the plain path, then one batch of 8 prompts of 512
     tokens, 64 new tokens each;
  9. the BatchEngine on the same int8 model (slots=8, max_len=2048): a
     slotted decode step from its own admissions (per-slot positions
     100..1000, the int8 decode kernel with a [B] pos) held to the plain
     path, then the paged phases' 8 prompts admitted 4 steps apart, 64 new
     tokens each; its streams are compared with the int8 paged engine's
     (printed, not gated: bf16 near-ties may fork);
 10. the dense Engine(batch_size=1) on the same model: prefill_chunked of a
     1,000-token prompt in chunks of 256 (first-token logits and dequantized
     cache rows held to the one-shot prefill), prefill_chunked_stream of it
     (the emitted K/V bytes equal the final cache rows), generate_speculative
     (gamma 4, 3-gram lookup) on 8 echo prompts (a verify pass held column by
     column to decode steps; acceptance, tokens per dispatch and tok/s
     printed);
 12. (run before 11, whose 47 GB need the flagships freed) the disaggregated
     handoff: the flagship with int8 weights and bf16 K/V as the port's
     disagg_worker.build_model builds it, two Engine(batch_size=1) on those
     weights as the prefill and decode roles, a KVServer on localhost: the
     8 prompts of 5. hand off monolithic (LWS_TPU_KV_CHUNK=0), then with
     chunks of 256 (the prompts over 256 tokens stream), each decoded for
     32 steps through the decode role's pull_bundle + CacheAssembler +
     _decode_bundle, and the longest once more to a gamma-4 speculative
     leg; landed K/V bytes equal the bytes that left, bundle sizes are
     exact, and each stream equals the decode engine's own prefill (or
     prefill_chunked) + decode_n exactly. Then the prefix tiers on the
     int8 model of 6. (int8 pool): the shared-prefix prompt's blocks spilled
     to a KVHostArena, restored from it, and restored by a second engine
     through a RemotePrefixSource over the first engine's KVServer: the
     restored rows equal the spilled rows byte for byte, and the restored
     streams equal the HBM-tier hit's;
 11. MoE: the Mixtral-8x7B geometry (32 layers, 8 experts, top-2, capacity
     factor 2.0) with random int8 weights built in place (~47 GB) and an
     int8 K/V pool: prefill and paged decode logits held to the plain path,
     int8_matmul held to its plain version at every per-expert row count the
     path gives it (timed beside its bound and bf16 F.linear), then
     PagedBatchEngine(slots=8, block_size=16, max_len=2048) serving the 8
     prompts (32 new tokens each) and one Engine.generate;
 13. (run after 12, on the int8 model of 6.) the open-loop load runner: the
     JAX package's built-in shared_prefix scenario (seed 0) through
     lws_tpu_torch.loadgen.run_schedule against an EngineTarget over
     PagedBatchEngine(slots=8, max_len=2048, block_size=16,
     prefix_cache=True); it prints the schedule digest, the completions
     (the client ledger and the engine's server-side TTFT histogram must
     agree), TTFT p50/p99 and goodput per class; then
     build_local_target(kind, spec) with no device, for each engine kind,
     serves the schedule's first 6 requests on the card (bf16, head dim
     128), after the path's launch counts are read.
Every engine path is driven with all kernels' launch counts set to 0 just
before it and read just after, and the counts are checked exactly. The
port's telemetry is armed for paths 5-13 (tracing on, a fresh SLO recorder
per path) and held after each path to what the path did, counted by spies
on the engines' entry points: serving_requests_total{engine} rose by the
requests admitted, the TTFT and queue-wait counts by the same number (a
dense request has no queue wait), the dispatch-duration count equals the
decode dispatches, serving_transfer_bytes_total at paged.dispatch_inputs
equals the bytes of the device inputs the engine rebuilt, every TTFT
exemplar names a span in the tracer and serving_active_slots ends at 0. After 5 and 6,
refresh_device_memory() and the pool gauges: kv equals the pool tensors'
bytes, weights the model's; gpu:0 in use within peak and limit, the
workspace residual >= 0. Path 12's prefix tiers count exactly the bytes
they restore. The last lines are a JSON line of per-kernel numbers, the
card line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import struct
import subprocess
import sys
import threading
import time

import numpy as np

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
FLASH_TOL = 2e-2          # atol = rtol, bf16 outputs (2^-8 relative rounding, f32 sums)
PAGED_TOL = 2e-2
# The decode kernels also against the size of their output: randn K/V over
# up to 2,048 keys give outputs of only ~0.03, where PAGED_TOL alone would
# pass a lost 16-key block (about 15 % of the output's norm at full length).
# On an H100 the kernels read 3.7e-3 to 5.7e-3 at the phases' points (bf16
# outputs and probabilities, rounded in different places).
PAGED_REL_TOL = 1e-2      # ||kernel - plain|| / ||plain|| over the whole output
# int8_matmul: atol = 2e-2 x max |plain| and rtol = 2e-2. Both sum in f32 and
# round once to bf16, in different orders; JAX's dequant path would instead
# multiply by a bf16-rounded scale in bf16, which the kernel does not.
MATMUL_TOL = 2e-2
LOGITS_REL_TOL = 5e-2     # max |kernel - plain| / max |plain| over the vocab, bf16 model
# A route's dequantized int8 K/V rows in the pool against the one-shot
# prefill's: ||pool - one-shot|| / ||one-shot|| over all layers' rows. Rows
# written to a wrong block or with wrong scales read about 1.4.
POOL_REL_TOL = 5e-2
SLOTS, MAX_LEN, BLOCK, NEW_TOKENS, ROUNDS = 8, 2048, 16, 64, 3
# The prefix/chunked/speculative path: a shared system prompt, the chunk
# size, the decode steps between chunks, and the speculative run.
SHARED_PREFIX, CHUNK, INTERLEAVE, GAMMA, NGRAM = 512, 256, 8, 4, 3
VERIFY_ROWS = SLOTS * (GAMMA + 1)
ECHO_SPAN = 12  # the span an echo prompt holds, and the tokens asked of it
# The batch-engine slice: decode steps between the batch engine's staggered
# admissions; the dense engine's chunked/streamed prompt (4 chunks of CHUNK,
# the last padded) and the tokens asked of each speculative request; the
# tokens asked of each MoE request.
STAGGER, DENSE_PROMPT, SPEC_NEW, MOE_NEW_TOKENS = 4, 1000, 32, 32
# The disaggregated handoff: decode steps of each handoff's decode leg; the
# tokens asked of each prefix-tier request; the host arena of the tier
# engine, which holds the shared prefix's blocks and those its restores spill.
HANDOFF_STEPS, TIER_NEW, TIER_ARENA_MB = 32, 16, 128


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else ""


def time_cuda(torch, fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median milliseconds of `fn` by CUDA events, after warmup; `flush`
    (untimed) runs before each timed call."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def rel_err(out, ref) -> float:
    """||out - ref|| / ||ref||, in f32 over the whole tensor."""
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_flash(torch, dev, cfg) -> dict:
    import torch.nn.functional as F

    from lws_tpu_torch.ops.attention import flash_attention, reference_attention

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(1)
    record, worst = None, 0.0
    # (B, S): the paged engines' one-request prefills at their buckets and
    # edges, and the dense engine's batched prefill (8 prompts of 512).
    # S = 127, 129 and 257 put a ragged q tile on each side of the kernel's
    # 128-row tile edges.
    for B, S in ((1, 16), (1, 127), (1, 128), (1, 129), (1, 257), (1, 1000), (1, 1024),
                 (1, 2048), (SLOTS, 512)):
        q = torch.randn(B, S, H, D, generator=g, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16)
        out = flash_attention(q, k, v, causal=True)
        ref = reference_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"flash B={B} S={S}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        check(torch.allclose(out.float(), ref.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
              f"flash B={B} S={S}: max abs err {err} beyond atol=rtol={FLASH_TOL}")
        ms = time_cuda(torch, lambda: flash_attention(q, k, v, causal=True))
        plain_ms = time_cuda(torch, lambda: reference_attention(q, k, v, causal=True))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        try:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            lib()
        except TypeError:  # torch without enable_gqa: expand the kv heads up front
            kx, vx = (t.repeat_interleave(H // Hkv, dim=1) for t in (kt, vt))
            lib = lambda: F.scaled_dot_product_attention(qt, kx, vx, is_causal=True)
        library_ms = time_cuda(torch, lib)
        flops = B * 4 * H * D * S * (S + 1) / 2  # QK^T and PV over the causal half
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, k, v in; o out
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"flash B={B} S={S:5d}: max_abs_err={err:.3e} kernel={ms:.4f} ms "
              f"plain={plain_ms:.4f} ms sdpa={library_ms:.4f} ms bound={bound_ms:.4f} ms "
              f"({bound_by}) roofline={bound_ms / ms:.1%}")
        if (B, S) == (1, 1024):  # the bucket of the longest paged prompt on the main path
            record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}
    record["max_abs_err"] = worst
    return record


def scrubber(torch, dev):
    """An untimed L2 flush (256 MB read) for time_cuda: a decode-step kernel
    finds its inputs cold, since the other layers' weights and K/V pass
    through the 50 MB cache between two launches on one layer. It reads, so
    L2 is left holding clean lines, as those reads leave it: a written
    buffer would leave up to 50 MB of dirty lines whose write-back the timed
    kernel would pay."""
    buf = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    return buf.sum


def paged_table(pos, MB: int, NB: int, seed: int = 2) -> np.ndarray:
    """A scrambled block table for slot positions `pos` over pool blocks
    1..NB-1 (block 0 is the null block)."""
    free = list(np.random.default_rng(seed).permutation(np.arange(1, NB)))
    table = np.zeros((len(pos), MB), np.int32)
    for b, p in enumerate(pos):
        n_live = min(p // BLOCK, MB - 1) + 1
        table[b, :n_live] = [free.pop() for _ in range(n_live)]
    return table


def sdpa_yardstick(torch, q, k_view, v_view, pos, H: int, Hkv: int):
    """One F.scaled_dot_product_attention over the pre-gathered dense bf16
    view (built untimed) with a per-slot additive mask: a yardstick only
    (the port never calls it), and it reads all max_len keys of every slot,
    where the kernel reads the live ones."""
    import torch.nn.functional as F

    B, T = k_view.shape[0], k_view.shape[1]
    qt = q.transpose(1, 2).contiguous()  # [B, H, 1, D]
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k_view, v_view))  # [B, Hkv, T, D]
    keys = torch.arange(T, device=q.device)
    mask = torch.where(keys[None, :] <= pos.long()[:, None], 0.0, float("-inf"))
    mask = mask.to(q.dtype)[:, None, None, :]  # [B, 1, 1, T]
    try:
        fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        fn()
    except (TypeError, RuntimeError):  # no enable_gqa: expand the kv heads up front
        kx, vx = (t.repeat_interleave(H // Hkv, dim=1) for t in (kt, vt))
        fn = lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask)
    return fn, lambda: fn().transpose(1, 2)


def phase_paged(torch, dev, cfg, quant: bool) -> dict:
    """The paged-decode kernel held to its plain version at three sets of
    positions (all slots at 15, the standard mix, all at max_len - 1), each
    timed beside its bound; the mix is the kernel row's record. A fourth
    point, all at max_len - 1 with every slot's table over the same 4 pool
    blocks, reads its rows from L2 after the first touch: the kernel's
    compute and latency floor at full length."""
    from lws_tpu_torch.models.llama import _quantize_kv
    from lws_tpu_torch.ops import paged_attention as pa

    H, Hkv, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    MB = MAX_LEN // BLOCK
    NB = SLOTS * MB + 1
    g = torch.Generator(device=dev).manual_seed(2)
    k_pool = torch.randn(L, NB, BLOCK, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16)
    v_pool = torch.randn(L, NB, BLOCK, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16)
    q = torch.randn(SLOTS, 1, H, D, generator=g, device=dev, dtype=torch.bfloat16)
    if quant:  # the int8 pool and its per-(token, kv head) scales, one layer at a time
        k8 = torch.empty(k_pool.shape, dtype=torch.int8, device=dev)
        v8 = torch.empty_like(k8)
        ks = torch.empty(k_pool.shape[:4], dtype=torch.float32, device=dev)
        vs = torch.empty_like(ks)
        for l in range(L):
            k8[l], ks[l] = _quantize_kv(k_pool[l])
            v8[l], vs[l] = _quantize_kv(v_pool[l])
        del k_pool, v_pool
        pools = (k8, ks, v8, vs)
        kernel, plain = pa.paged_decode_attention_int8, pa.paged_decode_attention_int8_reference
        name, row_bytes = "paged decode int8", Hkv * (D + 4) * 2  # int8 K+V and f32 scales
    else:
        pools = (k_pool, v_pool)
        kernel, plain = pa.paged_decode_attention, pa.paged_decode_attention_reference
        name, row_bytes = "paged decode bf16", Hkv * D * 2 * 2
    flush = scrubber(torch, dev)
    layer, err, worst_rel, record = 17, 0.0, 0.0, None
    # Block-boundary positions (bs-1, bs, 2bs-1), long mixed lengths, and a
    # released slot (row 7: all null, position frozen) in the mix.
    mix = [BLOCK - 1, BLOCK, 2 * BLOCK - 1, 1000, 517, 263, 1063, 40]
    hot = f"all at {MAX_LEN - 1} over 4 pool blocks"
    for point, pos in (("all at 15", [BLOCK - 1] * SLOTS), ("standard mix", mix),
                       (f"all at {MAX_LEN - 1}", [MAX_LEN - 1] * SLOTS),
                       (hot, [MAX_LEN - 1] * SLOTS)):
        pos = np.array(pos, np.int32)
        table = paged_table(pos, MB, NB)
        if point == "standard mix":
            table[SLOTS - 1] = 0  # the released slot
            table[2, 2:6] = table[3, :4]  # stale tail entries pointing at another slot's blocks
        if point == hot:
            table = np.tile(1 + np.arange(MB, dtype=np.int32) % 4, (SLOTS, 1))
        table_d = torch.tensor(table, device=dev)
        pos_d = torch.tensor(pos, device=dev)
        for lay in ((layer, 0, L - 1) if point == "standard mix" else (layer,)):
            out = kernel(q, *pools, table_d, pos_d, lay)
            ref = plain(q, *pools, table_d, pos_d, lay)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{name} {point}: non-finite output")
            e = (out.float() - ref.float()).abs().max().item()
            rel = rel_err(out, ref)
            err, worst_rel = max(err, e), max(worst_rel, rel)
            print(f"{name} {point} layer {lay}: max abs err {e:.3e}, relative err {rel:.3e} "
                  f"(max |plain| {ref.float().abs().max().item():.3e})")
            check(torch.allclose(out.float(), ref.float(), atol=PAGED_TOL, rtol=PAGED_TOL),
                  f"{name} {point} layer {lay}: max abs err {e} beyond atol=rtol={PAGED_TOL}")
            check(rel <= PAGED_REL_TOL, f"{name} {point} layer {lay}: relative err {rel} beyond "
                                        f"{PAGED_REL_TOL}")
        ms = time_cuda(torch, lambda: kernel(q, *pools, table_d, pos_d, layer), reps=50, flush=flush)
        tokens = int((np.minimum(pos, MB * BLOCK - 1) + 1).sum())  # keys this data attends
        nbytes = tokens * row_bytes + 2 * q.numel() * 2 + table.nbytes + pos.nbytes
        bound_ms, bound_by = bound(4 * H * D * tokens, nbytes)
        line = (f"{name} B={SLOTS} {point} ({tokens} keys) layer={layer}: kernel={ms:.4f} ms "
                f"bound={bound_ms:.4f} ms ({bound_by}) share={bound_ms / ms:.1%} "
                f"({nbytes / ms / 1e6:.1f} GB/s)")
        if point == hot:  # no HBM bound: the rows come from L2
            line = (f"{name} B={SLOTS} {point} ({tokens} keys, rows from L2) layer={layer}: "
                    f"kernel={ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s of rows read)")
        if point == "standard mix":
            plain_ms = time_cuda(torch, lambda: plain(q, *pools, table_d, pos_d, layer), reps=20,
                                 flush=flush)
            library_ms = None
            if not quant:
                idx = table_d.long()
                k_view = k_pool[layer][idx].reshape(SLOTS, -1, Hkv, D)
                v_view = v_pool[layer][idx].reshape(SLOTS, -1, Hkv, D)
                lib, lib_out = sdpa_yardstick(torch, q, k_view, v_view, pos_d, H, Hkv)
                ref = plain(q, *pools, table_d, pos_d, layer)
                e = (lib_out().float() - ref.float()).abs().max().item()
                check(e <= 2 * PAGED_TOL, f"{name}: the SDPA yardstick is off by {e}")
                library_ms = time_cuda(torch, lib, reps=50, flush=flush)
                line += f" sdpa(masked, {MAX_LEN} keys per slot)={library_ms:.4f} ms"
                del k_view, v_view
            line += f" plain={plain_ms:.4f} ms"
            record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
        print(line)
    print(f"{name}: max_abs_err={err:.3e}, relative err {worst_rel:.3e} over the four points")
    record["max_abs_err"] = err
    return record


def product_shapes(cfg) -> dict:
    """(D, F) of the flagship's products and how many of each a decode step
    runs (per layer: wq and wo, wk and wv, w_gate and w_up, w_down; once:
    lm_head)."""
    d, kv, f, V, L = cfg.d_model, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff, cfg.vocab_size, \
        cfg.n_layers
    return {(d, d): 2 * L, (d, kv): 2 * L, (d, f): 2 * L, (f, d): L, (d, V): 1}


def int8pack_yardstick(torch, x, q, scale, ref, tol):
    """torch._weight_int8pack_mm(x, q, scale in bf16), PyTorch's own W8A16
    call, as a timing yardstick only (the port never calls it): a callable
    once its output is held to the plain version at `tol` of max |plain|
    (the bf16-rounded scale is within it), or the reason it cannot run."""
    scale16 = scale.to(torch.bfloat16)
    fn = lambda: torch._weight_int8pack_mm(x, q, scale16)
    try:
        out = fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:  # a shape or dtype it refuses
        return None, str(e).splitlines()[0][:160]
    mag = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.allclose(out.float(), ref.float(), atol=tol * mag, rtol=tol),
          f"_weight_int8pack_mm {tuple(x.shape)}x{tuple(q.shape)}: max abs err {err} "
          f"(max |plain| {mag})")
    return fn, None


def phase_int8_matmul(torch, dev, cfg) -> dict:
    import torch.nn.functional as F

    from lws_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference

    g = torch.Generator(device=dev).manual_seed(3)
    flush = scrubber(torch, dev)
    record, worst = None, 0.0
    step = {"ms": 0.0, "bound_ms": 0.0, "bf16": 0.0, "int8pack": 0.0}
    verify = {"ms": 0.0, "bound_ms": 0.0, "bf16": 0.0}  # one verify pass's products
    # One prefill's 7L products at the buckets that take the kernel (128 and
    # 256 rows): the kernel, the dequantizing route that quant.matmul takes
    # above 256 rows, _weight_int8pack_mm and the bf16 F.linear yardstick.
    prefill = {m: {"kernel": 0.0, "dequant": 0.0, "int8pack": 0.0, "bf16": 0.0}
               for m in (128, 256)}
    refused = []
    for (D, Fo), count in product_shapes(cfg).items():
        q = torch.randint(-127, 128, (Fo, D), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(Fo, generator=g, device=dev) * D**-0.5 / 73.3
        w_bf16 = q.to(torch.bfloat16)  # the yardstick's weight, made untimed
        for m in matmul_rows(cfg):
            x = torch.randn(m, D, generator=g, device=dev, dtype=torch.bfloat16)
            out = int8_matmul(x, q, scale)
            ref = int8_matmul_reference(x, q, scale)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"int8_matmul m={m} ({D},{Fo}): non-finite")
            mag = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            worst = max(worst, err / mag)
            check(torch.allclose(out.float(), ref.float(), atol=MATMUL_TOL * mag, rtol=MATMUL_TOL),
                  f"int8_matmul m={m} ({D},{Fo}): max abs err {err} (max |plain| {mag})")
            pack_fn, why = int8pack_yardstick(torch, x, q, scale, ref, MATMUL_TOL)
            ms = time_cuda(torch, lambda: int8_matmul(x, q, scale), flush=flush)
            plain_ms = time_cuda(torch, lambda: int8_matmul_reference(x, q, scale), reps=5,
                                 warmup=1, flush=flush)
            bf16_ms = time_cuda(torch, lambda: F.linear(x, w_bf16), flush=flush)
            # A slow reference kernel (up to ~0.3 s a call): few reps, like the plain version.
            pack_ms = time_cuda(torch, pack_fn, reps=3, warmup=1, flush=flush) if pack_fn else None
            if why:
                refused.append(f"m={m} ({D},{Fo}): {why}")
            nbytes = m * D * 2 + Fo * D + Fo * 4 + m * Fo * 2
            bound_ms, bound_by = bound(2 * m * D * Fo, nbytes)
            pack = f"{pack_ms:.4f} ms" if pack_ms is not None else "refused"
            dequant = ""
            if m in prefill and (D, Fo) != (cfg.d_model, cfg.vocab_size):
                dequant_ms = time_cuda(
                    torch, lambda: F.linear(x, q.to(torch.bfloat16)) * scale.to(torch.bfloat16),
                    flush=flush)
                dequant = f" dequant route={dequant_ms:.4f} ms"
                for key, t in (("kernel", ms), ("dequant", dequant_ms), ("int8pack", pack_ms),
                               ("bf16", bf16_ms)):
                    prefill[m][key] = None if t is None or prefill[m][key] is None \
                        else prefill[m][key] + count * t
            print(f"int8_matmul m={m:3d} (D,F)=({D},{Fo}): rel err {err / mag:.2e} "
                  f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms int8pack={pack} "
                  f"bf16 F.linear={bf16_ms:.4f} ms{dequant} bound={bound_ms:.4f} ms "
                  f"({bound_by}) roofline={bound_ms / ms:.1%}")
            if m == VERIFY_ROWS:
                for key, t in (("ms", ms), ("bound_ms", bound_ms), ("bf16", bf16_ms)):
                    verify[key] += count * t
            if m == 8:
                for key, t in (("ms", ms), ("bound_ms", bound_ms), ("bf16", bf16_ms),
                               ("int8pack", pack_ms)):
                    step[key] = None if t is None or step[key] is None else step[key] + count * t
                if (D, Fo) == (cfg.d_model, cfg.d_ff):  # w_gate / w_up: the largest per layer
                    record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": pack_ms,
                              "library": "torch._weight_int8pack_mm", "bf16_linear_ms": bf16_ms}
        del q, w_bf16
    fmt = lambda t: "refused" if t is None else f"{t:.3f} ms"
    print(f"int8_matmul: one decode step's products at m=8 (7 per layer x {cfg.n_layers} + "
          f"lm_head): {step['ms']:.3f} ms (bound {step['bound_ms']:.3f} ms, "
          f"{step['bound_ms'] / step['ms']:.1%}; int8pack {fmt(step['int8pack'])}; "
          f"bf16 F.linear {fmt(step['bf16'])})")
    print(f"int8_matmul: one verify pass's products at m={VERIFY_ROWS} ({SLOTS} slots x "
          f"{GAMMA + 1} tokens; 7 per layer x {cfg.n_layers} + lm_head): {verify['ms']:.3f} ms "
          f"(bound {verify['bound_ms']:.3f} ms, {verify['bound_ms'] / verify['ms']:.1%}; "
          f"bf16 F.linear {verify['bf16']:.3f} ms)")
    record.update({f"m{VERIFY_ROWS}_pass_ms": verify["ms"],
                   f"m{VERIFY_ROWS}_pass_bound_ms": verify["bound_ms"],
                   f"m{VERIFY_ROWS}_pass_bf16_linear_ms": verify["bf16"]})
    for m, t in prefill.items():
        print(f"int8_matmul: one prefill's 7 x {cfg.n_layers} products at m={m}: kernel "
              f"{fmt(t['kernel'])}, dequantizing route {fmt(t['dequant'])}, int8pack "
              f"{fmt(t['int8pack'])}, bf16 F.linear {fmt(t['bf16'])}")
    for r in refused:
        print(f"int8_matmul: torch._weight_int8pack_mm refused {r}")
    record["max_abs_err"] = worst  # relative to max |plain| (outputs reach ~1e2)
    return record


def phase_int8_decode(torch, dev, cfg) -> dict:
    from lws_tpu_torch.models.llama import _quantize_kv
    from lws_tpu_torch.ops.int8_attention import (
        int8_decode_attention,
        int8_decode_attention_reference,
    )

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, T = SLOTS, MAX_LEN
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(B, 1, H, D, generator=g, device=dev, dtype=torch.bfloat16)
    kq, ks = _quantize_kv(torch.randn(B, T, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16))
    vq, vs = _quantize_kv(torch.randn(B, T, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16))
    pos = np.array([0, 15, 16, T - 1, 517, 1000, 263, 1500], np.int32)
    pos_d = torch.tensor(pos, device=dev)
    err, worst_rel = 0.0, 0.0
    for p in (pos_d, 1000, 0, T - 1):  # per-row positions, then scalar ones
        out = int8_decode_attention(q, kq, ks, vq, vs, p)
        ref = int8_decode_attention_reference(q, kq, ks, vq, vs, p)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "int8 decode: non-finite output")
        e = (out.float() - ref.float()).abs().max().item()
        rel = rel_err(out, ref)
        err, worst_rel = max(err, e), max(worst_rel, rel)
        what = "per-row" if isinstance(p, torch.Tensor) else f"scalar {p}"
        check(torch.allclose(out.float(), ref.float(), atol=PAGED_TOL, rtol=PAGED_TOL),
              f"int8 decode pos {what}: max abs err {e} beyond atol=rtol={PAGED_TOL}")
        check(rel <= PAGED_REL_TOL, f"int8 decode pos {what}: relative err {rel} beyond "
                                    f"{PAGED_REL_TOL}")
    flush = scrubber(torch, dev)
    ms = time_cuda(torch, lambda: int8_decode_attention(q, kq, ks, vq, vs, pos_d), reps=50,
                   flush=flush)
    plain_ms = time_cuda(torch, lambda: int8_decode_attention_reference(q, kq, ks, vq, vs, pos_d),
                         reps=20, flush=flush)
    tokens = int((pos + 1).sum())
    nbytes = tokens * Hkv * (D + 4) * 2 + 2 * q.numel() * 2 + pos.nbytes
    bound_ms, bound_by = bound(4 * H * D * tokens, nbytes)
    print(f"int8 decode B={B} T={T} pos={pos.tolist()}: max_abs_err={err:.3e} relative err "
          f"{worst_rel:.3e} kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}) "
          f"roofline={bound_ms / ms:.1%} ({nbytes / ms / 1e6:.1f} GB/s)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "max_abs_err": err}


def kernel_counters():
    from lws_tpu_torch.ops.attention import flash_attention
    from lws_tpu_torch.ops.int8_attention import int8_decode_attention
    from lws_tpu_torch.ops.int8_matmul import int8_matmul
    from lws_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_int8,
    )

    return {"flash_attention": flash_attention, "paged_decode_attention": paged_decode_attention,
            "paged_decode_attention_int8": paged_decode_attention_int8,
            "int8_matmul": int8_matmul, "int8_decode_attention": int8_decode_attention}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def weight_bytes_per_step(cfg, model) -> int:
    """Bytes a decode step reads of the weights: all but the embedding table
    (a row gather)."""
    from lws_tpu_torch.models.quant import quantized_bytes

    table = model.embed.q.numel() + model.embed.scale.numel() * 4 if model.quantized \
        else model.embed.weight.numel() * model.embed.weight.element_size()
    return quantized_bytes(model) - table


def bucket_of(n: int) -> int:
    """The paged engines' one-shot prefill length for an n-token prompt: a
    power of two, at least one block (the engine's own rule)."""
    from lws_tpu_torch.serving.paged_engine import admission_route

    return admission_route(n, 0, BLOCK, MAX_LEN, None)[1]


def paged_prompt_lens() -> list[int]:
    """The lengths of the plain paged engines' 8 prompts."""
    return [int(n) for n in np.linspace(100, 1000, SLOTS).astype(int)]


def matmul_rows(cfg) -> list[int]:
    """Every row count that the engine paths give int8_matmul (products of
    more than MAX_ROWS rows take the dequantizing route): an admission's
    lm_head row, a decode step's SLOTS rows, a verify pass's VERIFY_ROWS, the
    int8 paged engine's one-shot buckets and the prefix path's route rows.
    The kernel phase holds the kernel to its plain version at each."""
    from lws_tpu_torch.ops.int8_matmul import MAX_ROWS

    rows = {1, SLOTS, VERIFY_ROWS} | {bucket_of(n) for n in paged_prompt_lens()}
    rows |= {route[1] for *_, route in prefix_admissions(prefix_mix(cfg))}
    return sorted(r for r in rows if r <= MAX_ROWS)


def engine_bounds(cfg, weight_bytes: int, lens, new_tokens: int,
                  batched: bool = False) -> tuple[float, float]:
    """The least the card could take for an engine phase's work: (the
    prefill bound in seconds: the median over requests, or with `batched`
    that of one prefill of them all; the decode tok/s bound). A prefill
    runs 2*params flops per token through every product but the lm_head
    (last token only) plus causal attention, and reads the weights once; an
    MoE layer's experts instead compute their n_experts x capacity rows
    each, filled or not (dense dispatch). A decode step reads `weight_bytes`
    (every expert's, for MoE) and every live K/V row (kv_row_bytes, int8
    with scales when kv_quant) once."""
    from lws_tpu_torch.models.flagship import kv_row_bytes
    from lws_tpu_torch.models.llama import moe_capacity

    V, D, L = cfg.vocab_size, cfg.d_model, cfg.n_layers
    H, hd, E = cfg.n_heads, cfg.head_dim, cfg.n_experts
    expert_params = 3 * D * cfg.d_ff  # one expert's products
    prod_params = cfg.n_params() - 2 * V * D - L * E * expert_params
    prefill = []
    for n in lens:
        bucket = bucket_of(n)
        expert_rows = E * moe_capacity(cfg.capacity_factor, bucket, cfg.top_k, E) if E else 0
        prefill.append(2 * prod_params * bucket + 2 * L * expert_params * expert_rows
                       + 2 * V * D + L * 4 * H * hd * bucket * (bucket + 1) / 2)
    prefill_s = bound(sum(prefill), weight_bytes)[0] / 1e3 if batched else \
        statistics.median(bound(f, weight_bytes)[0] / 1e3 for f in prefill)
    steps = new_tokens - 1
    kv_tokens = sum(int(n) + i + 1 for i in range(steps) for n in lens)
    decode_s = (steps * weight_bytes + kv_tokens * kv_row_bytes(cfg)) / H100_HBM_BYTES
    return prefill_s, len(lens) * steps / decode_s


def check_logits_paths(torch, dev, cfg, model, rng, what: str) -> None:
    """Kernel path vs plain path on the same weights: a padded prefill, then
    one paged decode step from the prefilled pool. The plain path launches
    no kernel."""
    from lws_tpu_torch.models.llama import (
        PagedKVCache,
        forward_decode_paged,
        forward_prefill,
        init_cache,
        init_paged_cache,
        paged_insert,
    )

    V = cfg.vocab_size
    plen, bucket = 300, 512
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :plen] = rng.integers(1, V, plen)
    toks = torch.from_numpy(padded).to(dev)
    ck, cp = init_cache(cfg, 1, bucket, dev), init_cache(cfg, 1, bucket, dev)
    lk, ck = forward_prefill(model, toks, ck, last_pos=plen - 1)
    reset_counts()
    lp, cp = forward_prefill(model, toks, cp, last_pos=plen - 1, plain=True)
    torch.cuda.synchronize()
    check(not any(read_counts().values()), f"{what}: the plain prefill launched {read_counts()}")
    check(tuple(lk.shape) == (1, V) and bool(torch.isfinite(lk).all()), "prefill logits shape/finite")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    kv_diff = (ck.k[:, :, :plen].float() - cp.k[:, :, :plen].float()).abs().amax(-1)
    # int8 K: the share of (layer, token, kv head) rows more than 2 steps
    # apart, which rounding alone does not give (an MoE token whose top-k
    # experts differ between the paths at an earlier layer does), over all
    # layers and at layers 0, 1, 2, 4, ...: a share that grows with depth
    # from 0 at layer 0 is routing, one that jumps at layer 1 an expert's
    # product.
    far = ""
    if cfg.kv_quant:
        by_layer = (kv_diff > 2).float().mean(dim=(1, 2, 3))
        layers = [0] + [2**i for i in range(cfg.n_layers.bit_length()) if 2**i < cfg.n_layers]
        far = (f", rows > 2 int8 steps apart {by_layer.mean().item():.3%} (layers "
               + ", ".join(f"{l}: {by_layer[l].item():.2%}" for l in layers) + ")")
    print(f"{what}: prefill logits kernel vs plain: max rel err {rel:.3e} "
          f"(argmax {int(lk.argmax())} vs {int(lp.argmax())}); K cache max abs err "
          f"{kv_diff.max().item():.3e}{far}")
    check(rel <= LOGITS_REL_TOL, f"{what}: prefill logits rel err {rel} > {LOGITS_REL_TOL}")
    n_blocks = bucket // BLOCK
    pool_k = init_paged_cache(cfg, n_blocks + 2, BLOCK, dev)
    scales = (ck.k_scale[:, 0], ck.v_scale[:, 0]) if cfg.kv_quant else ()
    paged_insert(pool_k, ck.k[:, 0], ck.v[:, 0], torch.arange(1, n_blocks + 1, device=dev),
                 *scales)
    pool_p = PagedKVCache(*(None if a is None else a.clone()
                            for a in (pool_k.k, pool_k.v, pool_k.k_scale, pool_k.v_scale)))
    table = torch.zeros(1, MAX_LEN // BLOCK, dtype=torch.int32, device=dev)
    table[0, :n_blocks + 1] = torch.arange(1, n_blocks + 2, device=dev)
    pos = torch.tensor([plen], dtype=torch.int32, device=dev)
    first = lk.argmax(-1).to(torch.int32)
    dk, _ = forward_decode_paged(model, first, pool_k, table, pos)
    reset_counts()
    dp, _ = forward_decode_paged(model, first, pool_p, table, pos, plain=True)
    torch.cuda.synchronize()
    check(not any(read_counts().values()), f"{what}: the plain decode launched {read_counts()}")
    check(tuple(dk.shape) == (1, V) and bool(torch.isfinite(dk).all()), "decode logits shape/finite")
    rel_d = ((dk - dp).abs().max() / dp.abs().max()).item()
    print(f"{what}: decode-step logits kernel vs plain: max rel err {rel_d:.3e} "
          f"(argmax {int(dk.argmax())} vs {int(dp.argmax())})")
    check(rel_d <= LOGITS_REL_TOL, f"{what}: decode logits rel err {rel_d} > {LOGITS_REL_TOL}")


def serve_paged(torch, dev, cfg, model, prompts, what: str, rounds: int = ROUNDS,
                new_tokens: int = NEW_TOKENS) -> tuple:
    """PagedBatchEngine(slots=8, max_len=2048, block_size=16) serves the 8
    prompts for `rounds` rounds (`new_tokens` each) after a warm-up request,
    with the launch counts reset just before and read just after. Returns
    (launches, decode steps, the engine, the last round's streams)."""
    from lws_tpu_torch.models.quant import quantized_bytes
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    V = cfg.vocab_size
    engine = PagedBatchEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
                              device=model.device)
    rng = np.random.default_rng(1)
    warm = engine.submit(rng.integers(1, V, 64).astype(np.int32), 8)  # cuBLAS/allocator warm-up
    engine.run_until_drained()
    check(engine.result(warm) is not None, f"{what}: warm-up request did not finish")
    lens = [len(p) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps0 = engine.stats["decode_steps"]
    reset_counts()
    ttfts, rates = [], []
    by_bucket = {}  # prefill bucket -> TTFTs of its prompts over the rounds
    for r in range(rounds):
        ttft, ids = [], []
        for p in prompts:  # submit returns once the first token is on the host
            t0 = time.perf_counter()
            rid = engine.submit(p, new_tokens)
            ttft.append(time.perf_counter() - t0)
            by_bucket.setdefault(bucket_of(len(p)), []).append(ttft[-1])
            check(rid is not None, f"{what}: engine refused a request with free slots and blocks")
            ids.append(rid)
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        for rid in ids:
            out = engine.result(rid)
            check(out is not None and len(out) == new_tokens,
                  f"{what}: request {rid}: {out and len(out)} tokens")
            check(all(0 <= tok < V for tok in out), f"{what}: request {rid}: token outside [0, {V})")
        acct = engine.pool_accounting()
        check(acct["free"] == acct["total"] and acct["live"] == 0, f"{what}: pool not returned: {acct}")
        decoded = SLOTS * (new_tokens - 1)
        ttfts.append(statistics.median(ttft))
        rates.append(decoded / decode_s)
        print(f"{what} round {r}: {SLOTS} requests, prompts {lens}, {new_tokens} tokens "
              f"each: median TTFT {ttfts[-1] * 1e3:.1f} ms (max {max(ttft) * 1e3:.1f} ms), "
              f"decode {decoded} tokens in {decode_s:.3f} s = {rates[-1]:.1f} tok/s")
    launches = read_counts()
    steps = engine.stats["decode_steps"] - steps0
    peak = torch.cuda.max_memory_allocated(dev)
    ttft_bound, rate_bound = engine_bounds(cfg, weight_bytes_per_step(cfg, model), lens, new_tokens)
    print(f"{what}: median over {rounds} rounds: TTFT {statistics.median(ttfts) * 1e3:.1f} ms "
          f"(bound {ttft_bound * 1e3:.1f} ms), decode {statistics.median(rates):.1f} tok/s "
          f"(bound {rate_bound:.1f} tok/s, {statistics.median(rates) / rate_bound:.1%} of it); "
          f"{steps} decode steps; parameters {quantized_bytes(model) / 1e9:.2f} GB; "
          f"peak memory {peak / 1e9:.2f} GB")
    print(f"{what}: median TTFT by prefill bucket: " + ", ".join(
        f"{b}: {statistics.median(ts) * 1e3:.1f} ms ({len(ts)} admissions)"
        for b, ts in sorted(by_bucket.items())))
    check(steps > 0, f"{what}: no decode step ran")
    return launches, steps, engine, [engine.result(rid) for rid in ids]


def check_launches(what: str, got: dict, want: dict) -> None:
    """Exact launch counts of one main-path run; kernels not in `want`
    must not have launched."""
    for name, n in got.items():
        check(n == want.get(name, 0), f"{what}: {name} launched {n} times, expected "
                                      f"{want.get(name, 0)}")
    print(f"{what}: launches " + ", ".join(f"{k}={v}" for k, v in got.items() if v))


# The loadgen path: the JAX package's built-in shared-prefix scenario and its
# seed, and the bound on its drain.
LOADGEN_SCENARIO, LOADGEN_SEED, LOADGEN_MAX_WALL_S = "shared_prefix", 0, 60.0
LOCAL_TARGET_REQUESTS = 6  # requests each build_local_target kind serves
COST_PAIRS = 3  # tracing-on/off pairs of the telemetry-cost measurement


def hist_count(registry, name: str, match: dict) -> float:
    """Sum of a histogram's `_count` over the series whose labels contain
    `match`."""
    from lws_tpu_torch.core import metrics

    fam = metrics.parse_exposition(registry.render()).get(name)
    if fam is None:
        return 0.0
    return sum(v for n, labels, v, _ in fam["samples"] if n == f"{name}_count"
               and all(labels.get(k) == w for k, w in match.items()))


class TelemetryWatch:
    """Arms the port's telemetry for the engine paths and holds each path's
    telemetry to what the path did. Tracing is on (a tracer whose ring holds
    every span of a path), and every path gets a fresh SLO recorder with its
    own registry, so its TTFT exemplars can only name its own spans. What a
    path did is counted independently of the metrics, by thin spies on the
    engines' entry points: requests admitted (PagedBatchEngine.submit and
    BatchEngine.submit returning an id; each Engine.generate and
    generate_speculative), decode dispatches (step_n returning n > 0; a
    BatchEngine.step that pushed onto its ring) and the bytes of the paged
    engine's dirty dispatch-input uploads."""

    UPLOAD_SITE = {"site": "paged.dispatch_inputs", "direction": "h2d"}

    def __init__(self):
        from lws_tpu_torch.core import trace
        from lws_tpu_torch.serving.batch_engine import BatchEngine
        from lws_tpu_torch.serving.engine import Engine
        from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

        self.tracer = trace.Tracer(ring=1 << 17, enabled=True, sample_rate=1.0)
        trace.TRACER = self.tracer
        self.requests, self.dispatches, self.uploads = {}, {}, [0]
        watch = self

        def count(d, label, n=1):
            d[label] = d.get(label, 0) + n

        def spy_submit(cls, label):
            orig = cls.submit

            def submit(eng, *a, **kw):
                rid = orig(eng, *a, **kw)
                if rid is not None:
                    count(watch.requests, label)
                return rid
            cls.submit = submit

        def spy_generate(name):
            orig = getattr(Engine, name)

            def generate(eng, *a, **kw):
                out = orig(eng, *a, **kw)
                count(watch.requests, "dense")
                return out
            setattr(Engine, name, generate)

        step_n, step, dispatch_inputs = (PagedBatchEngine.step_n, BatchEngine.step,
                                         PagedBatchEngine._dispatch_inputs)

        def spy_step_n(eng, n):
            got = step_n(eng, n)
            if got:
                count(watch.dispatches, "paged")
            return got

        def spy_step(eng):
            before = eng._pipeline.stats["dispatched"]
            step(eng)
            count(watch.dispatches, "batch", eng._pipeline.stats["dispatched"] - before)

        def device_inputs(eng) -> list:
            return [eng._active_dev, eng._table_dev, *(eng._sampling_dev or ())]

        def spy_dispatch_inputs(eng):
            # The bytes that reached the card: every device input the call
            # rebuilt (a new tensor object), whatever the engine's flags say.
            before = [t for t in device_inputs(eng) if t is not None]
            out = dispatch_inputs(eng)
            for t in device_inputs(eng):
                if not any(t is b for b in before):
                    check(t.is_cuda, "dispatch inputs: an input was rebuilt off the card")
                    watch.uploads[0] += t.numel() * t.element_size()
            return out

        spy_submit(PagedBatchEngine, "paged")
        spy_submit(BatchEngine, "batch")
        spy_generate("generate")
        spy_generate("generate_speculative")
        PagedBatchEngine.step_n, BatchEngine.step = spy_step_n, spy_step
        PagedBatchEngine._dispatch_inputs = spy_dispatch_inputs

    def begin(self) -> None:
        from lws_tpu_torch.core import metrics, slo

        self.requests.clear()
        self.dispatches.clear()
        self.uploads[0] = 0
        self.recorder = slo.RECORDER = slo.SLORecorder(registry=metrics.MetricsRegistry())
        reg = metrics.REGISTRY
        self.before = {
            "requests": {e: reg.counter_value("serving_requests_total", {"engine": e})
                         for e in ("paged", "batch", "dense")},
            "dispatches": {e: hist_count(reg, "serving_decode_dispatch_duration_seconds",
                                         {"engine": e}) for e in ("paged", "batch")},
            "uploads": reg.counter_value("serving_transfer_bytes_total", self.UPLOAD_SITE),
        }

    def end(self, what: str) -> dict:
        """The path's checks: serving_requests_total, the TTFT and
        queue-wait counts (a dense request has no queue: 0, as in the JAX
        engine), the dispatch histogram's count, the dispatch-input upload
        bytes, every TTFT exemplar resolving in the tracer, and every
        engine's active slots back at 0."""
        from lws_tpu_torch.core import metrics

        reg, own = metrics.REGISTRY, self.recorder._registry
        for e in ("paged", "batch", "dense"):
            n = self.requests.get(e, 0)
            got = reg.counter_value("serving_requests_total", {"engine": e}) - \
                self.before["requests"][e]
            check(got == n, f"{what}: serving_requests_total{{engine={e}}} rose by {got}, the "
                            f"path admitted {n}")
            ttft = hist_count(own, "serving_ttft_seconds", {"engine": e})
            queue = hist_count(own, "serving_queue_wait_seconds", {"engine": e})
            check(ttft == n and queue == (0 if e == "dense" else n),
                  f"{what}: {e}: TTFT count {ttft}, queue-wait count {queue}, {n} requests")
            if e != "dense":
                d = hist_count(reg, "serving_decode_dispatch_duration_seconds", {"engine": e}) \
                    - self.before["dispatches"][e]
                check(d == self.dispatches.get(e, 0),
                      f"{what}: {e}: {d} dispatch-duration observations, "
                      f"{self.dispatches.get(e, 0)} dispatches")
            if n or self.dispatches.get(e):
                slots = reg.gauge_value("serving_active_slots", {"engine": e})
                check(slots == 0, f"{what}: serving_active_slots{{engine={e}}} ends at {slots}")
        uploads = reg.counter_value("serving_transfer_bytes_total", self.UPLOAD_SITE) - \
            self.before["uploads"]
        check(uploads == self.uploads[0], f"{what}: {uploads} B counted at "
                                          f"paged.dispatch_inputs, {self.uploads[0]} B uploaded")
        known = {sp["trace_id"] for sp in self.tracer.spans()}
        exemplars = {line.split('trace_id="')[1].split('"')[0] for line in own.render().splitlines()
                     if line.startswith("serving_ttft_seconds_bucket") and 'trace_id="' in line}
        check(exemplars <= known, f"{what}: {len(exemplars - known)} TTFT exemplars name no span "
                                  f"in the tracer")
        check(bool(exemplars) or not (self.requests.get("paged") or self.requests.get("dense")),
              f"{what}: no TTFT exemplar")
        print(f"{what}: telemetry: requests {self.requests}, each with its TTFT (and queue wait "
              f"but dense); decode dispatches {self.dispatches}, each observed once; "
              f"{len(exemplars)} TTFT exemplars resolve in the tracer; dispatch-input uploads "
              f"{uploads:.0f} B; active slots end at 0")
        return dict(self.requests)


def check_pools(torch, engine, what: str) -> None:
    """serving_hbm_pool_bytes after refresh_device_memory(): kv equals the
    pool tensors' bytes (num_blocks x block x kv_row_bytes), weights the
    model's tensors' bytes; gpu:0's in-use within its peak and limit, and
    the workspace residual (in-use minus both pools) >= 0."""
    from lws_tpu_torch.core import metrics
    from lws_tpu_torch.models.flagship import kv_row_bytes
    from lws_tpu_torch.obs import device as devicemod

    n = devicemod.refresh_device_memory()
    check(n == torch.cuda.device_count(), f"{what}: device memory refreshed for {n} devices")
    c = engine.cache
    kv = sum(t.numel() * t.element_size() for t in (c.k, c.v, c.k_scale, c.v_scale)
             if t is not None)
    weights = sum(t.numel() * t.element_size() for t in engine.params.state_dict().values())
    g = metrics.REGISTRY.gauge_value
    got_kv, got_w = g("serving_hbm_pool_bytes", {"pool": "kv"}), g("serving_hbm_pool_bytes",
                                                                   {"pool": "weights"})
    check(kv == engine.num_blocks * BLOCK * kv_row_bytes(engine.cfg) and got_kv == kv,
          f"{what}: kv pool gauge {got_kv}, pool tensors {kv} B")
    check(got_w == weights, f"{what}: weights pool gauge {got_w}, model tensors {weights} B")
    dev = {"device": "gpu:0"}
    in_use, limit = g("serving_hbm_bytes_in_use", dev), g("serving_hbm_bytes_limit", dev)
    peak, workspace = g("serving_hbm_peak_bytes", dev), g("serving_hbm_pool_bytes",
                                                          {"pool": "workspace"})
    check(in_use <= peak and in_use <= limit, f"{what}: gpu:0 in use {in_use}, peak {peak}, "
                                              f"limit {limit}")
    check(in_use - weights - kv >= 0 and workspace == in_use - weights - kv,
          f"{what}: workspace residual {in_use - weights - kv}, gauge {workspace}")
    print(f"{what}: pools: kv {kv} B ({engine.num_blocks} blocks of {BLOCK} tokens, "
          f"{kv_row_bytes(engine.cfg)} B a token), weights {weights} B; gpu:0 in use "
          f"{in_use / 1e9:.3f} GB, peak {peak / 1e9:.3f} GB, limit {limit / 1e9:.3f} GB, "
          f"workspace {workspace / 1e9:.3f} GB")


def telemetry_cost(torch, engine, prompts, pairs: int = COST_PAIRS) -> None:
    """Decode tok/s of run_until_drained over the same 8 requests with
    tracing on and off, alternated in pairs (the order flips every pair).
    Printed, not gated: engine tok/s moves 1.3-1.8x between calls."""
    from lws_tpu_torch.core import trace

    rates = {True: [], False: []}
    for i in range(pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            trace.set_enabled(on)
            ids = [engine.submit(p, NEW_TOKENS) for p in prompts]
            check(all(r is not None for r in ids), "telemetry cost: admission refused")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run_until_drained()
            torch.cuda.synchronize()
            rates[on].append(SLOTS * (NEW_TOKENS - 1) / (time.perf_counter() - t0))
    trace.set_enabled(True)
    on, off = statistics.median(rates[True]), statistics.median(rates[False])
    pair = statistics.median(a / b for a, b in zip(rates[True], rates[False]))
    print(f"telemetry cost (bf16 paged engine, {pairs} pairs of run_until_drained, 8 x "
          f"{NEW_TOKENS} tokens): tracing on {on:.1f} tok/s (runs "
          + ", ".join(f"{r:.1f}" for r in rates[True]) + f"), off {off:.1f} tok/s (runs "
          + ", ".join(f"{r:.1f}" for r in rates[False])
          + f"); on/off of the medians {on / off:.4f}, median of the pairs' on/off {pair:.4f} "
            f"(the JAX package's budget: under 2 % of decode tok/s)")


def path_loadgen(torch, dev, cfg, model, recorder) -> dict:
    """13. The open-loop load runner at full width: the built-in
    shared-prefix scenario (seed 0) through lws_tpu_torch.loadgen's
    run_schedule against EngineTarget(PagedBatchEngine(int8 flagship,
    slots=8, max_len=2048, block_size=16, prefix_cache=True)), its class
    targets installed in the path's SLO recorder. The client ledger and the
    engine's server-side SLO histograms must agree on the completions.
    Returns the launches."""
    from lws_tpu_torch import loadgen
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    t_path = time.perf_counter()
    spec = loadgen.load_scenario(LOADGEN_SCENARIO)
    schedule = loadgen.build_schedule(spec, LOADGEN_SEED)
    targets = loadgen.install_class_targets(spec, recorder)
    engine = PagedBatchEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
                              prefix_cache=True, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    result = loadgen.run_schedule(schedule, loadgen.EngineTarget(engine, "paged"),
                                  max_wall_s=LOADGEN_MAX_WALL_S)
    torch.cuda.synchronize()
    launches = read_counts()
    report = loadgen.summarize(result, targets, spec["horizon_s"], spec["name"], LOADGEN_SEED)
    n, done = len(schedule), report["all"]["completed"]
    check(done == n, f"loadgen: {done} of {n} requests completed in {LOADGEN_MAX_WALL_S} s")
    check(report["all"]["tokens"] == sum(r.max_new_tokens for r in schedule),
          f"loadgen: {report['all']['tokens']} tokens delivered")
    outs = [r.tokens for r in engine._completed.values()]
    check(len(outs) == n and all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "loadgen: an engine stream is missing or holds a token outside the vocabulary")
    own = recorder._registry
    for klass in sorted(report["classes"]):
        labels = {"engine": "paged", "klass": klass}
        server = hist_count(own, "serving_ttft_seconds", labels)
        client = report["classes"][klass]["completed"]
        check(server == client, f"loadgen: class {klass}: the engine's TTFT histogram counts "
                                f"{server} requests, the client ledger {client}")
        check(own.counter_value("serving_tokens_total", labels) ==
              report["classes"][klass]["tokens"], f"loadgen: class {klass}: token ledgers differ")
    L, steps, hits = cfg.n_layers, engine.stats["decode_steps"], engine.stats_prefix["hit_blocks"]
    # Every prompt is 20-28 tokens: at most one shareable block, so each
    # hit is one suffix admission and the rest are one-shot misses (flash);
    # every admission's forward and each decode step run their 7L products
    # and one lm_head row through int8_matmul (<= 256 rows).
    check_launches("loadgen", launches, {
        "flash_attention": L * (n - hits),
        "paged_decode_attention_int8": L * steps,
        "int8_matmul": (7 * L + 1) * (steps + n),
    })
    print(f"loadgen: scenario {spec['name']} seed {LOADGEN_SEED}, schedule digest "
          f"{loadgen.schedule_digest(schedule)}: {done} of {n} requests completed "
          f"(client ledger) = {done} TTFT observations (server-side SLO histograms), "
          f"{hits} prefix-hit admissions, {steps} decode steps, run wall "
          f"{result.wall_s:.2f} s, achieved {report['achieved_rps']:.2f} rps of "
          f"{report['offered_rps']:.2f} offered")
    for klass, c in sorted(report["classes"].items()):
        print(f"loadgen: class {klass}: TTFT p50 {c['ttft_p50'] * 1e3:.1f} ms, p99 "
              f"{c['ttft_p99'] * 1e3:.1f} ms; ITL p50 {c['itl_p50'] * 1e3:.2f} ms; goodput "
              f"{c['good_tokens']}/{c['tokens']} tokens = {c['goodput_fraction']:.1%}, "
              f"attainment {c['attainment']:.1%} (targets ttft {targets[klass].ttft_s} s, itl "
              f"{targets[klass].itl_s} s, queue {targets[klass].queue_wait_s} s)")
    drive_local_targets(torch, loadgen, spec, schedule[:LOCAL_TARGET_REQUESTS])
    print(f"loadgen: path wall time {time.perf_counter() - t_path:.1f} s")
    return launches


def drive_local_targets(torch, loadgen, spec, schedule) -> None:
    """build_local_target(kind, spec) with no device, for each engine kind:
    the target lands on the card at the smallest shape the kernels take and
    serves the schedule's first requests through its prefill kernel. Runs
    after path 13's launch counts are read, so they count only the flagship."""
    flash_fn = kernel_counters()["flash_attention"]
    for kind in ("dense", "batch", "paged"):
        target = loadgen.build_local_target(kind, spec)
        check(target.engine.device.type == "cuda", f"loadgen: local {kind} target off the card")
        flash0 = flash_fn.launches
        result = loadgen.run_schedule(schedule, target, max_wall_s=LOADGEN_MAX_WALL_S)
        torch.cuda.synchronize()
        report = loadgen.summarize(result, loadgen.class_targets(spec), spec["horizon_s"])
        flash = flash_fn.launches - flash0
        check(report["all"]["completed"] == len(schedule) and report["all"]["tokens"] ==
              sum(r.max_new_tokens for r in schedule) and flash > 0,
              f"loadgen: local {kind} target completed {report['all']['completed']} of "
              f"{len(schedule)} requests, {report['all']['tokens']} tokens, {flash} flash "
              f"launches")
        print(f"loadgen: build_local_target({kind!r}) on the card (d_model "
              f"{target.engine.cfg.d_model}, bf16): {len(schedule)} of {len(schedule)} "
              f"requests completed, {report['all']['tokens']} tokens, {flash} flash launches")


def path_bf16_paged(torch, dev, cfg) -> tuple:
    from lws_tpu_torch.models.llama import init_params

    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"bf16 engine: flagship 'full' init {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB")
    rng = np.random.default_rng(0)
    check_logits_paths(torch, dev, cfg, model, rng, "bf16 engine")
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in paged_prompt_lens()]
    launches, steps, engine, _ = serve_paged(torch, dev, cfg, model, prompts, "bf16 engine")
    L, admissions = cfg.n_layers, ROUNDS * SLOTS
    check_launches("bf16 engine", launches, {"flash_attention": L * admissions,
                                             "paged_decode_attention": L * steps})
    return launches, engine, prompts


def path_int8_paged(torch, dev, cfg, prompts) -> tuple:
    from lws_tpu_torch.models.flagship import init_quantized_params
    from lws_tpu_torch.models.quant import quantized_bytes

    t0 = time.perf_counter()
    model = init_quantized_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    print(f"int8 engine: flagship 'full' kv_quant init_quantized_params "
          f"{time.perf_counter() - t0:.1f} s, {quantized_bytes(model) / 1e9:.2f} GB of parameters")
    check_logits_paths(torch, dev, cfg, model, np.random.default_rng(0), "int8 engine")
    launches, steps, engine, streams = serve_paged(torch, dev, cfg, model, prompts, "int8 engine")
    L, admissions = cfg.n_layers, ROUNDS * SLOTS
    small = ROUNDS * sum(1 for p in prompts if bucket_of(len(p)) <= 256)
    check_launches("int8 engine", launches, {
        "flash_attention": L * admissions,
        "paged_decode_attention_int8": L * steps,
        # decode: 7 products per layer + lm_head per step; prefill: the 7L
        # products at buckets <= 256 rows, and the lm_head row per admission.
        "int8_matmul": (7 * L + 1) * steps + 7 * L * small + admissions,
    })
    return launches, engine, streams


def prefix_mix(cfg) -> list:
    """The shared-system-prompt mix: a 200-token prompt unrelated to the
    rest, then the shared 512-token prefix with 7 distinct suffixes of
    linspace(40, 1200, 7) tokens, from a seeded generator."""
    rng = np.random.default_rng(5)
    V = cfg.vocab_size
    prefix = rng.integers(1, V, SHARED_PREFIX)
    return [rng.integers(1, V, 200).astype(np.int32)] + [
        np.concatenate([prefix, rng.integers(1, V, n)]).astype(np.int32)
        for n in np.linspace(40, 1200, 7).astype(int)]


def prefix_admissions(prompts) -> list[tuple]:
    """(round, prompt, cached blocks, route) of every admission of the
    prefix path, in submission order. In round 1 the unrelated prompt and
    the prefix's first prompt miss and the rest hit the shared prefix's 32
    blocks; in round 2 every shareable block hits. The route is the
    engine's own: (name, rows of each forward, forwards)."""
    from lws_tpu_torch.serving.paged_engine import admission_route

    out = []
    for rnd in (1, 2):
        for i, p in enumerate(prompts):
            if rnd == 2:
                hit = (len(p) - 1) // BLOCK
            else:
                hit = SHARED_PREFIX // BLOCK if i >= 2 else 0
            out.append((rnd, p, hit, admission_route(len(p), hit * BLOCK, BLOCK, MAX_LEN, CHUNK)))
    return out


def route_label(route: tuple, hit: int) -> str:
    return f"{route[0]} {'hit' if hit else 'miss'}"


def expected_prefix_launches(cfg, admissions, decode_steps: int, spec_dispatches: int) -> dict:
    """Exact launches of the path from its admissions' routes and the
    engine's step and dispatch counts. A one-shot miss runs flash once per
    layer; every route runs its 7 products per layer per forward through
    int8_matmul when the forward has at most MAX_ROWS rows, and one lm_head
    row; a decode step runs the int8 paged kernel per layer and 7L + 1
    products; a verify pass 7L + 1 products of SLOTS x (GAMMA + 1) rows and
    no attention kernel (stock torch over the gathered view)."""
    from lws_tpu_torch.ops.int8_matmul import MAX_ROWS

    L = cfg.n_layers
    flash, products = 0, 0
    for *_, (route, rows, forwards) in admissions:
        if route == "one-shot":
            flash += L
        products += (7 * L * forwards if rows <= MAX_ROWS else 0) + 1
    return {"flash_attention": flash,
            "paged_decode_attention_int8": L * decode_steps,
            "int8_matmul": products + (7 * L + 1) * (decode_steps + spec_dispatches)}


def tokens_so_far(engine, ids) -> int:
    """Tokens the host holds for requests `ids`, finished or not."""
    live = {r.request_id: r for r in engine._active.values()}
    return sum(len((engine._completed.get(i) or live[i]).tokens) for i in ids)


def pool_rows(pool, blocks, plen: int):
    """Dequantized K and V rows [L, plen, Hkv, D] f32 of an int8 pool's
    `blocks`."""
    def rows(x, scale):
        return (x[:, blocks].flatten(1, 2)[:, :plen].float()
                * scale[:, blocks].flatten(1, 2)[:, :plen, :, None])

    return rows(pool.k, pool.k_scale), rows(pool.v, pool.v_scale)


def check_engine_routes(torch, dev, cfg, engine, prompts) -> None:
    """The prefix-hit and chunked routes through the engine's own admission
    (the digest walk, the _dense_view gather of int8 pool blocks and scales,
    the route's forwards, _scatter_dense), at shapes the path runs: a fresh
    233-token suffix on the shared prefix (the suffix route at 256 rows, as
    in round 1), a round-2 prompt again (the suffix route at 16 rows), a
    fresh 620-token suffix (the chunked-hit route) and a fresh 552-token
    prompt (the chunked-miss route). Each asks for one token, so it is
    released at admission. The logits its route computed and the K/V rows
    it leaves in the pool (the hit blocks' cached rows included) are held
    to the one-shot prefill of the same prompt."""
    from lws_tpu_torch.models.llama import forward_prefill, init_cache
    from lws_tpu_torch.serving.paged_engine import admission_route

    rng = np.random.default_rng(7)
    V, prefix = cfg.vocab_size, prompts[2][:SHARED_PREFIX]
    fresh = lambda n: rng.integers(1, V, n).astype(np.int32)
    cases = [("suffix hit", np.concatenate([prefix, fresh(233)]), SHARED_PREFIX // BLOCK),
             ("suffix hit", prompts[3], (len(prompts[3]) - 1) // BLOCK),
             ("chunked hit", np.concatenate([prefix, fresh(620)]), SHARED_PREFIX // BLOCK),
             ("chunked miss", fresh(SHARED_PREFIX + 40), 0)]
    # Each admission's route logits (the return of _insert_with_prefix or
    # _chunk_logits) and the pool blocks _scatter_dense writes.
    wrapped = ("_insert_with_prefix", "_chunk_logits", "_scatter_dense")
    captured = {}
    for name in wrapped:
        method = getattr(engine, name)

        def spy(*a, _m=method, _name=name):
            captured.setdefault(_name, []).append((_m(*a), a))
            return captured[_name][-1][0]

        setattr(engine, name, spy)
    try:
        for what, prompt, hit in cases:
            plen = len(prompt)
            route = admission_route(plen, hit * BLOCK, BLOCK, MAX_LEN, CHUNK)
            check(route_label(route, hit) == what, f"prefix engine: a {plen}-token prompt with "
                                                    f"{hit} cached blocks takes {route}")
            captured.clear()
            before = engine.stats_prefix["hit_blocks"]
            rid = engine.submit(prompt, 1)
            check(rid is not None and engine.stats_prefix["hit_blocks"] - before == hit,
                  f"prefix engine: {what} check: {engine.stats_prefix['hit_blocks'] - before} "
                  f"blocks hit, expected {hit}")
            logits = captured.get("_insert_with_prefix", []) + captured.get("_chunk_logits", [])
            check(len(logits) == 1 and len(captured["_scatter_dense"]) == 1,
                  f"prefix engine: {what} check: {len(logits)} route logits, "
                  f"{len(captured['_scatter_dense'])} scatters")
            bucket = bucket_of(plen)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :plen] = prompt
            ref, ref_cache = forward_prefill(engine.params, torch.tensor(padded, device=dev),
                                             init_cache(cfg, 1, bucket, dev), last_pos=plen - 1)
            got_kv = pool_rows(engine.cache, captured["_scatter_dense"][0][1][1].long(), plen)
            ref_kv = [(x[:, 0, :plen].float() * scale[:, 0, :plen, :, None])
                      for x, scale in ((ref_cache.k, ref_cache.k_scale),
                                       (ref_cache.v, ref_cache.v_scale))]
            got = logits[0][0]
            torch.cuda.synchronize()
            check(tuple(got.shape) == (1, V) and bool(torch.isfinite(got).all()),
                  f"prefix engine: {what} logits shape/finite")
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            kv_rel = max((torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
                         for a, b in zip(got_kv, ref_kv))
            print(f"prefix engine: {what} route ({plen}-token prompt, {hit} cached blocks, "
                  f"{route[2]} forward(s) of {route[1]} rows) vs the one-shot prefill: logits "
                  f"max rel err {rel:.3e} (argmax {int(got.argmax())} vs {int(ref.argmax())}), "
                  f"pool K/V rows rel err {kv_rel:.3e}")
            check(rel <= LOGITS_REL_TOL, f"prefix engine: {what} logits rel err {rel} > "
                                         f"{LOGITS_REL_TOL}")
            check(kv_rel <= POOL_REL_TOL, f"prefix engine: {what} pool rows rel err {kv_rel} > "
                                          f"{POOL_REL_TOL}")
    finally:
        for name in wrapped:
            delattr(engine, name)  # the class's methods again


def check_verify_logits(torch, dev, cfg, model, rng) -> None:
    """A verify pass whose drafts are the model's own greedy tokens. GAMMA
    + 1 paged decode steps from a prefilled pool give the drafts and, column
    by column, the logits that the verify pass must reproduce from a copy of
    the same pool; speculative_accept must then take all GAMMA + 1 tokens."""
    from lws_tpu_torch.models.llama import (
        PagedKVCache,
        forward_decode_paged,
        forward_prefill,
        forward_verify_paged,
        init_cache,
        init_paged_cache,
        paged_insert,
        speculative_accept,
    )

    V, plen, bucket = cfg.vocab_size, 300, 512
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :plen] = rng.integers(1, V, plen)
    logits, cache = forward_prefill(model, torch.tensor(padded, device=dev),
                                    init_cache(cfg, 1, bucket, dev), last_pos=plen - 1)
    n_blocks = bucket // BLOCK
    pool_v = init_paged_cache(cfg, n_blocks + 2, BLOCK, dev)
    paged_insert(pool_v, cache.k[:, 0], cache.v[:, 0], torch.arange(1, n_blocks + 1, device=dev),
                 cache.k_scale[:, 0], cache.v_scale[:, 0])
    pool_d = PagedKVCache(*(a.clone() for a in (pool_v.k, pool_v.v, pool_v.k_scale,
                                                pool_v.v_scale)))
    table = torch.zeros(1, MAX_LEN // BLOCK, dtype=torch.int32, device=dev)
    table[0, :n_blocks + 1] = torch.arange(1, n_blocks + 2, device=dev)
    pos = torch.tensor([plen], dtype=torch.int32, device=dev)
    run = [logits.argmax(-1).to(torch.int32)]  # the running token, then the drafts
    steps = []  # the decode steps' logits [1, V]
    for j in range(GAMMA + 1):
        dl, pool_d = forward_decode_paged(model, run[-1], pool_d, table, pos + j)
        steps.append(dl)
        run.append(dl.argmax(-1).to(torch.int32))
    tokens_in = torch.stack(run[:GAMMA + 1], dim=1)  # [1, GAMMA + 1]
    vl, _ = forward_verify_paged(model, tokens_in, pool_v, table, pos)
    take, out = speculative_accept(tokens_in[:, 1:], vl.argmax(-1).to(torch.int32),
                                   torch.tensor([NEW_TOKENS], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    check(tuple(vl.shape) == (1, GAMMA + 1, V) and bool(torch.isfinite(vl).all()),
          "verify logits shape/finite")
    rels = [((vl[:, j] - dl).abs().max() / dl.abs().max()).item() for j, dl in enumerate(steps)]
    print(f"prefix engine: verify columns 0..{GAMMA} vs the successive paged decode steps: max "
          f"rel err " + ", ".join(f"{r:.3e}" for r in rels) + f"; accepted {int(take) - 1} of "
          f"{GAMMA} greedy drafts")
    check(max(rels) <= LOGITS_REL_TOL, f"prefix engine: verify logits rel err {max(rels)} > "
                                       f"{LOGITS_REL_TOL}")
    want = torch.cat(run[1:])
    check(int(take) == GAMMA + 1 and torch.equal(out[0], want),
          f"prefix engine: speculative_accept took {int(take)} tokens {out[0].tolist()} of the "
          f"decode steps' {want.tolist()}")


def echo_prompts(cfg, engine, rounds: int = 3) -> tuple[list, list]:
    """Prompts that speculation accepts drafts on, even with random weights:
    A + T + W + B + T, with A (168 tokens) and B (64) random, T a random
    NGRAM-gram and W a span of ECHO_SPAN tokens: 250 tokens, one chunk, so
    each is admitted in one shot and none decodes while another is
    admitted (a chunked admission would run the others' steps plainly
    between its chunks). Prompt lookup drafts what
    followed T's first occurrence, so the drafts are accepted as far as the
    model continues the prompt with W itself. W starts random and becomes,
    `rounds` times, the greedy continuation of its own prompt (plain
    decoding on `engine`): W is a small part of a long random context and
    moves the continuation little, so it settles toward a fixed point.
    Returns (prompts, spans)."""
    rng = np.random.default_rng(8)
    V = cfg.vocab_size
    parts = [(rng.integers(1, V, 168), rng.integers(1, V, NGRAM), rng.integers(1, V, 64))
             for _ in range(SLOTS)]
    spans = [rng.integers(1, V, ECHO_SPAN) for _ in range(SLOTS)]

    def build(a, t, b, w):
        return np.concatenate([a, t, w, b, t]).astype(np.int32)

    for _ in range(rounds):
        ids = [engine.submit(build(*part, w), ECHO_SPAN) for part, w in zip(parts, spans)]
        engine.run_until_drained()
        spans = [np.asarray(engine.result(i)) for i in ids]
    return [build(*part, w) for part, w in zip(parts, spans)], spans


def prefix_engine(cfg, model):
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    return PagedBatchEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
                            prefix_cache=True, prefill_chunk=CHUNK, interleave_steps=INTERLEAVE,
                            device=model.device)


def path_int8_prefix_spec(torch, dev, cfg, model, profile: bool = False) -> dict:
    """Prefix caching, chunked admission and speculative decoding on the
    int8 flagship: two rounds of the shared-system-prompt mix (round 1
    plain, round 2 speculative), the route and verify logits checks, and
    the device loop against the host-loop oracle on two fresh engines.
    With `profile`, a torch.profiler breakdown of steady verify passes."""
    t_path = time.perf_counter()
    V, prompts = cfg.vocab_size, prefix_mix(cfg)
    plan = prefix_admissions(prompts)
    engine = prefix_engine(cfg, model)
    torch.cuda.synchronize()
    stats0, hits0 = dict(engine.stats), engine.stats_prefix["hit_blocks"]
    reset_counts()
    ttft_by_route = {}
    for rnd, spec in ((1, False), (2, True)):
        ids = []
        for _, p, hit, route in (a for a in plan if a[0] == rnd):
            before = engine.stats_prefix["hit_blocks"]
            t0 = time.perf_counter()
            rid = engine.submit(p, NEW_TOKENS)  # returns once the first token is on the host
            ttft_by_route.setdefault(route_label(route, hit), []).append(time.perf_counter() - t0)
            check(rid is not None, f"prefix engine: round {rnd} refused a request")
            check(engine.stats_prefix["hit_blocks"] - before == hit,
                  f"prefix engine: round {rnd}, {len(p)}-token prompt hit "
                  f"{engine.stats_prefix['hit_blocks'] - before} blocks, expected {hit}")
            ids.append(rid)
        engine._pipeline.flush()
        torch.cuda.synchronize()
        done0, spec0 = tokens_so_far(engine, ids), dict(engine.stats)
        t0 = time.perf_counter()
        if spec:
            engine.run_until_drained_speculative(gamma=GAMMA, ngram=NGRAM)
        else:
            engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for rid in ids:
            out = engine.result(rid)
            check(out is not None and len(out) == NEW_TOKENS,
                  f"prefix engine: request {rid}: {out and len(out)} tokens")
            check(all(0 <= tok < V for tok in out), f"prefix engine: request {rid}: token "
                                                    f"outside [0, {V})")
        acct = engine.pool_accounting()
        check(acct["free"] + acct["parked"] + acct["live"] == acct["total"] and acct["live"] == 0,
              f"prefix engine: round {rnd}: pool not returned: {acct}")
        decoded = SLOTS * NEW_TOKENS - done0
        line = (f"prefix engine round {rnd} ({'speculative' if spec else 'plain'}): {decoded} "
                f"tokens decoded in {wall:.3f} s = {decoded / wall:.1f} tok/s")
        if spec:
            d = {k: engine.stats[k] - spec0[k] for k in
                 ("spec_dispatches", "spec_drafted", "spec_accepted", "spec_fallback_dispatches")}
            dispatches = d["spec_dispatches"] + d["spec_fallback_dispatches"]
            line += (f"; {d['spec_dispatches']} speculative + {d['spec_fallback_dispatches']} "
                     f"plain dispatches, acceptance {d['spec_accepted']}/{d['spec_drafted']} = "
                     f"{d['spec_accepted'] / max(1, d['spec_drafted']):.1%}, "
                     f"{decoded / dispatches:.2f} tokens per dispatch over {SLOTS} slots")
        print(line + f"; pool {acct}")
    launches = read_counts()
    steps = engine.stats["decode_steps"] - stats0["decode_steps"]
    spec_dispatches = engine.stats["spec_dispatches"] - stats0["spec_dispatches"]
    want_hits = sum(hit for _, _, hit, _ in plan)
    chunked = sum(1 for *_, route in plan if route[0] == "chunked")
    check(engine.stats_prefix["hit_blocks"] - hits0 == want_hits,
          f"prefix engine: {engine.stats_prefix['hit_blocks'] - hits0} hit blocks, "
          f"expected {want_hits}")
    check(engine.stats["chunked_admissions"] - stats0["chunked_admissions"] == chunked,
          f"prefix engine: {engine.stats['chunked_admissions']} chunked admissions, "
          f"expected {chunked}")
    check(engine.stats["interleaved_decode_steps"] > 0, "prefix engine: no decode step ran "
                                                        "between chunks")
    check(spec_dispatches > 0, "prefix engine: no speculative dispatch ran")
    print(f"prefix engine: {len(plan)} admissions ({want_hits} hit blocks, {chunked} "
          f"chunked, {engine.stats['interleaved_decode_steps']} decode steps between chunks), "
          f"{steps} decode steps, {spec_dispatches} verify passes")
    print("prefix engine: median TTFT by route: " + ", ".join(
        f"{route}: {statistics.median(ts) * 1e3:.1f} ms ({len(ts)} admissions)"
        for route, ts in sorted(ttft_by_route.items())))
    check_launches("prefix engine", launches,
                   expected_prefix_launches(cfg, plan, steps, spec_dispatches))
    # Checks outside the counted run: the routes and the verify pass on the
    # kernel path, then the device loop against the host-loop oracle.
    check_engine_routes(torch, dev, cfg, engine, prompts)
    check_verify_logits(torch, dev, cfg, model, np.random.default_rng(6))
    if profile:
        phase_profile(torch, engine, prompts, "int8 speculative engine", speculative=True)
    echo, spans = echo_prompts(cfg, engine)
    del engine
    torch.cuda.empty_cache()
    # The device loop against the host-loop oracle: the round-2 prompts (no
    # draft accepted on random weights), then the echo prompts, whose
    # accepted drafts drive multi-token commits and the budget clamp.
    streams, accepted = [], []
    for sync in (False, True):
        fresh = prefix_engine(cfg, model)
        ids = [fresh.submit(p, NEW_TOKENS) for p in prompts]
        fresh.run_until_drained_speculative(gamma=GAMMA, ngram=NGRAM, sync=sync)
        mix = dict(fresh.stats)
        ids += [fresh.submit(p, ECHO_SPAN) for p in echo]
        fresh.run_until_drained_speculative(gamma=GAMMA, ngram=NGRAM, sync=sync)
        streams.append([fresh.result(i) for i in ids])
        accepted.append((mix["spec_accepted"], fresh.stats["spec_accepted"] - mix["spec_accepted"]))
        print(f"prefix engine, fresh, {'host-loop oracle' if sync else 'device loop'}: "
              f"round-2 prompts {mix['spec_dispatches']} verify passes, {mix['spec_accepted']}/"
              f"{mix['spec_drafted']} drafts accepted; echo prompts "
              f"{fresh.stats['spec_dispatches'] - mix['spec_dispatches']} verify passes, "
              f"{accepted[-1][1]}/{fresh.stats['spec_drafted'] - mix['spec_drafted']} accepted")
        del fresh
        torch.cuda.empty_cache()
    settled = [int(np.argmin(np.append(np.asarray(out) == w, False)))
               for out, w in zip(streams[0][len(prompts):], spans)]
    print(f"prefix engine: echo spans reproduced for {settled} of their {ECHO_SPAN} tokens")
    differ = [i for i, (a, b) in enumerate(zip(*streams)) if a != b]
    check(not differ, f"prefix engine: device loop and host-loop oracle differ on requests "
                      f"{differ}")
    check(accepted[0] == accepted[1] and accepted[0][1] > 0,
          f"prefix engine: accepted drafts (round-2, echo) device loop {accepted[0]}, oracle "
          f"{accepted[1]}")
    print(f"prefix engine: device loop and host-loop oracle token-identical on all "
          f"{len(streams[0])} requests; path wall time {time.perf_counter() - t_path:.1f} s")
    return launches


def path_int8_dense(torch, dev, cfg, model) -> dict:
    from lws_tpu_torch.models.llama import KVCache, forward_prefill, forward_with_cache
    from lws_tpu_torch.serving.engine import Engine

    V, L, plen = cfg.vocab_size, cfg.n_layers, 512
    engine = Engine(cfg, model, batch_size=SLOTS, max_len=MAX_LEN)
    rng = np.random.default_rng(3)
    engine.generate(rng.integers(1, V, (SLOTS, 32)).astype(np.int32), 4)  # warm-up
    prompt = rng.integers(1, V, (SLOTS, plen)).astype(np.int32)
    # The batched prefill as Engine.prefill runs it (flash at B=8, S=512),
    # kernel path vs plain path, each into a fresh cache.
    toks = torch.from_numpy(prompt).to(dev).long()
    lk, ck = forward_prefill(model, toks, engine.new_cache())
    reset_counts()
    lp, cp = forward_prefill(model, toks, engine.new_cache(), plain=True)
    torch.cuda.synchronize()
    check(not any(read_counts().values()), f"dense engine: the plain prefill launched {read_counts()}")
    check(tuple(lk.shape) == (SLOTS, V) and bool(torch.isfinite(lk).all()), "dense prefill logits")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    kv_diff = (ck.k[:, :, :plen] != cp.k[:, :, :plen]).float().mean().item()
    print(f"dense engine: batched prefill logits kernel vs plain: max rel err {rel:.3e} "
          f"(first-token agreement {agree:.0%}); int8 K cache values that differ {kv_diff:.3%}")
    check(rel <= LOGITS_REL_TOL, f"dense engine: prefill logits rel err {rel} > {LOGITS_REL_TOL}")
    # One decode step from the kernel path's cache, kernel path vs plain path.
    tok = lk.argmax(-1).to(torch.int32)
    cp = KVCache(ck.k.clone(), ck.v.clone(), ck.pos, ck.k_scale.clone(), ck.v_scale.clone())
    lk, _ = forward_with_cache(model, tok[:, None], ck)
    reset_counts()
    lp, _ = forward_with_cache(model, tok[:, None], cp, plain=True)
    torch.cuda.synchronize()
    check(not any(read_counts().values()), f"dense engine: the plain step launched {read_counts()}")
    check(tuple(lk.shape) == (SLOTS, V) and bool(torch.isfinite(lk).all()), "dense logits")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    print(f"dense engine: decode-step logits kernel vs plain: max rel err {rel:.3e} "
          f"(argmax agreement {agree:.0%})")
    check(rel <= LOGITS_REL_TOL, f"dense engine: decode logits rel err {rel} > {LOGITS_REL_TOL}")
    del ck, cp
    torch.cuda.synchronize()
    reset_counts()
    res = engine.generate(prompt, NEW_TOKENS)
    launches = read_counts()
    check(res.tokens.shape == (SLOTS, NEW_TOKENS) and ((res.tokens >= 0) & (res.tokens < V)).all(),
          f"dense engine: tokens {res.tokens.shape}")
    steps = res.decode_steps
    ttft_bound, rate_bound = engine_bounds(cfg, weight_bytes_per_step(cfg, model), [plen] * SLOTS,
                                           NEW_TOKENS, batched=True)
    print(f"dense engine: {SLOTS} x {plen}-token prompts, {NEW_TOKENS} tokens each: "
          f"TTFT {res.ttft_s * 1e3:.1f} ms (bound {ttft_bound * 1e3:.1f} ms), decode "
          f"{SLOTS * steps} tokens in {res.decode_s:.3f} s = {res.decode_tokens_per_s:.1f} tok/s "
          f"(bound {rate_bound:.1f} tok/s, {res.decode_tokens_per_s / rate_bound:.1%} of it)")
    check_launches("dense engine", launches, {
        "flash_attention": L,  # one prefill of the whole batch
        "int8_decode_attention": L * steps,
        # decode products at m=8 and the prefill's lm_head row block (m=8);
        # the prefill's 4096-row products take the dequantized route.
        "int8_matmul": (7 * L + 1) * steps + 1,
    })
    return launches


def first_difference(a, b) -> int:
    """The first step at which two token streams differ (their common
    length if none)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def batch_admission_products(cfg, lens) -> int:
    """int8_matmul launches of BatchEngine admissions of prompts of `lens`:
    each prefills its power-of-two bucket (at least 8 rows) alone, with the
    7L products on the kernel at buckets of at most MAX_ROWS rows, and one
    lm_head row."""
    from lws_tpu_torch.ops.int8_matmul import MAX_ROWS
    from lws_tpu_torch.serving.paged_engine import pow2_rows

    return sum(7 * cfg.n_layers * (min(pow2_rows(n, 8), MAX_LEN) <= MAX_ROWS) + 1 for n in lens)


def check_slotted_logits(torch, engine) -> None:
    """One slotted decode step from the engine's own cache (its slots just
    admitted at positions 100..1000), kernel path against plain path, each
    on its own copy of the cache."""
    from lws_tpu_torch.models.llama import KVCache, forward_decode_slotted

    c = engine.cache
    copies = [KVCache(c.k.clone(), c.v.clone(), 0, c.k_scale.clone(), c.v_scale.clone())
              for _ in range(2)]
    lk, _ = forward_decode_slotted(engine.params, engine.tokens, copies[0], engine.pos_b)
    reset_counts()
    lp, _ = forward_decode_slotted(engine.params, engine.tokens, copies[1], engine.pos_b,
                                   plain=True)
    torch.cuda.synchronize()
    check(not any(read_counts().values()), f"batch engine: the plain step launched {read_counts()}")
    check(tuple(lk.shape) == (SLOTS, engine.cfg.vocab_size) and bool(torch.isfinite(lk).all()),
          "batch engine: slotted logits shape/finite")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    print(f"batch engine: slotted decode-step logits kernel vs plain at positions "
          f"{engine.pos_b.tolist()}: max rel err {rel:.3e} (argmax agreement {agree:.0%})")
    check(rel <= LOGITS_REL_TOL, f"batch engine: slotted logits rel err {rel} > {LOGITS_REL_TOL}")


def path_int8_batch(torch, dev, cfg, model, prompts, paged_streams) -> tuple:
    """BatchEngine(slots=8, max_len=2048) on the int8 flagship: a slotted
    decode step from its own admissions held to the plain path, then the
    paged phases' 8 prompts (64 new tokens each) admitted staggered, with
    STAGGER steps between admissions, under exact launch counts. The greedy
    streams are compared with the int8 paged engine's on the same weights
    (printed: bf16 near-ties may fork). Returns (launches, the engine)."""
    from lws_tpu_torch.serving.batch_engine import BatchEngine

    t_path, V, L = time.perf_counter(), cfg.vocab_size, cfg.n_layers
    engine = BatchEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, device=model.device)
    rng = np.random.default_rng(9)
    warm = engine.submit(rng.integers(1, V, 64).astype(np.int32), 8)  # cuBLAS/allocator warm-up
    engine.run_until_drained()
    check(engine.result(warm) is not None, "batch engine: warm-up request did not finish")
    ids = [engine.submit(p, 2) for p in prompts]  # every slot admitted, none stepped yet
    check_slotted_logits(torch, engine)
    engine.run_until_drained()
    check(all(len(engine.result(i)) == 2 for i in ids), "batch engine: check requests unfinished")
    torch.cuda.synchronize()
    steps0 = engine.stats["decode_steps"]
    reset_counts()
    t_run, ttft, ids = time.perf_counter(), [], []
    for p in prompts:
        t0 = time.perf_counter()
        ids.append(engine.submit(p, NEW_TOKENS))  # returns once the first token is on the host
        ttft.append(time.perf_counter() - t0)
        check(ids[-1] is not None, "batch engine: a request was refused with a free slot")
        for _ in range(STAGGER):
            engine.step()
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = read_counts()
    steps = engine.stats["decode_steps"] - steps0
    streams = [engine.result(i) for i in ids]
    for rid, out in zip(ids, streams):
        check(out is not None and len(out) == NEW_TOKENS and all(0 <= t < V for t in out),
              f"batch engine: request {rid}: {out and len(out)} tokens")
    lens = [len(p) for p in prompts]
    decoded = SLOTS * (NEW_TOKENS - 1)
    rate = decoded / (wall - sum(ttft))
    ttft_bound, rate_bound = engine_bounds(cfg, weight_bytes_per_step(cfg, model), lens, NEW_TOKENS)
    print(f"batch engine: {SLOTS} requests admitted {STAGGER} steps apart, prompts {lens}, "
          f"{NEW_TOKENS} tokens each: median TTFT {statistics.median(ttft) * 1e3:.1f} ms (bound "
          f"{ttft_bound * 1e3:.1f} ms), decode {decoded} tokens in {wall - sum(ttft):.3f} s of "
          f"{wall:.3f} s outside submit = {rate:.1f} tok/s (bound {rate_bound:.1f} tok/s, "
          f"{rate / rate_bound:.1%} of it); {steps} decode steps")
    same = [a == b for a, b in zip(streams, paged_streams)]
    print(f"batch engine: {sum(same)} of {SLOTS} greedy streams equal the int8 paged engine's; "
          f"first differing step per request: "
          f"{[first_difference(a, b) for a, b in zip(streams, paged_streams)]}")
    check_launches("batch engine", launches, {
        "flash_attention": L * SLOTS,
        "int8_decode_attention": L * steps,
        "int8_matmul": (7 * L + 1) * steps + batch_admission_products(cfg, lens),
    })
    print(f"batch engine: path wall time {time.perf_counter() - t_path:.1f} s")
    return launches, engine


def dequantized_rows(cache, rows: int):
    """Dequantized K and V rows [L, B, rows, Hkv, D] f32 of an int8 dense cache."""
    return [x[:, :, :rows].float() * scale[:, :, :rows, :, None]
            for x, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale))]


def check_dense_verify_logits(torch, dev, cfg, model, rng) -> None:
    """The dense speculative step's verify pass (forward_with_cache at a
    device position, all logits) over the model's own greedy drafts, held
    column by column to GAMMA + 1 successive decode steps from a copy of
    the same cache."""
    from lws_tpu_torch.models.llama import KVCache, forward_prefill, forward_with_cache, init_cache

    V, plen = cfg.vocab_size, 300
    tokens = torch.tensor(rng.integers(1, V, (1, plen)), device=dev)
    logits, cache = forward_prefill(model, tokens, init_cache(cfg, 1, MAX_LEN, dev))
    steps_cache = KVCache(cache.k.clone(), cache.v.clone(), cache.pos, cache.k_scale.clone(),
                          cache.v_scale.clone())
    run, steps = [logits.argmax(-1).to(torch.int32)], []
    for _ in range(GAMMA + 1):
        dl, steps_cache = forward_with_cache(model, run[-1][:, None], steps_cache)
        steps.append(dl)
        run.append(dl.argmax(-1).to(torch.int32))
    pos = torch.tensor([plen], dtype=torch.int32, device=dev)
    vl, _ = forward_with_cache(model, torch.stack(run[:GAMMA + 1], dim=1), cache, all_logits=True,
                               pos=pos)
    torch.cuda.synchronize()
    check(tuple(vl.shape) == (1, GAMMA + 1, V) and bool(torch.isfinite(vl).all()),
          "dense verify logits shape/finite")
    rels = [((vl[:, j] - dl).abs().max() / dl.abs().max()).item() for j, dl in enumerate(steps)]
    agree = sum(int(vl[0, j].argmax()) == int(run[j + 1]) for j in range(GAMMA + 1))
    print(f"dense engine: verify columns 0..{GAMMA} vs the successive decode steps: max rel err "
          + ", ".join(f"{r:.3e}" for r in rels) + f"; {agree} of {GAMMA + 1} argmaxes agree")
    check(max(rels) <= LOGITS_REL_TOL, f"dense engine: verify logits rel err {max(rels)} > "
                                       f"{LOGITS_REL_TOL}")


def path_int8_dense_modes(torch, dev, cfg, model, batch_engine) -> dict:
    """The dense Engine(batch_size=1) on the int8 flagship: prefill_chunked
    (chunks of CHUNK) of a DENSE_PROMPT-token prompt, prefill_chunked_stream
    of the same prompt (ring depth 1), and generate_speculative (GAMMA,
    NGRAM-gram lookup) on 8 echo prompts built with `batch_engine` and on
    one random prompt that fills the cache to max_len with its tokens, so
    its loop ends in single tail steps, under exact launch counts. Then,
    outside the counted run: the chunked logits and cache rows against the
    one-shot prefill, the streamed bytes against the final cache rows, the
    verify pass against decode steps, the speculative streams against plain
    generate(), and the max_len request's stream against an independent
    forward (check_greedy_chain)."""
    from lws_tpu_torch.models.convert import to_numpy
    from lws_tpu_torch.models.llama import forward_prefill, init_cache
    from lws_tpu_torch.serving.engine import Engine

    t_path, V, L = time.perf_counter(), cfg.vocab_size, cfg.n_layers
    engine = Engine(cfg, model, batch_size=1, max_len=MAX_LEN, device=model.device)
    rng = np.random.default_rng(10)
    engine.generate(rng.integers(1, V, (1, 32)).astype(np.int32), 4)  # warm-up
    echo, _ = echo_prompts(cfg, batch_engine)
    prompt = rng.integers(1, V, (1, DENSE_PROMPT)).astype(np.int32)
    long_prompt = rng.integers(1, V, (1, MAX_LEN - SPEC_NEW)).astype(np.int32)
    sampled = []
    sample = engine._sample
    engine._sample = lambda logits: (sampled.append(logits), sample(logits))[1]
    emitted = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tok_c, cache_c = engine.prefill_chunked(prompt, chunk_size=CHUNK)
    first = int(tok_c[0])
    t_chunked = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok_s, cache_s, stats = engine.prefill_chunked_stream(
        prompt, CHUNK, emit=lambda lo, hi, arrays: emitted.append((lo, hi, arrays)), ring_depth=1)
    t_stream = time.perf_counter() - t0
    del engine._sample  # the class's method again
    spec = [engine.generate_speculative(p[None], SPEC_NEW, gamma=GAMMA, ngram=NGRAM)
            for p in [*echo, long_prompt[0]]]
    launches = read_counts()
    chunked_logits = sampled[0]
    n_chunks = -(-DENSE_PROMPT // CHUNK)
    print(f"dense engine: prefill_chunked of {DENSE_PROMPT} tokens in {n_chunks} chunks of {CHUNK}: "
          f"{t_chunked * 1e3:.1f} ms to the first token; prefill_chunked_stream "
          f"{t_stream * 1e3:.1f} ms, {stats['chunks']} chunks, gather {stats['gather_s'] * 1e3:.1f} ms")
    # The counted run's expected launches: each chunk's 7L products at CHUNK
    # rows and one lm_head row, twice; per speculative request its one-shot
    # prefill (flash, 7L products at its length, one lm_head row), 7L + 1
    # products per verify pass (GAMMA + 1 rows) and per single tail step,
    # whose attention is the int8 decode kernel. The max_len request's
    # prefill has more than MAX_ROWS rows, so only its lm_head row is
    # int8_matmul's.
    from lws_tpu_torch.ops.int8_matmul import MAX_ROWS
    passes = [r.spec_stats["drafted"] // GAMMA for r in spec]
    tails = [r.spec_stats["dispatches"] - n for r, n in zip(spec, passes)]
    check(min(tails) >= 0, f"dense engine: tail steps {tails}")
    check(tails[-1] > 0, "dense engine: the max_len request ran no tail step")
    check_launches("dense modes", launches, {
        "flash_attention": L * len(spec),
        "int8_decode_attention": L * sum(tails),
        "int8_matmul": 2 * (7 * L * n_chunks + 1) + len(echo) * (7 * L + 1)
                       + 7 * L * (long_prompt.shape[1] <= MAX_ROWS) + 1
                       + (7 * L + 1) * (sum(passes) + sum(tails)),
    })
    # Outside the counted run: the one-shot prefill of the same prompt.
    ref, ref_cache = forward_prefill(model, torch.tensor(prompt, device=dev),
                                     init_cache(cfg, 1, DENSE_PROMPT, dev))
    rel = ((chunked_logits - ref).abs().max() / ref.abs().max()).item()
    kv_rel = max((torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
                 for a, b in zip(dequantized_rows(cache_c, DENSE_PROMPT),
                                 dequantized_rows(ref_cache, DENSE_PROMPT)))
    print(f"dense engine: chunked vs one-shot prefill: first-token logits max rel err {rel:.3e} "
          f"(argmax {first} vs {int(ref.argmax())}), cache rows [0, {DENSE_PROMPT}) rel err "
          f"{kv_rel:.3e}")
    check(cache_c.pos == cache_s.pos == DENSE_PROMPT, f"dense engine: pos {cache_c.pos}, "
                                                      f"{cache_s.pos}")
    check(rel <= LOGITS_REL_TOL, f"dense engine: chunked logits rel err {rel} > {LOGITS_REL_TOL}")
    check(kv_rel <= POOL_REL_TOL, f"dense engine: chunked cache rows rel err {kv_rel} > "
                                  f"{POOL_REL_TOL}")
    check(stats["chunks"] == n_chunks and len(emitted) == n_chunks,
          f"dense engine: {stats['chunks']} streamed chunks, expected {n_chunks}")
    check(int(tok_s[0]) == first, "dense engine: streamed and chunked first tokens differ")
    for lo, hi, arrays in emitted:
        check(hi - lo == min(CHUNK, DENSE_PROMPT - lo), f"dense engine: chunk rows {lo}..{hi}")
        for name in ("k", "v", "k_scale", "v_scale"):
            want = to_numpy(getattr(cache_s, name)[:, :, lo:hi])
            check(arrays[name].shape == want.shape and arrays[name].tobytes() == want.tobytes(),
                  f"dense engine: streamed {name} rows {lo}..{hi} differ from the final cache")
        check(np.array_equal(arrays["tokens"], prompt[:, lo:hi]), "dense engine: streamed tokens")
    print(f"dense engine: the {n_chunks} streamed chunks equal the final cache rows byte for byte")
    check_dense_verify_logits(torch, dev, cfg, model, np.random.default_rng(12))
    spec_echo, long = spec[:-1], spec[-1]
    n_echo = len(echo)
    drafted = sum(r.spec_stats["drafted"] for r in spec_echo)
    accepted = sum(r.spec_stats["accepted"] for r in spec_echo)
    decode_s = sum(r.decode_s for r in spec_echo)
    decoded = sum(r.tokens.shape[1] - 1 for r in spec_echo)
    plain = [engine.generate(p[None], SPEC_NEW) for p in [*echo, long_prompt[0]]]
    same = [np.array_equal(r.tokens, q.tokens) for r, q in zip(spec, plain)]
    differ = [first_difference(r.tokens[0], q.tokens[0]) for r, q in zip(spec, plain)]
    plain_rate = sum(q.decode_steps for q in plain[:-1]) / sum(q.decode_s for q in plain[:-1])
    print(f"dense engine: generate_speculative on {n_echo} echo prompts, {SPEC_NEW} tokens "
          f"each: {sum(passes[:-1])} verify passes + {sum(tails[:-1])} single steps, acceptance "
          f"{accepted}/{drafted} = {accepted / max(drafted, 1):.1%}, "
          f"{decoded / max(sum(passes[:-1]) + sum(tails[:-1]), 1):.2f} tokens per dispatch, "
          f"{decoded / decode_s:.1f} tok/s (plain generate {plain_rate:.1f} tok/s); "
          f"{sum(same[:-1])} of {n_echo} streams equal plain generate's, first differing step "
          f"{differ[:-1]}")
    check(accepted > 0, "dense engine: no echo draft was accepted")
    check(long.tokens.shape == (1, SPEC_NEW), f"dense engine: max_len stream {long.tokens.shape}")
    gap = check_greedy_chain(torch, dev, cfg, model, long_prompt, long.tokens[0])
    print(f"dense engine: generate_speculative of a {long_prompt.shape[1]}-token prompt to "
          f"max_len {MAX_LEN}: {passes[-1]} verify passes + {tails[-1]} single tail steps; "
          f"stream {'equals' if same[-1] else 'differs from'} plain generate's (first differing "
          f"step {differ[-1]}); each token's logit within {gap:.3e} of its row's max under an "
          f"independent forward (limit {LOGITS_REL_TOL})")
    print(f"dense engine modes: path wall time {time.perf_counter() - t_path:.1f} s")
    return launches


def check_greedy_chain(torch, dev, cfg, model, prompt, stream, what: str = "dense engine"
                       ) -> float:
    """Holds a greedy `stream` generated after `prompt` [1, P] to an
    independent forward: the one-shot prefill of the prompt, then the
    stream's tokens appended in one forward (dequantized cached attention,
    no decode kernel). Each token's logit must lie within LOGITS_REL_TOL of
    its row's largest |logit| below the row's max (bf16 near-ties may pick
    either); returns the largest such gap."""
    from lws_tpu_torch.models.llama import forward_prefill, forward_with_cache, init_cache
    cache = init_cache(cfg, 1, prompt.shape[1] + len(stream), dev)
    first, cache = forward_prefill(model, torch.tensor(prompt, device=dev), cache)
    rest, _ = forward_with_cache(model, torch.tensor(stream[None, :-1], device=dev), cache,
                                 all_logits=True)
    logits = torch.cat([first[:, None], rest], 1)[0]  # [n, V] f32
    chosen = logits.gather(1, torch.tensor(stream, device=dev).long()[:, None])[:, 0]
    gap = ((logits.max(1).values - chosen) / logits.abs().max(1).values).max().item()
    check(gap <= LOGITS_REL_TOL, f"{what}: a stream token is {gap:.3e} below its row's max "
                                 f"(limit {LOGITS_REL_TOL})")
    return gap


def spec_entry(name: str, dtype: str, shape) -> dict:
    return {"name": name, "dtype": dtype, "shape": [int(d) for d in shape]}


def payload_header_bytes(entries) -> int:
    """Bytes of a KV-wire payload's spec header: !I(spec_len) + the spec
    JSON (lws_tpu/serving/kv_transport.py:pack_payload's format)."""
    return 4 + len(json.dumps({"arrays": entries}).encode())


def run_in_thread(fn):
    """Start fn() in a thread; returns a join() that re-raises its error."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by join()
            box["err"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def join(timeout: float = 600.0):
        thread.join(timeout)
        check(not thread.is_alive(), "a prefill role thread did not finish")
        if "err" in box:
            raise box["err"]
        return box.get("out")

    return join


def one_handoff(torch, pre, dec, server, prompt, chunk: int, rid: str, gamma: int = 0) -> dict:
    """One prefill -> decode handoff over the loopback KVServer, driven as
    the workers drive it: the prefill role's leg (the streamed offer and
    chunked prefill, or the monolithic prefill and offer) in a thread, and
    the decode role's pull_bundle with a CacheAssembler on the card whose
    process() runs _decode_bundle before the ack. Checks, before returning,
    that the K/V bytes that landed on the decode side equal the bytes that
    left (the monolithic payload, or every emitted chunk), and the bundle's
    size: its spec headers plus pos x kv_row_bytes(cfg) (plus 4 bytes a
    prompt token for a stream's "tokens") plus the pos and token tail.
    Returns the handoff's record."""
    from lws_tpu_torch.models.flagship import kv_row_bytes
    from lws_tpu_torch.serving import disagg_worker as dw
    from lws_tpu_torch.serving import kv_transport as kt

    cfg, S = dec.cfg, len(prompt)
    streamed = dw.use_streaming(S, chunk, dec.max_len)
    emitted, landed = [], {}
    if streamed:
        stream_fn = pre.prefill_chunked_stream

        def spy_stream(tokens, chunk_size, emit, **kw):  # keep what left, chunk by chunk
            def keep(lo, hi, arrays):
                emitted.append((lo, hi, arrays))
                emit(lo, hi, arrays)
            return stream_fn(tokens, chunk_size, emit=keep, **kw)

        pre.prefill_chunked_stream = spy_stream
        leg = lambda: dw._prefill_streamed(pre, server, {"id": rid}, rid, prompt, chunk, None)
    else:
        leg = lambda: dw._prefill_monolithic(pre, server, {"id": rid}, rid, prompt, None)
    to_cache = kt.bundle_to_cache

    def spy_to_cache(*a, **kw):  # keep what landed
        landed["cache"], token = to_cache(*a, **kw)
        return landed["cache"], token

    kt.bundle_to_cache = spy_to_cache
    rec = {"prompt": prompt, "chunk": chunk, "streamed": streamed, "gamma": gamma}
    try:
        t0 = time.perf_counter()
        prefill = run_in_thread(leg)

        def process(meta, payload):
            rec["t_landed"] = time.perf_counter()
            rec["toks"], rec["stats"], _ = dw._decode_bundle(dec, payload, HANDOFF_STEPS,
                                                             gamma=gamma, ngram=NGRAM)
            rec["meta"] = meta
            landed["payload"] = payload
            return True

        got = kt.pull_bundle(("127.0.0.1", server.port), timeout=120.0, process=process,
                             ack_timeout=600.0,
                             receiver_factory=lambda m: kt.CacheAssembler(max_len=dec.max_len,
                                                                          device=dec.device))
        prefill()
    finally:
        kt.bundle_to_cache = to_cache
        if streamed:
            del pre.prefill_chunked_stream  # the class's method again
    check(got is True, f"handoff {rid}: no bundle arrived")
    rec["ttft_s"] = rec["t_landed"] - t0 + rec["stats"]["deserialize_s"]
    meta, stats = rec["meta"], rec["stats"]
    handoff = meta["handoff"]
    check(handoff["pos"] == S and stats["bundle_bytes"] == handoff["bundle_bytes"],
          f"handoff {rid}: pos {handoff['pos']}, bytes {stats['bundle_bytes']} vs "
          f"{handoff['bundle_bytes']}")
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    kv = lambda rows: [spec_entry(n, "bfloat16", (L, 1, rows, Hkv, hd)) for n in ("k", "v")]
    if streamed:
        n_chunks = -(-S // chunk)
        check(stats["chunks"] == handoff["chunks"] == len(emitted) == n_chunks,
              f"handoff {rid}: {stats.get('chunks')} chunks, expected {n_chunks}")
        want_bytes = sum(payload_header_bytes(kv(hi - lo) + [spec_entry("tokens", "int32",
                                                                        (1, hi - lo))])
                         + (hi - lo) * (kv_row_bytes(cfg) + 4) for lo, hi, _ in emitted)
        check(meta["payload_bytes"] == want_bytes, f"handoff {rid}: {meta['payload_bytes']} "
                                                   f"stream bytes, expected {want_bytes}")
        bufs = landed["payload"]._bufs
        for lo, hi, arrays in emitted:
            for name in ("k", "v"):
                check(kt.is_bfloat16(arrays[name]), f"handoff {rid}: {name} left untagged")
                got_rows = kt.host_array(bufs[name][:, :, lo:hi])
                check(got_rows.tobytes() == arrays[name].tobytes(),
                      f"handoff {rid}: assembled {name} rows {lo}..{hi} differ from the chunk")
    else:
        payload = landed["payload"]
        (hlen,) = struct.unpack("!I", payload[:4])
        spec = json.loads(bytes(payload[4:4 + hlen]))["arrays"]
        want_spec = kv(S) + [spec_entry("pos", "int32", ()), spec_entry("token", "int32", (1,))]
        check(spec == want_spec, f"handoff {rid}: spec {spec}")
        want_bytes = payload_header_bytes(want_spec) + S * kv_row_bytes(cfg) + 4 + 4
        check(len(payload) == want_bytes, f"handoff {rid}: {len(payload)} bundle bytes, "
                                          f"expected {want_bytes}")
        sent = kt.bytes_to_arrays(payload)
        for name in ("k", "v"):
            got_rows = kt.host_array(getattr(landed["cache"], name)[:, :, :S])
            check(got_rows.tobytes() == sent[name].tobytes(),
                  f"handoff {rid}: landed {name} rows differ from the bundle's")
    return rec


def path_disagg(torch, dev, model8) -> dict:
    """12. The disaggregated handoff at full width: the flagship with int8
    weights and bf16 K/V (kv_quant off) as the port's disagg_worker builds
    it, two Engine(batch_size=1, max_len=2048) on those weights, one the
    prefill role and one the decode role, a KVServer on localhost between
    them. The 8 paged-phase prompts hand off with LWS_TPU_KV_CHUNK=0 (all
    monolithic) and CHUNK (prompts over CHUNK tokens stream), then the
    longest streams once more to a gamma=GAMMA speculative decode leg;
    then the prefix tiers on the int8 model (`model8`, int8 pool): a
    PagedBatchEngine with a KVHostArena serves the shared-prefix prompt
    (miss, then an HBM-tier hit), a filler evicts its blocks into the
    arena, the prompt restores them from the arena, and a second engine
    restores them through a RemotePrefixSource from the first engine's
    KVServer. All of it under exact launch counts; then, outside the
    count, each handoff's tokens against the decode engine's own prefill
    (or prefill_chunked) + decode_n, the speculative stream against an
    independent forward, and each restored stream against the HBM-tier
    hit's. Returns the launches."""
    from lws_tpu_torch.serving import disagg_worker as dw
    from lws_tpu_torch.serving import kv_transport as kt
    from lws_tpu_torch.serving.engine import Engine

    t_path = time.perf_counter()
    cfg, model = dw.build_model(MAX_LEN, dev, scale="full")
    check(not cfg.kv_quant and cfg.dtype == torch.bfloat16, "disagg: the workers' K/V are bf16")
    pre, dec = (Engine(cfg, model, batch_size=1, max_len=MAX_LEN, device=dev) for _ in range(2))
    V, L = cfg.vocab_size, cfg.n_layers
    rng = np.random.default_rng(16)
    pre.generate(rng.integers(1, V, (1, 32)).astype(np.int32), 4)  # warm-up
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in paged_prompt_lens()]
    ml = importlib.util.find_spec("ml_dtypes") is not None
    server = kt.KVServer(port=0, host="127.0.0.1")
    counted = {"spec_steps": 0, "tail_steps": 0}
    torch.cuda.synchronize()
    reset_counts()
    try:
        recs = [one_handoff(torch, pre, dec, server, p, chunk, f"c{chunk}-{len(p)}")
                for chunk in (0, CHUNK) for p in prompts]
        spec_step, decode = dec._spec_step, dec.decode

        def count_spec(*a, **kw):
            counted["spec_steps"] += 1
            return spec_step(*a, **kw)

        def count_tail(*a, **kw):
            counted["tail_steps"] += 1
            return decode(*a, **kw)

        dec._spec_step, dec.decode = count_spec, count_tail
        try:
            spec = one_handoff(torch, pre, dec, server, prompts[-1], CHUNK, "spec", gamma=GAMMA)
        finally:
            del dec._spec_step, dec.decode
    finally:
        server.close()
    tiers, tier_launch = path_prefix_tiers(torch, dev, model8)
    launches = read_counts()
    from lws_tpu_torch.ops.int8_matmul import MAX_ROWS
    want = {"flash_attention": 0, "int8_matmul": 0}
    for r in recs + [spec]:
        S = len(r["prompt"])
        if r["streamed"]:
            want["int8_matmul"] += 7 * L * -(-S // CHUNK) + 1
        else:
            want["flash_attention"] += L
            want["int8_matmul"] += 7 * L * (S <= MAX_ROWS) + 1
        steps = (counted["spec_steps"] + counted["tail_steps"]) if r["gamma"] else HANDOFF_STEPS
        want["int8_matmul"] += (7 * L + 1) * steps
    for name, n in tier_launch.items():
        want[name] = want.get(name, 0) + n
    check_launches("disagg handoff", launches, want)
    # Outside the counted run: the single-engine oracles, on the decode engine.
    single_ttft = []
    for r in recs:
        p = r["prompt"][None]
        t0 = time.perf_counter()
        tok, cache = dec.prefill_chunked(p, chunk_size=CHUNK) if r["streamed"] else dec.prefill(p)
        tok.cpu()
        if not r["streamed"]:
            single_ttft.append(time.perf_counter() - t0)
        _, _, toks = dec.decode_n(tok, cache, HANDOFF_STEPS)
        oracle = np.concatenate([tok.cpu().numpy()[:, None], toks.cpu().numpy()], axis=1)
        mode = "streamed" if r["streamed"] else "monolithic"
        check(np.array_equal(r["toks"], oracle),
              f"disagg handoff: {mode} {r['prompt'].size}-token stream differs from the decode "
              f"engine's own {'prefill_chunked' if r['streamed'] else 'prefill'} + decode_n at "
              f"step {first_difference(r['toks'][0], oracle[0])}")
    gap = check_greedy_chain(torch, dev, cfg, model, spec["prompt"][None], spec["toks"][0],
                             "disagg speculative leg")
    for r in recs + [spec]:
        st, h = r["stats"], r["meta"]["handoff"]
        mb = st["bundle_bytes"] / 1e6
        wire = r["meta"]["wire_s"]
        mode = ("streamed" if r["streamed"] else "monolithic") + (f" gamma={GAMMA}" if r["gamma"]
                                                                  else "")
        print(f"disagg handoff {mode} {r['prompt'].size} tokens: prefill {h['prefill_s'] * 1e3:.1f}"
              f" ms, gather {h['gather_s'] * 1e3:.1f} ms, wire {wire * 1e3:.1f} ms "
              f"({st['bundle_bytes'] / wire / 1e9:.2f} GB/s over loopback), deserialize "
              f"{st['deserialize_s'] * 1e3:.1f} ms, decode {st['decode_s'] * 1e3:.1f} ms "
              f"({HANDOFF_STEPS / st['decode_s']:.1f} tok/s), bundle {mb:.2f} MB, TTFT across "
              f"the handoff {r['ttft_s'] * 1e3:.1f} ms")
    for chunk in (0, CHUNK):
        rs = [r for r in recs if r["chunk"] == chunk]
        rate = statistics.median(HANDOFF_STEPS / r["stats"]["decode_s"] for r in rs)
        print(f"disagg handoff, LWS_TPU_KV_CHUNK={chunk} ({sum(r['streamed'] for r in rs)} of "
              f"{len(rs)} streamed): median TTFT across the handoff "
              f"{statistics.median(r['ttft_s'] for r in rs) * 1e3:.1f} ms against the "
              f"single-engine TTFT {statistics.median(single_ttft) * 1e3:.1f} ms (the decode "
              f"engine's own one-shot prefill of the 8 prompts); decode role {rate:.1f} tok/s "
              f"(median)")
    print(f"disagg handoff: every monolithic and streamed stream ({len(recs)}) equals its "
          f"single-engine oracle; landed K/V bytes equal the bytes that left; spec headers name "
          f"bfloat16 (ml_dtypes {'importable' if ml else 'not installed'} here); speculative leg "
          f"({counted['spec_steps']} verify passes + {counted['tail_steps']} single steps) within "
          f"{gap:.3e} of each row's max under an independent forward")
    print(tiers)
    print(f"disagg handoff: path wall time {time.perf_counter() - t_path:.1f} s")
    return launches


def tier_rows(engine, blk: int) -> dict:
    from lws_tpu_torch.serving.kv_transport import host_array

    return {n: host_array(getattr(engine.cache, n)[:, blk]).tobytes()
            for n in ("k", "v", "k_scale", "v_scale")}


def path_prefix_tiers(torch, dev, model) -> tuple[str, dict]:
    """The host-arena and remote prefix tiers on the int8 flagship (int8
    pool), for path 12. Engine A (slots 2, one request's blocks + the null
    block, a KVHostArena of TIER_ARENA_MB) serves the shared-prefix prompt
    of prefix_mix (miss), then again (its 34 shareable blocks hit in HBM:
    the oracle stream), then a filler whose admission evicts them all into
    the arena, then the prompt again (restored from the arena). Engine B
    (no arena) restores them through a RemotePrefixSource from A's
    KVServer. Checks: the restored pool rows equal the rows spilled, byte
    for byte, and each restored stream equals the HBM-tier hit's. Returns
    (the summary line, the expected launches)."""
    from lws_tpu_torch.core import metrics
    from lws_tpu_torch.serving import kv_transport as kt
    from lws_tpu_torch.serving.kv_host_arena import KVHostArena
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine, admission_route

    cfg = model.cfg
    spill_bytes = {d: metrics.REGISTRY.counter_value("serving_kv_spill_bytes_total",
                                                     {"direction": d})
                   for d in ("spill", "restore")}
    prompt = prefix_mix(cfg)[1]  # the shared 512-token prefix + 40 tokens
    filler = np.random.default_rng(17).integers(1, cfg.vocab_size, 600).astype(np.int32)
    n_shared = (len(prompt) - 1) // BLOCK
    nb = bucket_of(len(prompt)) // BLOCK + 1
    arena = KVHostArena(TIER_ARENA_MB << 20)
    restore_ms = {"host": [], "remote": []}

    def engine(tier, **kw):
        e = PagedBatchEngine(cfg, model, slots=2, max_len=MAX_LEN, block_size=BLOCK,
                             num_blocks=nb, prefix_cache=True, device=dev, **kw)
        restore = e._restore_block

        def timed(d, arrays):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blk = restore(d, arrays)
            torch.cuda.synchronize()
            restore_ms[tier].append((time.perf_counter() - t0) * 1e3)
            return blk

        e._restore_block = timed
        return e

    def serve(e, p):
        rid = e.submit(p, TIER_NEW)
        check(rid is not None, "prefix tiers: admission refused")
        e.run_until_drained()
        out = e.result(rid)
        check(out is not None and len(out) == TIER_NEW, f"prefix tiers: {out and len(out)} tokens")
        return out

    a = engine("host", host_arena=arena)
    digests = a._block_digests(prompt, n_shared)
    serve(a, prompt)
    hbm = serve(a, prompt)
    check(a.stats_prefix["hit_blocks"] == n_shared, f"prefix tiers: {a.stats_prefix}")
    spilled = {d: tier_rows(a, a._prefix_map[d]) for d in digests}
    serve(a, filler)
    check(not any(d in a._prefix_map for d in digests) and all(d in arena for d in digests),
          f"prefix tiers: the filler did not spill the prefix ({a.stats_prefix})")
    host = serve(a, prompt)
    check(a.stats_prefix["host_hits"] == n_shared, f"prefix tiers: {a.stats_prefix}")
    check(all(tier_rows(a, a._prefix_map[d]) == spilled[d] for d in digests),
          "prefix tiers: host-restored pool rows differ from the spilled rows")
    server = kt.KVServer(port=0, host="127.0.0.1")
    fetch_s = []
    try:
        server.serve_prefixes(arena.get)
        src = kt.RemotePrefixSource(endpoints=[("127.0.0.1", server.port)])
        fetch = src.fetch

        def timed_fetch(ds):
            t0 = time.perf_counter()
            found = fetch(ds)
            fetch_s.append(time.perf_counter() - t0)
            return found

        src.fetch = timed_fetch
        b = engine("remote", remote_prefix=src)
        remote = serve(b, prompt)
    finally:
        server.close()
    check(b.stats_prefix["remote_hits"] == n_shared and len(fetch_s) == 1,
          f"prefix tiers: {b.stats_prefix}, {len(fetch_s)} fetches")
    check(all(tier_rows(b, b._prefix_map[d]) == spilled[d] for d in digests),
          "prefix tiers: remote-restored pool rows differ from the spilled rows")
    check(host == hbm and remote == hbm,
          f"prefix tiers: restored streams differ from the HBM-tier hit's (host at "
          f"{first_difference(host, hbm)}, remote at {first_difference(remote, hbm)})")
    block_bytes = sum(len(v) for v in spilled[digests[0]].values())
    spill_bytes = {d: metrics.REGISTRY.counter_value("serving_kv_spill_bytes_total",
                                                     {"direction": d}) - b
                   for d, b in spill_bytes.items()}
    check(spill_bytes["restore"] == 2 * n_shared * block_bytes,
          f"prefix tiers: serving_kv_spill_bytes_total{{direction=restore}} rose by "
          f"{spill_bytes['restore']}, the tiers restored {2 * n_shared} blocks of "
          f"{block_bytes} B")
    admissions = [(None, admission_route(len(p), hit * BLOCK, BLOCK, MAX_LEN, None))
                  for p, hit in ((prompt, 0), (prompt, n_shared), (filler, 0),
                                 (prompt, n_shared), (prompt, n_shared))]
    steps = a.stats["decode_steps"] + b.stats["decode_steps"]
    line = (f"prefix tiers: {n_shared} blocks of the shared prefix ({block_bytes / 1e6:.3f} MB "
            f"each) spilled ({a.stats_prefix['spills']} spills), restored from the host arena at "
            f"{statistics.mean(restore_ms['host']):.3f} ms a block (median "
            f"{statistics.median(restore_ms['host']):.3f}) and from the sibling at "
            f"{statistics.mean(restore_ms['remote']):.3f} ms a block after one "
            f"{fetch_s[0] * 1e3:.1f} ms fetch of {n_shared * block_bytes / 1e6:.1f} MB "
            f"({n_shared * block_bytes / fetch_s[0] / 1e9:.2f} GB/s over loopback); restored rows "
            f"equal the spilled rows byte for byte and both restored streams equal the HBM-tier "
            f"hit's; arena {arena.stats()}; serving_kv_spill_bytes_total counted "
            f"{spill_bytes['restore']:.0f} B restored (= the restored blocks' bytes) and "
            f"{spill_bytes['spill']:.0f} B spilled")
    return line, expected_prefix_launches(cfg, admissions, steps, 0)


def mixtral_config(torch):
    """The Mixtral-8x7B geometry of the published mistralai/Mixtral-8x7B-v0.1
    config (vocab 32000, d_model 4096, 32 layers, 32 heads, 8 KV heads, d_ff
    14336, 8 experts, top-2, rope theta 1e6, RMSNorm eps 1e-5), with the JAX
    package's capacity factor 2.0, bf16 compute and an int8 KV cache."""
    from lws_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                       d_ff=14336, rope_theta=1e6, norm_eps=1e-5, max_seq_len=MAX_LEN,
                       dtype=torch.bfloat16, param_dtype=torch.bfloat16, n_experts=8, top_k=2,
                       capacity_factor=2.0, kv_quant=True)


def init_quantized_moe(torch, cfg, generator, dev):
    """Random int8 MoE weights written straight into a Llama(quantized=True),
    with flagship.init_quantized_params' statistics (values uniform in
    [-127, 127], flat scales fan_in**-0.5 / 73.3, wo and w_down damped by
    (2L)**-0.5); each expert's products like the dense FFN's, the router
    N(0, 1/d) in param_dtype. No bf16 copy of the model is ever made."""
    from lws_tpu_torch.models.flagship import _INT8_UNIFORM_RMS
    from lws_tpu_torch.models.llama import Llama

    model = Llama(cfg, dev, quantized=True)

    def fill(w, fan_in: int, damp: float = 1.0) -> None:
        w.q.random_(-127, 128, generator=generator)
        w.scale.fill_(fan_in**-0.5 * damp / _INT8_UNIFORM_RMS)

    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    damp = (2 * L) ** -0.5
    for blk in model.layers:
        for w in (blk.wq, blk.wk, blk.wv, blk.w_gate, blk.w_up):
            fill(w, d)
        fill(blk.wo, cfg.n_heads * cfg.head_dim, damp)
        fill(blk.w_down, f, damp)
        blk.router.copy_(torch.randn(blk.router.shape, generator=generator, device=dev) * d**-0.5)
    fill(model.embed, 1)
    fill(model.lm_head, d)
    return model


def moe_launches(cfg, admission_rows, decode_steps: int, decode_rows: int) -> int:
    """int8_matmul launches of MoE forwards: per layer the 4 attention
    products and, per expert, its 3 products, each on the kernel when its
    rows fit (the attention products' rows are the forward's tokens, the
    experts' the batch times the capacity), and one lm_head product.
    `admission_rows` lists (tokens, expert rows) of each prefill; a decode
    step has `decode_rows` of each."""
    from lws_tpu_torch.ops.int8_matmul import MAX_ROWS

    L, E = cfg.n_layers, cfg.n_experts
    per = lambda tokens, rows: L * (4 * (tokens <= MAX_ROWS) + 3 * E * (rows <= MAX_ROWS)) + 1
    return sum(per(*r) for r in admission_rows) + decode_steps * per(*decode_rows)


def check_expert_products(torch, dev, cfg, model, rows) -> dict:
    """int8_matmul on one expert's weights (layer 0, expert 0: w_gate's
    (4096, 14336) and w_down's (14336, 4096)) at each per-expert row count
    the MoE path gives it, held to its plain version and timed beside its
    bound and the bf16 F.linear of the same shape. Returns {rows: {...}}."""
    import torch.nn.functional as F

    from lws_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference

    g = torch.Generator(device=dev).manual_seed(13)
    flush = scrubber(torch, dev)
    blk = model.layers[0]
    out = {}
    for m in rows:
        rec = {}
        for name in ("w_gate", "w_down"):
            q, scale = getattr(blk, name).q[0], getattr(blk, name).scale[0]
            Fo, D = q.shape
            x = torch.randn(m, D, generator=g, device=dev, dtype=torch.bfloat16)
            got, ref = int8_matmul(x, q, scale), int8_matmul_reference(x, q, scale)
            torch.cuda.synchronize()
            mag = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            check(torch.allclose(got.float(), ref.float(), atol=MATMUL_TOL * mag, rtol=MATMUL_TOL),
                  f"MoE int8_matmul m={m} ({D},{Fo}): max abs err {err} (max |plain| {mag})")
            w_bf16 = q.to(torch.bfloat16)
            ms = time_cuda(torch, lambda: int8_matmul(x, q, scale), flush=flush)
            plain_ms = time_cuda(torch, lambda: int8_matmul_reference(x, q, scale), reps=5,
                                 warmup=1, flush=flush)
            bf16_ms = time_cuda(torch, lambda: F.linear(x, w_bf16), flush=flush)
            bound_ms, bound_by = bound(2 * m * D * Fo, m * D * 2 + Fo * D + Fo * 4 + m * Fo * 2)
            print(f"MoE int8_matmul m={m:3d} (D,F)=({D},{Fo}) (per expert): rel err "
                  f"{err / mag:.2e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms bf16 "
                  f"F.linear={bf16_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}) "
                  f"roofline={bound_ms / ms:.1%}")
            rec[f"({D},{Fo})"] = {"ms": ms, "plain_ms": plain_ms, "bf16_linear_ms": bf16_ms,
                                  "bound_ms": bound_ms, "max_abs_err": err / mag}
            del w_bf16
        out[m] = rec
    return out


def check_moe_routing_paths(torch, dev, cfg, model) -> None:
    """check_logits_paths on the MoE model with every moe_ffn call's top-2
    expert sets recorded, then the prompt tokens whose sets differ between
    the kernel and the plain prefill, layer by layer, and the gap between
    their 2nd and 3rd router probabilities where a token first differs:
    near-ties that the two paths' bf16 rounding breaks differently."""
    import torch.nn.functional as F

    from lws_tpu_torch.models import llama

    records, moe_ffn = [], llama.moe_ffn

    def spy(x, router, *args, **kw):
        top = torch.topk(torch.softmax(F.linear(x, router.to(x.dtype)).float(), -1), 3, dim=-1)
        records.append((top.indices[..., :2].sort(dim=-1).values, top.values))
        return moe_ffn(x, router, *args, **kw)

    llama.moe_ffn = spy
    try:
        check_logits_paths(torch, dev, cfg, model, np.random.default_rng(0), "MoE engine")
    finally:
        llama.moe_ffn = moe_ffn
    L, plen = cfg.n_layers, 300  # check_logits_paths' prompt: its prefills are the first 2L calls
    ever = torch.zeros(plen, dtype=torch.bool, device=dev)
    per_layer, gaps = [], []
    for (k_sets, k_top), (p_sets, _) in zip(records[:L], records[L:2 * L]):
        differ = (k_sets[0, :plen] != p_sets[0, :plen]).any(dim=-1)
        gaps += (k_top[0, :plen, 1] - k_top[0, :plen, 2])[differ & ~ever].tolist()
        ever |= differ
        per_layer.append(int(differ.sum()))
    print(f"MoE engine: prompt tokens whose top-2 experts differ between the kernel and plain "
          f"prefill, by layer: {per_layer}; {int(ever.sum())} of {plen} tokens at some layer; "
          f"2nd-3rd router probability gap where a token first differs: max "
          f"{max(gaps, default=0.0):.4f}, median over all tokens of the last layer "
          f"{(records[L - 1][1][0, :plen, 1] - records[L - 1][1][0, :plen, 2]).median().item():.4f}")


def path_int8_moe(torch, dev, profile: bool = False) -> tuple:
    """The Mixtral-8x7B geometry with random int8 weights (init_quantized_moe)
    and an int8 K/V pool at full depth: prefill and decode logits kernel vs
    plain; int8_matmul at every per-expert row count of the path; then
    PagedBatchEngine(slots=8, block_size=16, max_len=2048) serving the paged
    phases' 8 prompts (MOE_NEW_TOKENS each) and one Engine.generate of the
    first prompt, each under exact launch counts. With `profile`, a
    torch.profiler breakdown of steady paged decode steps. Returns
    (launches, the per-expert product records)."""
    from lws_tpu_torch.models.llama import moe_capacity
    from lws_tpu_torch.models.quant import quantized_bytes
    from lws_tpu_torch.ops.int8_matmul import MAX_ROWS
    from lws_tpu_torch.serving.engine import Engine

    cfg = mixtral_config(torch)
    V, L, E, K, cf = cfg.vocab_size, cfg.n_layers, cfg.n_experts, cfg.top_k, cfg.capacity_factor
    t0 = time.perf_counter()
    model = init_quantized_moe(torch, cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    expert_bytes = sum(getattr(b, n).q.numel() + getattr(b, n).scale.numel() * 4
                       for b in model.layers for n in ("w_gate", "w_up", "w_down"))
    print(f"MoE engine: Mixtral-8x7B geometry, int8, {L} layers x {E} experts: init "
          f"{time.perf_counter() - t0:.1f} s, {quantized_bytes(model) / 1e9:.2f} GB of parameters "
          f"({expert_bytes / 1e9:.2f} GB of experts), {cfg.n_params() / 1e9:.2f} B parameters")
    check_moe_routing_paths(torch, dev, cfg, model)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in paged_prompt_lens()]
    cap = lambda S: moe_capacity(cf, S, K, E)
    paged_rows = [(bucket_of(len(p)), cap(bucket_of(len(p)))) for p in prompts]
    dense_rows = (len(prompts[0]), cap(len(prompts[0])))
    rows = sorted({r for _, r in paged_rows + [dense_rows]} | {SLOTS * cap(1), cap(1)})
    products = check_expert_products(torch, dev, cfg, model, [r for r in rows if r <= MAX_ROWS])
    launches, steps, engine, _ = serve_paged(torch, dev, cfg, model, prompts, "MoE engine",
                                             rounds=1, new_tokens=MOE_NEW_TOKENS)
    check_launches("MoE engine", launches, {
        "flash_attention": L * SLOTS,
        "paged_decode_attention_int8": L * steps,
        "int8_matmul": moe_launches(cfg, paged_rows, steps, (SLOTS, SLOTS * cap(1))),
    })
    if profile:
        phase_profile(torch, engine, prompts, "MoE engine")
    del engine
    torch.cuda.empty_cache()
    dense = Engine(cfg, model, batch_size=1, max_len=MAX_LEN, device=model.device)
    torch.cuda.synchronize()
    reset_counts()
    res = dense.generate(prompts[0][None], MOE_NEW_TOKENS)
    counted = read_counts()
    check(res.tokens.shape == (1, MOE_NEW_TOKENS) and ((res.tokens >= 0) & (res.tokens < V)).all(),
          f"MoE dense engine: tokens {res.tokens.shape}")
    print(f"MoE dense engine: one {len(prompts[0])}-token prompt, {MOE_NEW_TOKENS} tokens: TTFT "
          f"{res.ttft_s * 1e3:.1f} ms, decode {res.decode_tokens_per_s:.1f} tok/s")
    check_launches("MoE dense engine", counted, {
        "flash_attention": L,
        "int8_decode_attention": L * res.decode_steps,
        "int8_matmul": moe_launches(cfg, [dense_rows], res.decode_steps, (1, cap(1))),
    })
    for name, n in counted.items():
        launches[name] += n
    print(f"MoE engines: path wall time {time.perf_counter() - t0:.1f} s")
    return launches, products


def phase_profile(torch, engine, prompts, what: str, steps: int = 16,
                  speculative: bool = False) -> None:
    """Device time by kernel family over `steps` steady decode steps of an
    8-slot paged engine (torch.profiler, CUDA activity), or with
    `speculative` over `steps` verify passes (step_speculative), and the
    device's busy share of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    budget = steps * (GAMMA + 1) + 8 if speculative else steps + 8  # never exhausted in the window
    for p in prompts:
        check(engine.submit(p, budget) is not None, "profile: admission refused")
    engine.step_n(4)  # settle the in-flight ring
    engine._pipeline.flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = 0
        while done < steps:
            if speculative:
                check(engine.step_speculative(GAMMA, NGRAM), "profile: verify pass refused")
                done += 1
            else:
                done += engine.step_n(min(8, steps - done))
        engine._pipeline.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.run_until_drained()
    families = {"paged_decode": 0.0, "flash": 0.0, "products (int8_matmul)": 0.0,
                "products (cuBLAS)": 0.0, "other": 0.0}
    rows, launches = [], 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # CPU ops carry their kernels' time too
            continue
        us = ev.self_device_time_total
        name, low = ev.key, ev.key.lower()
        rows.append((us, ev.count, name))
        launches += ev.count
        if "decode_attention" in low or any(k in low for k in ("decode_split", "decode_combine")):
            families["paged_decode"] += us
        elif "flash_fwd" in low:
            families["flash"] += us
        elif "int8_matmul" in low:
            families["products (int8_matmul)"] += us
        elif any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
            families["products (cuBLAS)"] += us
        else:
            families["other"] += us
    busy = sum(families.values()) / 1e6
    check(busy > 0, "profile: torch.profiler recorded no device time")
    unit = "verify passes" if speculative else "decode steps"
    print(f"profile {what}: {steps} {unit}, 8 slots: wall {wall * 1e3:.2f} ms "
          f"({wall * 1e3 / steps:.2f} ms/step under the profiler), device busy "
          f"{busy * 1e3:.2f} ms = {busy / wall:.1%} of wall (idle {1 - busy / wall:.1%}), "
          f"{launches / steps:.0f} kernels/step")
    for fam, us in families.items():
        print(f"profile {what}: {fam}: {us / 1e3:.3f} ms ({us / 1e3 / steps:.3f} ms/step, "
              f"{us / 1e6 / busy:.1%} of device time)")
    for us, count, name in sorted(rows, reverse=True):  # split and merge passes, or the fused one
        low = name.lower()
        if "decode_attention" in low or "decode_split" in low or "decode_combine" in low:
            print(f"profile {what}: paged decode kernel: {count / steps:.0f} launches/step, "
                  f"{us / 1e3 / steps:.3f} ms/step, {us / count:.2f} us each: {name[:90]}")
    for us, count, name in sorted(rows, reverse=True)[:12]:
        print(f"profile {what}:   {us / 1e3:9.3f} ms  x{count:<6d} {name[:90]}")


def check_compile_ledger(sources, reports) -> dict:
    """The compile ledger holds exactly one `first` record per source the
    build compiled (every source when _build/ was cold, none when warm) and
    no other record. Returns its per-source counts."""
    from lws_tpu_torch.obs import device as devicemod

    snap = devicemod.LEDGER.snapshot()
    execs = snap["executables"]
    check(sorted(execs) == sorted(reports)
          and all(c["first"] == 1 and c["recompiles"] == 0 for c in execs.values())
          and len(snap["records"]) == len(reports),
          f"compile ledger: {execs} for the build of {sorted(reports)}")
    case = (f"cold _build/: {len(reports)} of {len(sources)} sources compiled" if reports
            else "warm _build/: every library found by its hash, nothing compiled")
    print(f"compile ledger: {case}; {len(snap['records'])} first records "
          + ", ".join(f"{r['executable']} {r['seconds']:.2f} s" for r in snap["records"]))
    return execs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only (no engine, no result line)")
    ap.add_argument("--profile", action="store_true",
                    help="profile steady decode steps of both paged engines and the MoE "
                         "engine, and steady verify passes (torch.profiler)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from lws_tpu_torch.models.flagship import flagship_config
        from lws_tpu_torch.ops import _ext
    except ImportError as e:
        print(f"chip_smoke: the lws_tpu_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _ext.CSRC_DIR.glob("*.cu"))
    reports = _ext.build(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"build[{name}]: {line.strip()}")
    ledger = check_compile_ledger(sources, reports)

    cfg = flagship_config("full")
    kernels = {
        "flash_attention": {
            "route": "cuda", "source": "lws_tpu_torch/csrc/flash_attention.cu",
            "replaces": "lws_tpu/ops/attention.py:84", **phase_flash(torch, dev, cfg)},
        "paged_decode_attention": {
            "route": "cuda", "source": "lws_tpu_torch/csrc/paged_attention.cu",
            "replaces": "lws_tpu/ops/paged_attention.py:102",
            **phase_paged(torch, dev, cfg, quant=False)},
        "paged_decode_attention_int8": {
            "route": "cuda", "source": "lws_tpu_torch/csrc/paged_attention.cu",
            "replaces": "lws_tpu/ops/paged_attention.py:102 (quant=True)",
            **phase_paged(torch, dev, cfg, quant=True)},
        "int8_matmul": {
            "route": "cuda", "source": "lws_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "lws_tpu/ops/int8_matmul.py:53", **phase_int8_matmul(torch, dev, cfg)},
        "int8_decode_attention": {
            "route": "cuda", "source": "lws_tpu_torch/csrc/int8_attention.cu",
            "replaces": "lws_tpu/ops/int8_attention.py:38", **phase_int8_decode(torch, dev, cfg)},
    }
    torch.cuda.empty_cache()
    if args.kernels:
        print(json.dumps({"kernels": kernels}))
        return 0
    by_path = {}
    watch = TelemetryWatch()  # tracing on, spies on the engines' entry points
    watch.begin()
    by_path["bf16 paged engine"], engine, prompts = path_bf16_paged(torch, dev, cfg)
    watch.end("bf16 paged engine")
    check_pools(torch, engine, "bf16 paged engine")
    telemetry_cost(torch, engine, prompts)
    if args.profile:
        phase_profile(torch, engine, prompts, "bf16 engine")
    del engine  # the bf16 weights and pool go before the int8 model is built
    torch.cuda.empty_cache()
    cfg8 = flagship_config("full", kv_quant=True)
    watch.begin()
    by_path["int8 paged engine"], engine, paged_streams = path_int8_paged(torch, dev, cfg8, prompts)
    watch.end("int8 paged engine")
    check_pools(torch, engine, "int8 paged engine")
    if args.profile:
        phase_profile(torch, engine, prompts, "int8 engine")
    model8 = engine.params
    del engine  # its pool goes before the next engine's is built
    torch.cuda.empty_cache()
    watch.begin()
    by_path["int8 prefix/chunked/speculative engine"] = path_int8_prefix_spec(
        torch, dev, cfg8, model8, profile=args.profile)
    watch.end("int8 prefix/chunked/speculative engine")
    torch.cuda.empty_cache()
    watch.begin()
    by_path["int8 dense engine"] = path_int8_dense(torch, dev, cfg8, model8)
    watch.end("int8 dense engine")
    torch.cuda.empty_cache()
    watch.begin()
    by_path["int8 batch engine"], batch_engine = path_int8_batch(torch, dev, cfg8, model8, prompts,
                                                                 paged_streams)
    watch.end("int8 batch engine")
    watch.begin()
    by_path["int8 dense chunked/streamed/speculative"] = path_int8_dense_modes(
        torch, dev, cfg8, model8, batch_engine)
    watch.end("int8 dense chunked/streamed/speculative")
    del batch_engine
    torch.cuda.empty_cache()
    watch.begin()
    by_path["disagg handoff"] = path_disagg(torch, dev, model8)
    watch.end("disagg handoff")
    torch.cuda.empty_cache()
    watch.begin()
    by_path["load runner"] = path_loadgen(torch, dev, cfg8, model8, watch.recorder)
    watch.end("load runner")
    del model8  # the flagship goes before the MoE model is built
    torch.cuda.empty_cache()
    watch.begin()
    by_path["int8 MoE engines"], kernels["int8_matmul"]["moe_expert_rows"] = path_int8_moe(
        torch, dev, profile=args.profile)
    watch.end("int8 MoE engines")
    check(ledger == check_compile_ledger(sources, reports),
          "compile ledger: a kernel compiled on an engine path")
    rows = []
    for name, rec in kernels.items():
        per_path = {path: counts[name] for path, counts in by_path.items() if counts[name]}
        check(per_path, f"{name}: no main path launched it")
        rows.append({"name": name, "launches": sum(per_path.values()),
                     "launches_by_path": per_path, **rec})
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
