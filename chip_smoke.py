#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lws_tpu_torch) on one GPU and hold its
kernels to their plain PyTorch versions.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # build + kernel checks only (no engine)
    python3 chip_smoke.py --profile    # every phase, and a torch.profiler breakdown
                                       # of steady decode steps of both paged engines
                                       # and the MoE engine, and of steady verify passes,
                                       # and NCCL's share of a tensor-parallel step
    python3 chip_smoke.py --tp-only --tp 4   # path 14 alone on 4 cards, against
                                       # single-card references it computes first
    python3 chip_smoke.py --disagg-only --tp 2  # path 16 alone: each role on 2 of 4
                                       # cards, against one-card handoffs of its own
    python3 chip_smoke.py --deploy-only  # path 17 alone: the port's control plane
                                       # deploys the full-width pair, against
                                       # one-card handoffs of its own
    python3 chip_smoke.py --train-only # path 15 alone on one card
    python3 chip_smoke.py --train-only --mesh 2,1,1,2 --mesh 1,2,1,2:4 ...
                                       # path 15's config on several cards, one
                                       # layout per --mesh DP,PP,CP,TP[:GPipe M]

Phases (each raises on failure; the script then exits non-zero and prints
no result line): 1-4 build and hold the kernels, 5-14, 16 and 17 drive the
engine paths, 15 trains.
  1. the card (nvidia-smi name and power limit, CUDA version) and the build of
     every CUDA source in lws_tpu_torch/csrc/ for sm_90a, one nvcc per source,
     started together; the compile ledger (lws_tpu_torch/obs/device.py) must
     then hold exactly one `first` record per source that build compiled
     (all four when _build/ was cold, none when warm);
  2. the flash prefill kernel against reference_attention at the flagship's
     attention shapes (H=32, Hkv=8, D=128, bf16, causal): B=1 at several S
     (the paged engines' prefills, and S = 127, 129, 257 for ragged 128-row
     q tiles) and B=8, S=512 (the dense engine's), and at a rank's share of
     a tp = 2 prefill role (H=16, Hkv=4; S = 24, 100, 1000), with
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
     take; at the tp = 2 splits of the five products (the lm_head's V/2
     shard ending in a ragged tile) at 1, 24 and 100 rows, path 16's
     shapes on two cards; the int8 dense-cache decode kernel against its plain
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
     streams equal the HBM-tier hit's. Then the wire's
     serving_kv_transfer_bytes_total{role} on both roles and the handoff
     counters equal the bytes the handoffs moved; each handoff's shipped
     spans are there and add up to its record within 5 %; and one chaos
     drill, kv.stream.send_chunk=partial_write:64:1, tears the 1,000-token
     stream, which re-queues and replays the fault-free rows byte for byte
     and decodes the same tokens;
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
     128), after the path's launch counts are read; then the loadgen
     command as a process, `python -m lws_tpu_torch loadgen shared_prefix
     --seed 0 --target paged --json` with no --device: on the card, its
     header naming the schedule's digest, every request completed, every
     class in its report, the kernel launches its process prints to
     stderr exact (flash per layer per prefix miss, paged decode per layer
     per decode step, nothing else), TTFT p50/p99 and goodput per class
     printed;
 14. (run after 13, before 11) the tensor-parallel group: one rank per
     visible card (--tp N: N of them), rank 0 in this process and the
     others spawned, each started by lws_tpu_torch.parallel from the env
     contract the control plane gives a group member, with NCCL (on one
     card: a one-rank group, tp = 1, whose collectives still run); the
     group forms one tp mesh and serves, at flagship_config("full") width
     and depth, the 8 paged prompts (64 new tokens, one round) through
     the TP PagedBatchEngine in bf16 and in int8 (weights and KV), and
     path 8's batch through the int8 TP dense Engine. Every rank's streams
     must be identical; rank 0's must equal paths 5, 6 and 8's single-card
     streams or fork only at a near-tie (check_greedy_chain on the
     single-card model); every rank's launch counts must equal those
     paths' formulas for its own steps; each rank's parameter and pool
     bytes must be 1/tp of the sharded tensors plus the replicated ones;
     no rank but 0 compiles a kernel. It prints tp, TTFT and tok/s per
     rank and engine, and the host and device time of one all-reduce of a
     decode step's [8, 4096] activation and of the lm_head's all-gather
     (--profile: NCCL's share of 16 TP decode steps).
 16. (run after 14, before 11) the tensor-parallel disaggregated pair: the
     workers' int8-weight, bf16-K/V flagship, each role a real OS process
     (`python -m lws_tpu_torch.serving.disagg_worker prefill|decode` with
     LWS_TPU_MODEL=flagship and LWS_TPU_TP; on one card a one-rank mesh
     each, both on card 0; --disagg-only --tp 2 on four cards: prefill on
     cards 0-1, decode on 2-3), paired over loopback TCP through a stand-in
     of the API server's records. The 1,000-token prompt streamed in chunks
     of 256, the 100-token prompt, 8 requests of the JAX package's
     shared_prefix scenario (seed 0) open-loop through loadgen.DisaggTarget;
     then the prefill role restarted with LWS_TPU_KV_CHUNK=0 for the
     1,000-token prompt monolithic, then a fault armed live on the decode
     role and two 100-token requests, then the drains. Bundle bytes and
     tokens equal path 12's one-card handoffs (tokens may fork only at an
     argmax near-tie); every load-runner request completes on the client
     and in both roles' logs; the launches each role's rank 0 prints at exit
     equal the handoffs' formulas; both roles exit 0 and no spawned process
     outlives them. Each role serves the worker telemetry server
     (LWS_TPU_METRICS_PORT; the decode role also profiles at
     LWS_TPU_PROFILE_HZ): /healthz answers once the role is ready; a
     scraper thread reads both roles' /metrics once a second while the load
     runner runs (scrape latency and the decode role's tok/s in that window
     are printed, not gated); the prefill role's TTFT count and the decode
     role's ITL count equal the handoffs each handled;
     serving_kv_transfer_bytes_total moves by each 1,000-token bundle's
     bytes on both roles; the device-memory gauges name the card; the
     1,000-token prompt's journeys (/debug/request/<id>), streamed and
     monolithic, are complete on both roles with their spans and, streamed,
     one chunk-timeline entry per chunk; every compile record made during a
     request names it and rides its journey; POST /debug/faults arms
     disagg.decode.process once: that request ends errored and its journey
     is kept so, the next equals its oracle; the decode role's collapsed
     profile is not empty; the prefill role drains through POST
     /debug/drain and the decode role on SIGTERM. It prints TTFT across the
     handoff, gather, wire, deserialize and reshard ms, tok/s per role and
     the path's seconds; on four cards NCCL's share of the decode role's
     steps.
 17. (run after 16, before 11) the deployed pair: `python -m lws_tpu_torch
     serve --config ... -f ...` as a process of its own (the port's
     ControlPlane, LocalBackend and ApiServer; backend local, no scheduler)
     deploys a DisaggregatedSet whose roles are LWSes of size 1 running the
     port's workers at path 16's width (LWS_TPU_MODEL=flagship, prefill
     streaming in chunks of 256), each template declaring its KV and
     telemetry ports. The serve process holds no CUDA context (its open
     device nodes, and nvidia-smi's compute apps); both roles are found only
     through its API server (the `-prv` Services selecting ready pods). The
     100-token prompt; then the decode pod's process is SIGKILLed: the pod
     goes Failed with one container restart (the API server's /watch), the
     group is recreated with a new pod uid, and a 100-token request
     submitted during the outage completes once the new pod is up; then the
     1,000-token prompt (streamed). The fleet plane: the API server's
     /metrics/fleet at a quiet moment carries both roles' pods (instance,
     role and revision labels) and the control plane, each role's transfer
     bytes and request counters equal to its own /metrics; the read
     commands as processes (`top` a row per role, `devices` both workers'
     compile ledgers, `profile --fleet` both instances with the decode role
     sampled, `explain long-s` one connected tree of both workers' legs,
     `monitor`, `rollout`, and `why` on a record the fleet ingest's
     decision step wrote for a pair role); the loadgen command against the
     pair with --server the API server (`python -m lws_tpu_torch loadgen
     shared_prefix --seed 0 --prefill --decode --server --json`; every
     request completes, the prefill role's TTFT count and the decode role's
     ITL count move by exactly that number, serving_kv_transfer_bytes_total
     moves on both roles, the report's history block has a row for every
     (engine, class) the decode role counts, the fleet block a goodput), a
     scraper timing /metrics/fleet once a second under its load; `faults
     --server <the decode worker's telemetry port>` arms a decode failure
     live and the 100-token request after it is redelivered; an Autoscaler
     over a port-free LWS driven by POST /report-metric 1 -> 2 -> 1 (its
     replicas, events and processes checked at each step) and deleted.
     Every request equals path 16's one-card references in bundle bytes and
     tokens (a fork only at an argmax near-tie). `get Pod`, `get
     DisaggregatedSet` and `logs` run as processes and show exactly the DS's
     objects and the new incarnation's output; `delete DisaggregatedSet`
     ends every worker within 60 s; the launches the prefill role and the
     replacement decode role print at exit equal the handoff formulas, the
     loadgen command's requests included; no spawned process outlives the
     path; serve exits 0 on SIGINT. Serve keeps a state directory and
     serves https with token auth; a `--standby` on the same directory
     takes over when the active serve is SIGKILLed, with every object and
     both live workers. An Informer (lws_tpu_torch.client) on the LWSs, the
     DS and the pods, started before the deploy settles, equals the store
     at a quiet moment, after a server-side apply through RemoteClient and
     after the takeover; the streamed request's span tree (the DS's
     reconcile, the client's span, both workers' subtrees) survives
     Tracer.record, export_jsonl and read_jsonl connected; serve and the
     standby print `store clone: native (...)`, the store's clone built
     from csrc/fastclone.c. It prints deploy-to-ready, kill-to-result,
     kill-to-takeover, the Informer's convergence, /metrics/fleet's scrape
     latency and the path's seconds.
 15. (last) training at benchmarks/train_bench.py's on-accelerator config
     (vocab 32000, d_model 1536, 12 layers, 12 heads, 6 KV heads, d_ff 4096,
     remat; f32 parameters, bf16 compute; AdamW at lr 3e-4; a fixed batch of
     4 x 1024): bf16 against f32 compute, remat on against off, 8 steps
     (initial loss near ln V + 1/2, learning, finite), a checkpoint saved after
     step 2 and restored (bit for bit, the same step-3 loss), a one-rank
     NCCL mesh against mesh=None, GPipe at pp = 1 and the ring at cp = 1
     against the plain forward; it prints ms per step, tokens/s, MFU, peak
     memory and remat's cost, and must launch none of the kernels (JAX
     trains on XLA attention). --train-only --mesh runs the same config on
     several cards (one rank per card, NCCL), each layout's ranks agreeing
     and its step-0 loss near the single card's, with ms per step, tokens/s
     per card, NCCL's share of a step and its kernels by kind, and each
     rank's block-input sequence length; at tp > 1 the training forward
     must hold the sequence share over tp (sequence parallelism): blocks fed
     [B, ceil(S / (cp tp)), D], reduce-scatters run and no all-reduce over
     tp in the forward.
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
from typing import Optional

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
# Path 14: the group's rendezvous and collective timeout.
TP_TIMEOUT_S = 120.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_kernels(prof) -> list:
    """A torch.profiler run's key_averages() rows of device kernels: CUDA
    events but the GPU user annotations (ProcessGroupNCCL brackets each
    collective with one, `nccl:<op>`, which repeats its kernel's time and
    count; torch's own table leaves them out of device totals too)."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]


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

    D = cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(1)
    record, worst = None, 0.0
    # (B, S, tp): the paged engines' one-request prefills at their buckets
    # and edges, and the dense engine's batched prefill (8 prompts of 512).
    # S = 127, 129 and 257 put a ragged q tile on each side of the kernel's
    # 128-row tile edges. tp = 2: a rank's share of path 16's tensor-parallel
    # prefill role on two cards (H/2 query and Hkv/2 KV heads) at its
    # prompts: the short one, the load runner's and the 1,000-token one.
    for B, S, tp in ((1, 16, 1), (1, 127, 1), (1, 128, 1), (1, 129, 1), (1, 257, 1),
                     (1, 1000, 1), (1, 1024, 1), (1, 2048, 1), (SLOTS, 512, 1),
                     (1, 24, 2), (1, 100, 2), (1, 1000, 2)):
        H, Hkv = cfg.n_heads // tp, cfg.n_kv_heads // tp
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
              f"flash B={B} S={S} H={H}: max abs err {err} beyond atol=rtol={FLASH_TOL}")
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
        print(f"flash B={B} S={S:5d} H={H} Hkv={Hkv}: max_abs_err={err:.3e} kernel={ms:.4f} ms "
              f"plain={plain_ms:.4f} ms sdpa={library_ms:.4f} ms bound={bound_ms:.4f} ms "
              f"({bound_by}) roofline={bound_ms / ms:.1%}")
        if (B, S, tp) == (1, 1024, 1):  # the bucket of the longest paged prompt on the main path
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
    worst = max(worst, int8_matmul_shards(torch, dev, cfg, g, flush))
    record["max_abs_err"] = worst  # relative to max |plain| (outputs reach ~1e2)
    return record


def int8_matmul_shards(torch, dev, cfg, g, flush, tp: int = 2) -> float:
    """int8_matmul against its plain version at a rank's share of path 16's
    tensor-parallel roles on two cards: the tp = 2 splits of the five
    flagship products (wq, wk/wv, w_gate/w_up and the lm_head split by
    output column, its shard of V/2 = 64,128 columns ending in a ragged
    tile; wo and w_down by input row), at the rows the roles give them (a
    decode step's 1, the load runner's and the short prompt's prefills).
    Returns the largest error relative to max |plain|."""
    import torch.nn.functional as F

    from lws_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference

    d, kv, f, V = cfg.d_model, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff, cfg.vocab_size
    worst = 0.0
    for D, Fo in ((d, d // tp), (d, kv // tp), (d, f // tp), (d, V // tp), (d // tp, d),
                  (f // tp, d)):
        q = torch.randint(-127, 128, (Fo, D), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(Fo, generator=g, device=dev) * D**-0.5 / 73.3
        w_bf16 = q.to(torch.bfloat16)
        for m in (1, 24, 100):
            x = torch.randn(m, D, generator=g, device=dev, dtype=torch.bfloat16)
            out = int8_matmul(x, q, scale)
            ref = int8_matmul_reference(x, q, scale)
            torch.cuda.synchronize()
            mag = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            worst = max(worst, err / mag)
            check(bool(torch.isfinite(out).all()) and torch.allclose(
                out.float(), ref.float(), atol=MATMUL_TOL * mag, rtol=MATMUL_TOL),
                f"int8_matmul tp={tp} shard m={m} ({D},{Fo}): max abs err {err} "
                f"(max |plain| {mag})")
            ms = time_cuda(torch, lambda: int8_matmul(x, q, scale), flush=flush)
            bf16_ms = time_cuda(torch, lambda: F.linear(x, w_bf16), flush=flush)
            bound_ms, bound_by = bound(2 * m * D * Fo, m * D * 2 + Fo * D + Fo * 4 + m * Fo * 2)
            print(f"int8_matmul tp={tp} shard m={m:3d} (D,F)=({D},{Fo}): rel err "
                  f"{err / mag:.2e} kernel={ms:.4f} ms bf16 F.linear={bf16_ms:.4f} ms "
                  f"bound={bound_ms:.4f} ms ({bound_by}) roofline={bound_ms / ms:.1%}")
        del q, w_bf16
    return worst


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
    from lws_tpu_torch.ops import launch_counts

    return launch_counts()


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
    command_local_target(loadgen, spec, schedule)
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


def run_loadgen_command(args: list, timeout: float, global_args: tuple = (),
                        env_extra: Optional[dict] = None) -> tuple:
    """`python -m lws_tpu_torch [GLOBAL_ARGS] loadgen ARGS --json` as a
    process from the repo root (`env_extra` added to its environment).
    Returns (its `#` header line, the report it prints after it, its wall
    seconds, its stderr); a non-zero exit fails the phase."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **(env_extra or {}))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lws_tpu_torch", *global_args, "loadgen", *args,
                           "--json"],
                          cwd=repo, env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"loadgen command {args} exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    header, _, body = proc.stdout.partition("\n")
    check(header.startswith("# "), f"loadgen command {args}: header {header!r}")
    return header, json.loads(body), wall, proc.stderr


def command_local_target(loadgen, spec, schedule) -> None:
    """The loadgen command on the card: `python -m lws_tpu_torch loadgen
    shared_prefix --seed 0 --target paged` with no --device builds
    build_local_target's paged engine on the card (bf16, d_model 256, head
    dim 128, blocks of 16: the CPU-sized scenario's twin, not the
    flagship) and serves the whole schedule. Its header names path 13's
    schedule digest; every request completes; every class of the
    scenario is in the report; the launches the process prints for its
    engine are exact: flash per layer per admission that missed the
    prefix cache (every prompt is 20-28 tokens: at most one shareable
    block of 16, so a hit is one suffix admission), the bf16 paged decode
    kernel per layer per decode step, no int8 kernel."""
    header, report, wall, err = run_loadgen_command(
        [LOADGEN_SCENARIO, "--seed", str(LOADGEN_SEED), "--target", "paged", "--max-wall",
         str(LOADGEN_MAX_WALL_S)], timeout=300.0)
    digest, n = loadgen.schedule_digest(schedule), len(schedule)
    check(header.endswith(f"(seed {LOADGEN_SEED}, schedule {digest[:12]})"),
          f"loadgen command: header {header!r}, path 13's digest {digest}")
    done = report["all"]["completed"]
    check(report["all"]["count"] == n and done == n,
          f"loadgen command: {done} of {report['all']['count']} requests completed, schedule {n}")
    check(set(report["classes"]) == set(loadgen.class_targets(spec)),
          f"loadgen command: classes {sorted(report['classes'])}")
    line = [ln for ln in err.splitlines() if ln.startswith("# paged engine ")]
    check(len(line) == 1, f"loadgen command: no launch line on stderr:\n{err[-2000:]}")
    head, _, counts = line[0].partition("; kernel launches ")
    eng = json.loads(head[len("# paged engine "):])
    L, steps, hits = eng["n_layers"], eng["decode_steps"], eng["hit_blocks"]
    check(eng["attention_path"] == "kernel" and steps > 0,
          f"loadgen command: engine {eng}")
    check_launches("loadgen command", json.loads(counts), {
        "flash_attention": L * (n - hits),
        "paged_decode_attention": L * steps,
    })
    print(f"loadgen command (python -m lws_tpu_torch loadgen {LOADGEN_SCENARIO} --seed "
          f"{LOADGEN_SEED} --target paged, no --device) on the card: schedule {digest[:12]}, "
          f"{done} of {n} requests completed, {hits} prefix hits, {steps} decode steps, "
          f"process wall {wall:.1f} s")
    for klass, c in sorted(report["classes"].items()):
        print(f"loadgen command: class {klass} on build_local_target's paged engine (bf16, "
              f"d_model 256; the scenario's CPU-sized targets, TTFT 5 s, ITL 1 s): TTFT p50 "
              f"{c['ttft_p50'] * 1e3:.1f} ms, p99 {c['ttft_p99'] * 1e3:.1f} ms; goodput "
              f"{c['good_tokens']}/{c['tokens']} tokens = {c['goodput_fraction']:.1%}")


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
    launches, steps, engine, streams = serve_paged(torch, dev, cfg, model, prompts, "bf16 engine")
    L, admissions = cfg.n_layers, ROUNDS * SLOTS
    check_launches("bf16 engine", launches, {"flash_attention": L * admissions,
                                             "paged_decode_attention": L * steps})
    return launches, engine, prompts, streams


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
    # Each admission's route logits (the first return of _prefill_suffix, or
    # _chunk_logits's) and the pool blocks _scatter_dense writes.
    wrapped = ("_prefill_suffix", "_chunk_logits", "_scatter_dense")
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
            logits = [(out[0], a) for out, a in captured.get("_prefill_suffix", [])] \
                + captured.get("_chunk_logits", [])
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


def dense_batch(cfg) -> tuple:
    """Path 8's batch: the warm-up prompts (SLOTS x 32) and the SLOTS
    512-token prompts, from one seeded generator."""
    rng = np.random.default_rng(3)
    warm = rng.integers(1, cfg.vocab_size, (SLOTS, 32)).astype(np.int32)
    return warm, rng.integers(1, cfg.vocab_size, (SLOTS, 512)).astype(np.int32)


def path_int8_dense(torch, dev, cfg, model) -> tuple:
    from lws_tpu_torch.models.llama import KVCache, forward_prefill, forward_with_cache
    from lws_tpu_torch.serving.engine import Engine

    V, L, plen = cfg.vocab_size, cfg.n_layers, 512
    engine = Engine(cfg, model, batch_size=SLOTS, max_len=MAX_LEN)
    warm, prompt = dense_batch(cfg)
    engine.generate(warm, 4)  # warm-up
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
    return launches, res.tokens.tolist()


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


def wait_until(predicate, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.01)
    return predicate()


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
            rec["toks"], rec["stats"], rec["dspans"] = dw._decode_bundle(
                dec, payload, HANDOFF_STEPS, gamma=gamma, ngram=NGRAM)
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
        rec["landed"] = rows_digest(kt, bufs, S)
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
        rec["landed"] = rows_digest(kt, {n: getattr(landed["cache"], n) for n in ("k", "v")}, S)
    rec["wire_bytes"] = meta["payload_bytes"] if streamed else stats["bundle_bytes"]
    return rec


def rows_digest(kt, bufs: dict, rows: int) -> str:
    """sha256 of the K and V rows [0, rows) that landed on the decode side."""
    import hashlib

    h = hashlib.sha256()
    for name in ("k", "v"):
        h.update(kt.host_array(bufs[name][:, :, :rows]).tobytes())
    return h.hexdigest()


def check_handoff_telemetry(rec, rid: str) -> None:
    """The shipped spans of one handoff (prefill's in the bundle meta,
    decode's from _decode_bundle) are there, and the handoff record's times
    are theirs: each within the record's 0.1 ms rounding, and their sum
    within 5 % of the record's."""
    spans = {sp["name"]: sp for sp in rec["meta"].get("spans", []) + rec["dspans"]}
    want = {"serve.request", "serve.prefill", "kv.gather", "kv.deserialize", "kv.reshard",
            "serve.decode_dispatch"}
    check(want <= set(spans), f"handoff {rid}: spans {sorted(spans)}, want {sorted(want)}")
    h = {**rec["meta"]["handoff"], **rec["stats"]}
    pairs = [("prefill_s", "serve.prefill"), ("deserialize_s", "kv.deserialize"),
             ("reshard_s", "kv.reshard"), ("decode_s", "serve.decode_dispatch")]
    if not rec["streamed"]:  # a stream's kv.gather span covers its whole window
        pairs.append(("gather_s", "kv.gather"))
    for key, name in pairs:
        check(abs(h[key] - spans[name]["duration_s"]) <= 6e-5,
              f"handoff {rid}: {key} {h[key]} vs span {name} {spans[name]['duration_s']}")
    got, want_s = (sum(spans[n]["duration_s"] for _, n in pairs), sum(h[k] for k, _ in pairs))
    check(abs(got - want_s) <= 0.05 * want_s,
          f"handoff {rid}: spans add up to {got:.4f} s, the record to {want_s:.4f} s")


def chaos_drill(torch, pre, dec, server, rec) -> dict:
    """One chaos drill on the card: `kv.stream.send_chunk=partial_write:64:1`
    tears the first delivery of `rec`'s prompt as a stream, the server
    re-queues it whole, and the replay lands the fault-free handoff's rows
    byte for byte and decodes its tokens. Returns the replay's record."""
    from lws_tpu_torch.core import faults, flightrecorder
    from lws_tpu_torch.serving import disagg_worker as dw
    from lws_tpu_torch.serving import kv_transport as kt

    prompt, ep = rec["prompt"], ("127.0.0.1", server.port)
    factory = lambda m: kt.CacheAssembler(max_len=dec.max_len, device=dec.device)  # noqa: E731
    out = {}
    flightrecorder.RECORDER.clear()
    faults.INJECTOR.arm("kv.stream.send_chunk", "partial_write:64:1")
    try:
        prefill = run_in_thread(lambda: dw._prefill_streamed(pre, server, {"id": "chaos"},
                                                             "chaos", prompt, CHUNK, None))
        try:
            kt.pull_bundle(ep, timeout=120.0, ack_timeout=600.0, receiver_factory=factory)
            torn = False
        except OSError:
            torn = True

        def process(meta, payload):
            out["toks"], out["stats"], _ = dw._decode_bundle(dec, payload, HANDOFF_STEPS)
            out["landed"] = rows_digest(kt, payload._bufs, len(prompt))
            out["meta"] = meta
            return True

        got = kt.pull_bundle(ep, timeout=120.0, process=process, ack_timeout=600.0,
                             receiver_factory=factory)
        prefill()
        trips = faults.INJECTOR.snapshot()["trips"]
    finally:
        faults.INJECTOR.disarm()
    torn_events = [e for e in flightrecorder.RECORDER.events()
                   if e["kind"] == "kv_stream_torn" and e.get("request_id") == "chaos"]
    check(torn and got is True and trips == {"kv.stream.send_chunk": 1} and torn_events,
          f"chaos drill: torn {torn}, replayed {got}, trips {trips}, "
          f"{len(torn_events)} kv_stream_torn events")
    check(out["landed"] == rec["landed"], "chaos drill: the replayed rows differ from the "
                                          "fault-free handoff's")
    check(np.array_equal(out["toks"], rec["toks"]),
          "chaos drill: the replay's tokens differ from the fault-free handoff's")
    print(f"disagg handoff chaos drill: kv.stream.send_chunk=partial_write:64:1 tore the "
          f"{len(prompt)}-token stream's first delivery; it re-queued whole and the replay "
          f"({out['meta']['chunks']} chunks) landed the fault-free rows byte for byte and "
          f"decoded its tokens")
    return out


def path_disagg(torch, dev, model8) -> tuple:
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
    hit's. Returns the launches and path 16's references (the 100- and
    1,000-token handoffs by (prompt length, chunk))."""
    from lws_tpu_torch.core import metrics
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
    reg = metrics.REGISTRY
    wire0 = {role: reg.counter_value("serving_kv_transfer_bytes_total", {"role": role})
             for role in ("prefill", "decode")}
    handoffs0 = (reg.counter_value("serving_kv_handoffs_total"),
                 reg.counter_value("serving_kv_handoff_bytes_total"))
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
        # The wire's counters, by role, equal the bytes the handoffs moved;
        # each handoff's spans add up to its record.
        moved = sum(r["wire_bytes"] for r in recs + [spec])
        for role in ("prefill", "decode"):  # the server counts its send after the client's read
            wait_until(lambda: reg.counter_value("serving_kv_transfer_bytes_total",
                                                 {"role": role}) - wire0[role] == moved)
            got = reg.counter_value("serving_kv_transfer_bytes_total", {"role": role}) - wire0[role]
            check(got == moved, f"disagg handoff: serving_kv_transfer_bytes_total{{role={role}}} "
                                f"rose by {got}, the handoffs moved {moved} B")
        n_handoffs = reg.counter_value("serving_kv_handoffs_total") - handoffs0[0]
        n_bytes = reg.counter_value("serving_kv_handoff_bytes_total") - handoffs0[1]
        check(n_handoffs == len(recs) + 1 and n_bytes == moved,
              f"disagg handoff: {n_handoffs} handoffs / {n_bytes} B counted, "
              f"{len(recs) + 1} / {moved} made")
        for r in recs + [spec]:
            check_handoff_telemetry(r, f"{'s' if r['streamed'] else 'm'}{len(r['prompt'])}")
        print(f"disagg handoff: the wire counted {moved} B on each role over {len(recs) + 1} "
              f"handoffs, as moved; every handoff's spans add up to its record")
        chaos_drill(torch, pre, dec, server,
                    next(r for r in recs if r["streamed"] and len(r["prompt"]) == 1000))
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
    # The chaos drill: one streamed prefill (replayed from its buffer) and one decode.
    want["int8_matmul"] += 7 * L * -(-1000 // CHUNK) + 1 + (7 * L + 1) * HANDOFF_STEPS
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
    # Path 16's references: the one-card handoffs of its prompts.
    refs = {(len(r["prompt"]), r["chunk"]): r for r in recs if len(r["prompt"]) in (100, 1000)}
    return launches, refs


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
    for ev in device_kernels(prof):  # CPU ops carry their kernels' time too
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


# ---------------------------------------------------------------------------
# Path 14: the tensor-parallel group


def tp_shard_bytes(cfg, quantized: bool, tp: int) -> int:
    """A rank's parameter bytes under tp: 1/tp of every sharded tensor
    (models/llama.py:shard_dim) plus the replicated ones (norms, router),
    from the shapes of a full model on device="meta"."""
    import itertools

    from lws_tpu_torch.models.llama import Llama, shard_dim

    full = Llama(cfg, "meta", quantized)
    total = 0
    for name, t in itertools.chain(full.named_parameters(), full.named_buffers()):
        n = t.numel() * t.element_size()
        total += n // tp if shard_dim(name, cfg.n_experts) is not None else n
    return total


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size()
               for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)


def tp_serve_paged(torch, cfg, model, mesh, prompts, what: str) -> tuple:
    """The TP PagedBatchEngine(slots=8, max_len=2048, block_size=16) serves
    the 8 paged prompts once (NEW_TOKENS each) after a warm-up request,
    with the launch counts reset just before and read just after. Returns
    (the rank's record, the engine)."""
    from lws_tpu_torch.models.llama import init_paged_cache
    from lws_tpu_torch.models.quant import quantized_bytes
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    dev = model.device
    engine = PagedBatchEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
                              mesh=mesh, device=dev)
    warm = engine.submit(np.random.default_rng(1).integers(1, cfg.vocab_size, 64).astype(np.int32), 8)
    engine.run_until_drained()
    check(engine.result(warm) is not None, f"{what}: warm-up request did not finish")
    torch.cuda.synchronize()
    steps0 = engine.stats["decode_steps"]
    reset_counts()
    ttft, ids = [], []
    for p in prompts:
        t0 = time.perf_counter()
        ids.append(engine.submit(p, NEW_TOKENS))
        ttft.append(time.perf_counter() - t0)
        check(ids[-1] is not None, f"{what}: engine refused a request")
    t0 = time.perf_counter()
    engine.run_until_drained()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_counts()
    full_pool = init_paged_cache(cfg, engine.num_blocks, BLOCK, "meta")
    return {"streams": [engine.result(i) for i in ids], "launches": launches,
            "steps": engine.stats["decode_steps"] - steps0,
            "ttft_ms": statistics.median(ttft) * 1e3,
            "tok_s": SLOTS * (NEW_TOKENS - 1) / decode_s,
            "param_bytes": quantized_bytes(engine.params),
            "want_param_bytes": tp_shard_bytes(cfg, model.quantized, mesh.tp),
            "pool_bytes": cache_bytes(engine.cache),
            "want_pool_bytes": cache_bytes(full_pool) // mesh.tp}, engine


def tp_serve_dense(torch, cfg, model, mesh, prompt) -> dict:
    """The TP dense Engine(batch_size=8) on the int8 model: a warm-up, then
    one batch of the 8 512-token prompts of path 8, NEW_TOKENS each."""
    from lws_tpu_torch.models.llama import init_cache
    from lws_tpu_torch.models.quant import quantized_bytes
    from lws_tpu_torch.serving.engine import Engine

    engine = Engine(cfg, model, batch_size=SLOTS, max_len=MAX_LEN, mesh=mesh, device=model.device)
    engine.generate(dense_batch(cfg)[0], 4)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    res = engine.generate(prompt, NEW_TOKENS)
    launches = read_counts()
    return {"tokens": res.tokens.tolist(), "launches": launches, "steps": res.decode_steps,
            "ttft_ms": res.ttft_s * 1e3, "tok_s": res.decode_tokens_per_s,
            "param_bytes": quantized_bytes(engine.params),
            "want_param_bytes": tp_shard_bytes(cfg, model.quantized, mesh.tp),
            "pool_bytes": cache_bytes(engine.new_cache()),
            "want_pool_bytes": cache_bytes(init_cache(cfg, SLOTS, MAX_LEN, "meta")) // mesh.tp}


def tp_profile(torch, engine, prompts, record: bool, steps: int = 16) -> Optional[dict]:
    """Every rank runs `steps` steady decode steps of the 8-slot TP engine
    in lockstep; `record` (rank 0) profiles them: the device time of the
    NCCL kernels against all device time and against the window's wall."""
    from torch.profiler import ProfilerActivity, profile

    import contextlib

    for p in prompts:
        check(engine.submit(p, steps + 8) is not None, "tp profile: admission refused")
    engine.step_n(4)
    engine._pipeline.flush()
    torch.cuda.synchronize()
    ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if record \
        else contextlib.nullcontext()
    with ctx as prof:
        t0 = time.perf_counter()
        done = 0
        while done < steps:
            done += engine.step_n(min(8, steps - done))
        engine._pipeline.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.run_until_drained()
    if not record:
        return None
    nccl = busy = 0.0
    launches = nccl_launches = 0
    for ev in device_kernels(prof):
        busy += ev.self_device_time_total
        launches += ev.count
        if "nccl" in ev.key.lower():
            nccl += ev.self_device_time_total
            nccl_launches += ev.count
    check(busy > 0, "tp profile: torch.profiler recorded no device time")
    return {"steps": steps, "wall_ms": wall * 1e3, "busy_ms": busy / 1e3, "nccl_ms": nccl / 1e3,
            "kernels_per_step": launches / steps, "nccl_per_step": nccl_launches / steps}


def collective_cost(torch, mesh, dev, V: int, D: int, n: int = 200) -> dict:
    """Host and device time of the TP step's collectives at a decode step's
    shapes, every rank in lockstep: the all-reduce (collectives.psum) of an
    [8, D] bf16 activation and the lm_head's all-gather (collectives.
    all_gather) of [8, V/tp], n calls each, under no_grad as the engines
    call them."""
    from lws_tpu_torch.parallel.collectives import all_gather, psum

    out = {}
    for name, x, fn in (("all_reduce", torch.zeros(SLOTS, D, dtype=torch.bfloat16, device=dev),
                         psum),
                        ("all_gather", torch.zeros(SLOTS, V // mesh.tp, dtype=torch.bfloat16,
                                                   device=dev), all_gather)):
        with torch.no_grad():  # as the engines serve: no autograd node
            for _ in range(10):
                fn(x, mesh.tp_group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn(x, mesh.tp_group)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = {"host_us": (t1 - t0) / n * 1e6,
                     "device_us": (time.perf_counter() - t0) / n * 1e6}
    return out


def tp_rank_run(torch, rank: int, env: dict, prompts, dense_prompt, models: dict,
                profile: bool) -> dict:
    """One rank of path 14: bootstrap from `env` (NCCL, one card), form the
    tp mesh over the group, then serve the bf16 and int8 paged engines and
    the int8 dense Engine. `models` holds the full single-card models (rank
    0 in the parent: the earlier paths' own), else each is drawn from the
    earlier paths' seed on this rank's card."""
    import torch.distributed as dist

    from lws_tpu_torch.models.flagship import flagship_config, init_quantized_params
    from lws_tpu_torch.models.llama import init_params
    from lws_tpu_torch.obs import device as devicemod
    from lws_tpu_torch.ops import _ext
    from lws_tpu_torch.parallel import initialize_from_env, local_device, mesh_from_bootstrap
    from lws_tpu_torch.parallel.bootstrap import bootstrap_info_from_env

    dev = local_device(bootstrap_info_from_env(env))
    # A member that dies before the rendezvous fails the path in two minutes,
    # not the default ten.
    info = initialize_from_env(env=env, device=dev, group_of_one=True, timeout_s=TP_TIMEOUT_S)
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.get_backend() == want_backend, f"rank {rank}: backend {dist.get_backend()}")
    records0 = len(devicemod.LEDGER.snapshot()["records"])
    _ext.build_on_rank_zero()  # the parent built every kernel before path 14
    out = {"rank": rank, "device": str(dev),
           "compiles": len(devicemod.LEDGER.snapshot()["records"]) - records0}
    mesh = mesh_from_bootstrap(info)
    out["tp"] = mesh.tp
    cfg, cfg8 = flagship_config("full"), flagship_config("full", kv_quant=True)
    out["collectives"] = collective_cost(torch, mesh, dev, cfg.vocab_size, cfg.d_model)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731 (the earlier paths' seed)
    model = models.get("bf16") or init_params(cfg, gen(), device=dev)
    out["bf16"], engine = tp_serve_paged(torch, cfg, model, mesh, prompts, f"rank {rank} bf16")
    del model, engine
    torch.cuda.empty_cache()
    model8 = models.get("int8") or init_quantized_params(cfg8, gen(), device=dev)
    out["int8"], engine = tp_serve_paged(torch, cfg8, model8, mesh, prompts, f"rank {rank} int8")
    if profile:
        out["profile"] = tp_profile(torch, engine, prompts, record=rank == 0)
    del engine
    torch.cuda.empty_cache()
    out["dense"] = tp_serve_dense(torch, cfg8, model8, mesh, dense_prompt)
    del model8
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return out


def tp_member(rank: int, out_dir: str, prompts, dense_prompt, profile: bool) -> None:
    """A spawned member of path 14's group (ranks 1..N-1): its contract is
    in os.environ; its record goes to out_dir/<rank>.json."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    rec = tp_rank_run(torch, rank, dict(os.environ), prompts, dense_prompt, {}, profile)
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(rec, f)


def check_tp_streams(torch, dev, cfg, model, prompts, got, want, what: str) -> int:
    """Rank 0's streams against the single-card streams: equal, or forked
    at a near-tie (the TP stream's tokens within LOGITS_REL_TOL of each
    row's max under the single-card model). Returns the forks."""
    forks = 0
    for p, g, w in zip(prompts, got, want):
        i = first_difference(g, w)
        if i < min(len(g), len(w)):
            forks += 1
            gap = check_greedy_chain(torch, dev, cfg, model, np.asarray(p)[None],
                                     np.asarray(g, np.int32), what)
            print(f"{what}: a stream forks from the single card's at step {i} "
                  f"(a near-tie: every token within {gap:.3e} of its row's max)")
        else:
            check(len(g) == len(w), f"{what}: stream lengths {len(g)} vs {len(w)}")
    return forks


def path_tp_only(torch, dev, cfg, world: int, profile: bool) -> None:
    """Path 14 alone (--tp-only): the single-card references it is held to
    are computed here first, on rank 0's card, from the same seeds, prompts
    and engines as paths 5, 6 and 8 (one round each)."""
    from lws_tpu_torch.models.flagship import flagship_config, init_quantized_params
    from lws_tpu_torch.models.llama import init_params
    from lws_tpu_torch.serving.engine import Engine

    cfg8 = flagship_config("full", kv_quant=True)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    models = {"bf16": init_params(cfg, gen(), device=dev),
              "int8": init_quantized_params(cfg8, gen(), device=dev)}
    rng = np.random.default_rng(0)
    rng.integers(1, cfg.vocab_size, 300)  # path 5's logits check draws its prompt first
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in paged_prompt_lens()]
    refs = {}
    for name, c in (("bf16", cfg), ("int8", cfg8)):
        *_, engine, refs[name] = serve_paged(torch, dev, c, models[name], prompts,
                                             f"single-card {name} engine", rounds=1)
        del engine
        torch.cuda.empty_cache()
    warm, dense_prompt = dense_batch(cfg8)
    engine = Engine(cfg8, models["int8"], batch_size=SLOTS, max_len=MAX_LEN, device=dev)
    engine.generate(warm, 4)
    refs["dense"] = engine.generate(dense_prompt, NEW_TOKENS).tokens.tolist()
    del engine
    torch.cuda.empty_cache()
    path_tp_group(torch, dev, world, models, prompts, dense_prompt, refs, profile)


def path_tp_group(torch, dev, world: int, models: dict, prompts, dense_prompt, refs: dict,
                  profile: bool) -> dict:
    """Path 14: one rank per card (rank 0 here, the others spawned), each
    started from the env contract the control plane gives a group member
    (parallel.launch.group_env) with NCCL, forms one tp mesh over the
    group and serves, at flagship_config("full") width and depth: the bf16
    and the int8 (weights and KV) TP PagedBatchEngine over the 8 paged
    prompts, and the int8 TP dense Engine over path 8's batch. Checked:
    every rank's streams are identical; rank 0's equal the single-card
    streams `refs` or fork only at a near-tie; every rank's launch counts
    equal the single-card formulas of paths 5, 6 and 8 for its own steps;
    each rank's parameter and pool bytes are 1/tp of the sharded tensors
    plus the replicated ones; no rank but 0 compiled a kernel. Returns rank
    0's launches over the three engines."""
    import tempfile

    from lws_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    port = launch.free_port()
    envs = [launch.group_env(r, world, port) for r in range(world)]
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = None
        if world > 1:
            ctx, _ = launch.spawn_group(tp_member, world, args=(out_dir, prompts, dense_prompt,
                                                                profile),
                                        ranks=range(1, world), port=port)
        try:
            recs = [tp_rank_run(torch, 0, envs[0], prompts, dense_prompt, models, profile)]
            if ctx is not None:
                launch.join(ctx, timeout_s=900)
        finally:
            if ctx is not None:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
        for r in range(1, world):
            with open(os.path.join(out_dir, f"{r}.json")) as f:
                recs.append(json.load(f))
    L, tp = models["bf16"].cfg.n_layers, world
    small = sum(1 for p in prompts if bucket_of(len(p)) <= 256)
    for rec in recs:
        r = rec["rank"]
        check(rec["tp"] == tp, f"rank {r}: tp {rec['tp']}")
        check(rec["compiles"] == 0, f"rank {r}: {rec['compiles']} compile ledger records")
        for eng in ("bf16", "int8", "dense"):
            e = rec[eng]
            check(e["param_bytes"] == e["want_param_bytes"] and
                  e["pool_bytes"] == e["want_pool_bytes"],
                  f"rank {r} {eng}: parameter bytes {e['param_bytes']} (want "
                  f"{e['want_param_bytes']}), pool bytes {e['pool_bytes']} (want "
                  f"{e['want_pool_bytes']})")
        check_launches(f"tp rank {r} bf16 paged", rec["bf16"]["launches"], {
            "flash_attention": L * SLOTS, "paged_decode_attention": L * rec["bf16"]["steps"]})
        s8 = rec["int8"]["steps"]
        check_launches(f"tp rank {r} int8 paged", rec["int8"]["launches"], {
            "flash_attention": L * SLOTS, "paged_decode_attention_int8": L * s8,
            "int8_matmul": (7 * L + 1) * s8 + 7 * L * small + SLOTS})
        sd = rec["dense"]["steps"]
        check_launches(f"tp rank {r} int8 dense", rec["dense"]["launches"], {
            "flash_attention": L, "int8_decode_attention": L * sd,
            "int8_matmul": (7 * L + 1) * sd + 1})
        for eng in ("bf16", "int8"):
            check(rec[eng]["streams"] == recs[0][eng]["streams"],
                  f"rank {r} {eng}: streams differ from rank 0's")
        check(rec["dense"]["tokens"] == recs[0]["dense"]["tokens"],
              f"rank {r} dense: tokens differ from rank 0's")
        print(f"tensor-parallel group: rank {r} ({rec['device']}) tp={tp}: "
              + "; ".join(f"{eng} TTFT {rec[eng]['ttft_ms']:.1f} ms, {rec[eng]['tok_s']:.1f} tok/s"
                          for eng in ("bf16", "int8", "dense"))
              + f"; parameters {rec['int8']['param_bytes'] / 1e9:.3f} GB int8, "
                f"{rec['bf16']['param_bytes'] / 1e9:.3f} GB bf16; "
              + ", ".join(f"{k} {v['host_us']:.1f} us host ({v['device_us']:.1f} us to the "
                          f"device's end) a call" for k, v in rec["collectives"].items()))
    rec0 = recs[0]
    forks = {
        "bf16": check_tp_streams(torch, dev, models["bf16"].cfg, models["bf16"], prompts,
                                 rec0["bf16"]["streams"], refs["bf16"], "tp bf16 paged"),
        "int8": check_tp_streams(torch, dev, models["int8"].cfg, models["int8"], prompts,
                                 rec0["int8"]["streams"], refs["int8"], "tp int8 paged"),
        "dense": check_tp_streams(torch, dev, models["int8"].cfg, models["int8"], dense_prompt,
                                  rec0["dense"]["tokens"], refs["dense"], "tp int8 dense"),
    }
    print(f"tensor-parallel group: tp={tp} over {world} card(s), every rank's streams identical; "
          f"rank 0 against the single card: forks at near-ties {forks}; "
          f"path wall time {time.perf_counter() - t0:.1f} s")
    if profile:
        p = rec0["profile"]
        print(f"profile tp={tp} int8 paged: {p['steps']} decode steps, 8 slots: wall "
              f"{p['wall_ms']:.2f} ms ({p['wall_ms'] / p['steps']:.2f} ms/step), device busy "
              f"{p['busy_ms']:.2f} ms, NCCL {p['nccl_ms']:.3f} ms = "
              f"{p['nccl_ms'] / p['busy_ms']:.1%} of device time, "
              f"{p['nccl_ms'] / p['wall_ms']:.1%} of wall; {p['kernels_per_step']:.0f} kernels/step, "
              f"{p['nccl_per_step']:.0f} of them NCCL")
    counts = {name: sum(rec0[eng]["launches"][name] for eng in ("bf16", "int8", "dense"))
              for name in kernel_counters()}
    return counts


# ---------------------------------------------------------------------------
# Path 16: the tensor-parallel disaggregated pair, as real worker processes.

PAIR_REQUESTS = 8  # the load runner's requests over the pair (path 17 runs the loadgen command's 17)
PAIR_MODEL, PAIR_DEVICE = "flagship", "cuda"  # the workers' LWS_TPU_MODEL and --device
PAIR_READY_S = 600.0  # a role's start: imports, the card, the full flagship, the group
PAIR_PROFILE_HZ = 67.0  # the decode role's continuous profiler (LWS_TPU_PROFILE_HZ)
# The poison prompt: more rows than the decode role's max_len (MAX_LEN),
# prefilled by the second prefill process, whose budget is larger.
PAIR_POISON_LEN, PAIR_POISON_MAX_LEN = MAX_LEN + 64, MAX_LEN + 128
# Ports that a child process binds later (KV, telemetry, API server) are
# drawn from here: below Linux's ephemeral range (32768-60999 by default), so
# no bind to port 0 and no outgoing connection of any process (a group's
# rendezvous store, NCCL's bootstrap, a readiness probe) can take one between
# the pick and the child's bind, as it can a port that `bind(0)` handed out.
LISTEN_PORTS = (20000, 32768)


def listen_ports(names) -> dict:
    """One distinct port of LISTEN_PORTS per name, each free on every
    address when drawn."""
    import random
    import socket

    rng, ports = random.Random(), {}
    while len(ports) < len(names):
        port = rng.randrange(*LISTEN_PORTS)
        if port in ports.values():
            continue
        with socket.socket() as s:
            try:
                s.bind(("", port))
            except OSError:
                continue
        ports[names[len(ports)]] = port
    return ports


class StandInApi:
    """The control plane's API server as the disagg workers read it
    (lws_tpu_torch/client.py: GET /apis/<kind> and /apis/<kind>/<ns>/<name>),
    serving fixed records: each role's ready pod with its KV port, and the
    DisaggregatedSet's revision-aware `-prv` services that select them. The
    JAX control plane does not run beside the port on the card."""

    def __init__(self, kv_ports: dict) -> None:
        import http.server

        from lws_tpu_torch.serving import kv_transport as kt

        ds = {kt.DS_NAME_LABEL_KEY: "pair", kt.DS_REVISION_LABEL_KEY: "r1",
              kt.DS_SLICE_LABEL_KEY: "0"}
        pods, services = [], []
        for role, port in kv_ports.items():
            labels = {**ds, kt.DS_ROLE_LABEL_KEY: role}
            pods.append({"metadata": {"namespace": "default", "name": f"{role}-0",
                                      "labels": labels},
                         "status": {"ready": True, "address": "127.0.0.1"},
                         "spec": {"containers": [{"name": role, "env": [
                             {"name": "LWS_TPU_KV_PORT", "value": str(port)}]}]}})
            services.append({"metadata": {"namespace": "default", "name": f"pair-{role}-prv",
                                          "labels": labels},
                             "spec": {"selector": {kt.DS_NAME_LABEL_KEY: "pair",
                                                   kt.DS_ROLE_LABEL_KEY: role}}})
        records = {"Pod": pods, "Service": services}

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — the http.server hook
                parts = self.path.strip("/").split("/")
                body, code = None, 404
                if len(parts) == 2 and parts[0] == "apis":
                    body, code = records.get(parts[1], []), 200
                elif len(parts) == 4 and parts[0] == "apis":
                    body = next((r for r in records.get(parts[1], [])
                                 if r["metadata"]["namespace"] == parts[2]
                                 and r["metadata"]["name"] == parts[3]), None)
                    code = 200 if body is not None else 404
                data = json.dumps(body if code == 200 else {"error": "not found"}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class Role:
    """One role's worker process (`python -m lws_tpu_torch.serving.disagg_worker
    <role>`), its log and its KV endpoint."""

    def __init__(self, role: str, port: int, api_url: str, tp: int, cards: str, chunk: int,
                 log_dir: str, tag: str, metrics_port: int, max_len: int = MAX_LEN) -> None:
        repo = os.path.dirname(os.path.abspath(__file__))
        # Every journey is kept (LWS_TPU_JOURNEY_SAMPLE=1): the path reads
        # back named healthy requests, which a 2 % reservoir could drop.
        env = dict(os.environ, LWS_TPU_MODEL=PAIR_MODEL, LWS_TPU_TP=str(tp),
                   LWS_TPU_KV_PORT=str(port), LWS_TPU_API=api_url, POD_NAME=f"{role}-0",
                   POD_NAMESPACE="default", LWS_TPU_KV_CHUNK=str(chunk),
                   CUDA_VISIBLE_DEVICES=cards, LWS_TPU_METRICS_PORT=str(metrics_port),
                   LWS_TPU_JOURNEY_SAMPLE="1",
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        if role == "decode":
            env["LWS_TPU_PROFILE_HZ"] = str(PAIR_PROFILE_HZ)
        self.role, self.ep = role, ("127.0.0.1", port)
        self.metrics_port = metrics_port
        self.log_path = os.path.join(log_dir, f"{role}-{tag}.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "lws_tpu_torch.serving.disagg_worker", role, "--steps",
             str(HANDOFF_STEPS), "--max-len", str(max_len), "--device", PAIR_DEVICE],
            env=env, cwd=repo, stdout=self._log, stderr=subprocess.STDOUT)

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def alive(self) -> None:
        check(self.proc.poll() is None, f"the {self.role} worker exited with "
                                        f"{self.proc.returncode}:\n{self.log()[-3000:]}")

    def wait_ready(self, deadline: float) -> None:
        import socket

        while time.monotonic() < deadline:
            self.alive()
            try:
                with socket.create_connection(self.ep, timeout=1.0):
                    return
            except OSError:
                time.sleep(0.5)
        check(False, f"the {self.role} worker never listened:\n{self.log()[-3000:]}")

    def children(self) -> list[int]:
        return proc_children(self.proc.pid)

    def http(self, path: str, body=None) -> tuple:
        """(status, text) of a GET (a POST with `body`) on the telemetry port."""
        return http_call(self.metrics_port, path, body)

    def metrics(self) -> dict:
        code, text = self.http("/metrics")
        check(code == 200, f"the {self.role} role's /metrics answered {code}")
        from lws_tpu_torch.core import metrics as metricsmod

        return metricsmod.parse_exposition(text)

    def journey(self, rid: str) -> dict:
        code, text = self.http(f"/debug/request/{rid}")
        check(code == 200, f"the {self.role} role has no journey for {rid}: {code} {text[:300]}")
        return json.loads(text)

    def stop(self, http_drain: bool = False) -> dict:
        """The drain, by SIGTERM or by POST /debug/drain; the worker must exit
        0. Returns the kernel launches its rank 0 printed at exit."""
        import signal

        if http_drain:
            code, text = self.http("/debug/drain", {})
            check((code, text) == (200, '{"draining": true}'),
                  f"the {self.role} role's POST /debug/drain answered {code} {text}")
        else:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self._log.close()
        log = self.log()
        check(rc == 0, f"the {self.role} worker's "
                       f"{'HTTP' if http_drain else 'SIGTERM'} drain exited {rc}:\n{log[-3000:]}")
        line = [ln for ln in log.splitlines() if f"[{self.role}] kernel launches " in ln]
        check(len(line) == 1, f"the {self.role} worker printed {len(line)} launch lines")
        return json.loads(line[0].split(" kernel launches ", 1)[1])


def proc_children(pid: int) -> list[int]:
    """The live processes whose parent is `pid` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return out


def pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


# The API servers path 17 starts speak https with the CA of serve's
# --tls-dir and want a bearer token (--token-file): by port, (the CA bundle,
# the admin token), which http_call uses for them.
API_AUTH: dict = {}


def http_call(port: int, path: str, body=None, timeout: float = 30.0,
              token: Optional[str] = None) -> tuple:
    """(status, text) of one GET (a POST of `body` as JSON) on 127.0.0.1. A
    port of API_AUTH is called over https, trusting its CA, with its admin
    token, or with `token` when given ("" sends none)."""
    import ssl
    import urllib.error
    import urllib.request

    ca, admin = API_AUTH.get(port, (None, None))
    bearer = admin if token is None else token
    req = urllib.request.Request(f"{'https' if ca else 'http'}://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Authorization": f"Bearer {bearer}"} if bearer else {})
    context = ssl.create_default_context(cafile=ca) if ca else None
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=context) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def metric_sum(fams: dict, family: str, sample: str, **match) -> float:
    """The sum of `sample`'s values in a parsed exposition whose labels
    include `match`."""
    return sum(v for name, labels, v, _ in fams.get(family, {}).get("samples", [])
               if name == sample and all(labels.get(k) == w for k, w in match.items()))


class Scraper:
    """A scraper on a thread: once a second it GETs every source (`{name:
    (port, path)}`), timing each answer. With `tokens_of`, that source's
    `serving_tokens_total` is read too, for its tok/s over the window."""

    def __init__(self, sources: dict, tokens_of: Optional[str] = None) -> None:
        self.sources, self.tokens_of = sources, tokens_of
        self.latency: dict = {name: [] for name in sources}
        self.tokens: list = []  # (t, the tokens_of source's serving_tokens_total)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        from lws_tpu_torch.core import metrics as metricsmod

        while True:
            for name, (port, path) in self.sources.items():
                t0 = time.perf_counter()
                code, text = http_call(port, path)
                self.latency[name].append((time.perf_counter() - t0, code))
                if name == self.tokens_of and code == 200:
                    fams = metricsmod.parse_exposition(text)
                    self.tokens.append((time.perf_counter(), metric_sum(
                        fams, "serving_tokens_total", "serving_tokens_total", engine="disagg")))
            if self._stop.wait(1.0):
                return

    def stop(self) -> dict:
        """{name: (scrapes, median ms, max ms)}, and the tok/s of
        `tokens_of` under "tok_s"; every scrape must have answered 200."""
        self._stop.set()
        self._thread.join(60)
        out = {}
        for name, lat in self.latency.items():
            check(lat and all(code == 200 for _, code in lat),
                  f"scrapes of {name}: {[c for _, c in lat]}")
            ms = [t * 1e3 for t, _ in lat]
            out[name] = (len(ms), statistics.median(ms), max(ms))
        if self.tokens_of:
            (t0, n0), (t1, n1) = self.tokens[0], self.tokens[-1]
            out["tok_s"] = (n1 - n0) / (t1 - t0) if t1 > t0 else float("nan")
        return out


def worker_metrics(port: int, who: str) -> dict:
    """A worker's own /metrics on its telemetry port, parsed."""
    from lws_tpu_torch.core import metrics as metricsmod

    code, text = http_call(port, "/metrics")
    check(code == 200, f"the {who} worker's /metrics answered {code}")
    return metricsmod.parse_exposition(text)


def command_over_deployed(eps: dict, api_port: int, metrics_ports: dict, loadgen) -> tuple:
    """The loadgen command against the deployed pair at full width: `python
    -m lws_tpu_torch loadgen shared_prefix --seed 0 --prefill <ep> --decode
    <ep> --server <the port's API server> --json` as a process, while a
    scraper reads the API server's /metrics/fleet once a second. Checked:
    every request completes; the prefill role's TTFT count and the decode
    role's ITL count move by exactly that number;
    serving_kv_transfer_bytes_total moves on both roles; the report's
    history block (sampled from /metrics/fleet) has a row for every
    (engine, class) the decode role counts; the fleet block the text frame
    renders (fold_fleet of /metrics/fleet, read once the command ends;
    --json prints the JAX package's keys, without it) has a goodput.
    Returns (the command's prompt lengths, the /metrics/fleet scrapes:
    (count, median ms, max ms))."""
    from lws_tpu_torch.core import metrics as metricsmod

    spec = loadgen.load_scenario(LOADGEN_SCENARIO)
    schedule = loadgen.build_schedule(spec, LOADGEN_SEED)
    n = len(schedule)
    before = {role: worker_metrics(port, role) for role, port in metrics_ports.items()}
    scraper = Scraper({"fleet": (api_port, "/metrics/fleet")})
    ca, admin = API_AUTH.get(api_port, (None, None))
    try:
        header, report, wall, _ = run_loadgen_command(
            [LOADGEN_SCENARIO, "--seed", str(LOADGEN_SEED),
             "--prefill", "%s:%d" % eps["prefill"], "--decode", "%s:%d" % eps["decode"],
             "--server", f"{'https' if ca else 'http'}://127.0.0.1:{api_port}", "--max-wall",
             "600"], timeout=900.0, global_args=("--cacert", ca) if ca else (),
            env_extra={"LWS_TPU_TOKEN": admin} if admin else None)
    finally:
        scrapes = scraper.stop()["fleet"]
    code, text = http_call(api_port, "/metrics/fleet")
    check(code == 200, f"deployed loadgen command: /metrics/fleet answered {code}")
    fleet_block = loadgen.fold_fleet(metricsmod.parse_exposition(text))
    after = {role: worker_metrics(port, role) for role, port in metrics_ports.items()}
    digest = loadgen.schedule_digest(schedule)
    check(header.endswith(f"schedule {digest[:12]})"),
          f"deployed loadgen command: header {header!r}")
    done = report["all"]["completed"]
    check(report["all"]["count"] == n and done == n,
          f"deployed loadgen command: {done} of {report['all']['count']} requests completed")

    def moved(who: str, family: str, sample: str, **match) -> float:
        return (metric_sum(after[who], family, sample, **match)
                - metric_sum(before[who], family, sample, **match))

    ttft = moved("prefill", "serving_ttft_seconds", "serving_ttft_seconds_count", engine="disagg")
    itl = moved("decode", "serving_itl_seconds", "serving_itl_seconds_count", engine="disagg")
    check(ttft == n and itl == n, f"deployed loadgen command: the prefill role's TTFT count "
                                  f"moved {ttft}, the decode role's ITL count {itl}, for {n} "
                                  "requests")
    wire = {role: moved(role, "serving_kv_transfer_bytes_total",
                        "serving_kv_transfer_bytes_total", role=role) for role in metrics_ports}
    check(all(v > 0 for v in wire.values()),
          f"deployed loadgen command: transfer bytes moved {wire}")
    counted = {labels.get("engine", "-") + ("/" + labels["klass"] if labels.get("klass") else "")
               for name, labels, _, _ in after["decode"].get(
                   "serving_tokens_total", {}).get("samples", [])
               if name == "serving_tokens_total"}
    rows = set((report.get("history") or {}).get("classes", {}))
    check(counted and counted <= rows, f"deployed loadgen command: history rows {sorted(rows)}, "
                                       f"the decode role counts {sorted(counted)}")
    check("fleet" not in report, f"deployed loadgen command: --json keys {sorted(report)}")
    goodput = fleet_block.get("goodput")
    check(goodput is not None, f"deployed loadgen command: fleet block {fleet_block}")
    classes = "; ".join(
        f"class {k}: TTFT p50 {c['ttft_p50'] * 1e3:.1f} ms, p99 {c['ttft_p99'] * 1e3:.1f} ms "
        f"(the client's proxy: the prefill leg), goodput {c['goodput_fraction']:.1%}"
        for k, c in sorted(report["classes"].items()))
    print(f"deployed loadgen command (python -m lws_tpu_torch loadgen {LOADGEN_SCENARIO} --seed "
          f"{LOADGEN_SEED} --prefill --decode --server <the API server>): {done} of {n} requests "
          f"completed; TTFT count +{ttft:.0f} (prefill), ITL count +{itl:.0f} (decode); "
          f"transfer bytes moved { {k: int(v) for k, v in wire.items()} }; history rows "
          f"{sorted(rows)} ({len((report.get('history') or {}).get('recommendation', []))} "
          f"recommendation steps); fleet GOODPUT {goodput:.1%}; {classes}; /metrics/fleet "
          f"under the command's load: {scrapes[0]} scrapes, median {scrapes[1]:.2f} ms, max "
          f"{scrapes[2]:.2f} ms; the command took {wall:.1f} s")
    return [len(r.prompt) for r in schedule], scrapes


def check_journey(r: Role, rid: str, spans: set, chunks: int = 0, outcome: str = "") -> dict:
    """`rid`'s journey on role `r` is complete, holds `spans`, and (for a
    streamed handoff) one chunk-timeline entry per chunk: `chunks_produced`
    on prefill, `chunks` on decode."""
    j = r.journey(rid)
    names = {sp["name"] for sp in j["spans"]}
    check(j["completed"] and spans <= names,
          f"{r.role} journey {rid}: completed={j['completed']} spans {sorted(names)}")
    if chunks:
        key = "chunks_produced" if r.role == "prefill" else "chunks"
        got = j["annotations"].get(key) or []
        check(len(got) == chunks, f"{r.role} journey {rid}: {len(got)} {key} of {chunks}")
    if outcome:
        check(j["outcome"] == outcome and outcome in j["flags"],
              f"{r.role} journey {rid}: outcome {j['outcome']}, flags {j['flags']}")
    return j


def check_compile_journeys(r: Role, since_unix: float) -> tuple:
    """Every compile record the role made during requests (at or after
    `since_unix`, or naming a request) names its request, and that
    request's journey carries it. Returns (records, records during requests)."""
    code, text = r.http("/debug/compile")
    check(code == 200, f"the {r.role} role's /debug/compile answered {code}")
    records = json.loads(text)["records"]
    during = [rec for rec in records if rec["unix"] >= since_unix or rec["request_id"]]
    for rec in during:
        check(rec["request_id"], f"{r.role} compile record during requests names none: {rec}")
        got = r.journey(rec["request_id"])["annotations"].get("compiles") or []
        check(any(c["executable"] == rec["executable"] and c["unix"] == rec["unix"]
                  for c in got),
              f"{r.role} journey {rec['request_id']} lacks compile {rec}")
    return len(records), len(during)


def check_card_gauges(torch, r: Role, cards: str) -> None:
    """The role's device-memory gauges name its card (gpu:0 of the cards it
    sees) within its limit, and the limit is that card's memory."""
    fams = r.metrics()
    card = int(cards.split(",")[0])
    want = torch.cuda.get_device_properties(card).total_memory
    in_use = metric_sum(fams, "serving_hbm_bytes_in_use", "serving_hbm_bytes_in_use",
                        device="gpu:0")
    limit = metric_sum(fams, "serving_hbm_bytes_limit", "serving_hbm_bytes_limit", device="gpu:0")
    check(limit == want and 0 < in_use <= limit,
          f"the {r.role} role's gpu:0 gauges: in use {in_use}, limit {limit} (card {want})")


def pair_request(roles: dict, rid: str, prompt, timeout: float = 600.0,
                 expect_failed: bool = False) -> tuple:
    """One prompt through the pair: submitted to prefill, its result polled
    from decode. Returns (the result's meta, its tokens [1, steps + 1]; None
    for a failed result, which only `expect_failed` accepts)."""
    from lws_tpu_torch.serving import kv_transport as kt

    kt.submit_prompt(roles["prefill"].ep, rid, kt.arrays_to_bytes(prompt=prompt))
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for r in roles.values():
            r.alive()
        got = kt.pull_result(roles["decode"].ep, rid)
        if got is not None:
            meta, payload = got
            check(("failed" in meta) == expect_failed,
                  f"pair request {rid}: failed {meta.get('failed')!r}, expected a "
                  f"{'failure' if expect_failed else 'result'}")
            return meta, None if expect_failed else kt.bytes_to_arrays(payload)["tokens"]
        time.sleep(0.05)
    check(False, f"pair request {rid}: no result in {timeout:.0f} s")


def pair_refs(torch, dev) -> dict:
    """Path 16's one-card references without path 12 (--disagg-only): path
    12's engines and handoffs for the 100-token prompt (monolithic) and the
    1,000-token prompt (monolithic and streamed), each stream held to the
    decode engine's own prefill + decode_n."""
    from lws_tpu_torch.serving import disagg_worker as dw
    from lws_tpu_torch.serving import kv_transport as kt
    from lws_tpu_torch.serving.engine import Engine

    cfg, model = dw.build_model(MAX_LEN, dev, scale="full")
    pre, dec = (Engine(cfg, model, batch_size=1, max_len=MAX_LEN, device=dev) for _ in range(2))
    V = cfg.vocab_size
    rng = np.random.default_rng(16)
    pre.generate(rng.integers(1, V, (1, 32)).astype(np.int32), 4)  # warm-up (path 12's draws)
    prompts = {len(p): p for p in (rng.integers(1, V, n).astype(np.int32)
                                   for n in paged_prompt_lens())}
    server = kt.KVServer(port=0, host="127.0.0.1")
    refs = {}
    try:
        for S, chunk in ((100, 0), (1000, 0), (1000, CHUNK)):
            r = one_handoff(torch, pre, dec, server, prompts[S], chunk, f"ref-{chunk}-{S}")
            p = prompts[S][None]
            tok, cache = dec.prefill_chunked(p, chunk_size=CHUNK) if chunk else dec.prefill(p)
            _, _, toks = dec.decode_n(tok, cache, HANDOFF_STEPS)
            oracle = np.concatenate([tok.cpu().numpy()[:, None], toks.cpu().numpy()], axis=1)
            check(np.array_equal(r["toks"], oracle), f"pair reference {chunk}/{S}: the one-card "
                                                     f"handoff differs from its oracle")
            refs[(S, chunk)] = r
    finally:
        server.close()
    return refs


def check_pair_stream(torch, dev, got, ref, what: str, model_box: dict) -> str:
    """`got` equals the one-card handoff's tokens, or forks from them only
    at an argmax near-tie under the one-card model (built on demand)."""
    want = np.asarray(ref["toks"])
    got = np.asarray(got)
    i = first_difference(got[0], want[0])
    if i >= want.shape[1]:
        check(got.shape == want.shape, f"{what}: tokens {got.shape} vs {want.shape}")
        return "equal"
    if "model" not in model_box:
        from lws_tpu_torch.serving import disagg_worker as dw

        model_box["cfg"], model_box["model"] = dw.build_model(MAX_LEN, dev, scale="full")
    gap = check_greedy_chain(torch, dev, model_box["cfg"], model_box["model"],
                             np.asarray(ref["prompt"])[None], got[0], what)
    return f"forks at step {i} (a near-tie: every token within {gap:.3e} of its row's max)"


def disagg_profile_member(rank: int, out_dir: str, prompt) -> None:
    """A rank of the decode role's profile group: the decode engine at full
    width on its tp mesh, one prefill of `prompt`, then HANDOFF_STEPS decode
    steps profiled on rank 0 (every rank runs them in lockstep)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import contextlib

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lws_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env, local_device
    from lws_tpu_torch.serving import disagg_worker as dw

    os.environ["LWS_TPU_MODEL"] = PAIR_MODEL  # the decode workers' model, as their env sets it
    info = initialize_from_env(timeout_s=TP_TIMEOUT_S)
    dev = local_device(info)
    mesh = build_mesh(MeshSpec(tp=info.num_processes))
    engine = dw.build_engine(1, MAX_LEN, dev, mesh=mesh)
    token, cache = engine.prefill(np.asarray(prompt)[None])
    token, cache, _ = engine.decode_n(token, cache, 8)  # warm
    torch.cuda.synchronize()
    ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if rank == 0 \
        else contextlib.nullcontext()
    with ctx as prof:
        t0 = time.perf_counter()
        engine.decode_n(token, cache, HANDOFF_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rank == 0:
        nccl = busy = 0.0
        for ev in device_kernels(prof):
            busy += ev.self_device_time_total
            if "nccl" in ev.key.lower():
                nccl += ev.self_device_time_total
        with open(os.path.join(out_dir, "profile.json"), "w") as f:
            json.dump({"wall_ms": wall * 1e3, "busy_ms": busy / 1e3, "nccl_ms": nccl / 1e3}, f)
    dist.destroy_process_group()


def disagg_decode_profile(tp: int, cards: str, prompt) -> dict:
    """NCCL's share of the decode role's steps at tp on `cards`: a spawned
    group of its own (the workers' processes carry no profiler)."""
    import tempfile

    from lws_tpu_torch.parallel import launch

    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = cards  # the children see the decode role's cards
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            ctx, _ = launch.spawn_group(disagg_profile_member, tp, args=(out_dir, prompt))
            launch.join(ctx, timeout_s=900)
            with open(os.path.join(out_dir, "profile.json")) as f:
                return json.load(f)
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES")
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def check_pair_telemetry(refs: dict, telemetry: dict, logs: dict, tp: int) -> None:
    """Path 16's telemetry ledgers against the workers' own logs and the
    one-card handoffs: each role's TTFT (prefill) or ITL (decode) count
    equals the handoffs it logged; serving_kv_transfer_bytes_total moved by
    the 1,000-token bundle's bytes on both roles, streamed and monolithic.
    Prints the scrape latency under load and the decode role's tok/s in
    that window."""
    handoffs = {name: sum(1 for ln in logs[f"{name}.log"].splitlines()
                          if ln.startswith(f"[{name.split('-')[0]}] HANDOFF "))
                for name in ("prefill-a", "decode-a")}
    ttft = metric_sum(telemetry["prefill-a"], "serving_ttft_seconds", "serving_ttft_seconds_count",
                      engine="disagg")
    itl = metric_sum(telemetry["decode"], "serving_itl_seconds", "serving_itl_seconds_count",
                     engine="disagg")
    check(ttft == handoffs["prefill-a"] and itl == handoffs["decode-a"],
          f"tp disagg pair: TTFT count {ttft} for {handoffs['prefill-a']} prefill handoffs, ITL "
          f"count {itl} for {handoffs['decode-a']} decode handoffs")
    moved = {}
    for rid, chunk in (("long-s", CHUNK), ("long-m", 0)):
        before, after = telemetry[rid]
        want = refs[(1000, chunk)]["stats"]["bundle_bytes"]
        for role in ("prefill", "decode"):
            got = (metric_sum(after[role], "serving_kv_transfer_bytes_total",
                              "serving_kv_transfer_bytes_total", role=role)
                   - metric_sum(before[role], "serving_kv_transfer_bytes_total",
                                "serving_kv_transfer_bytes_total", role=role))
            check(got == want, f"tp disagg pair {rid}: the {role} role's "
                               f"serving_kv_transfer_bytes_total moved {got}, bundle {want} B")
            moved[f"{rid}/{role}"] = got
    sc = telemetry["scrapes"]
    comp = {k[len("compiles-"):]: v for k, v in telemetry.items() if k.startswith("compiles-")}
    # The parent builds every library before the roles start, so a role
    # makes no compile record during a request on the card: say so rather
    # than count a check that had nothing to hold.
    during = sum(n for _, n in comp.values())
    compiles = (f"compile records (total, during requests) {comp}, each during a request on "
                f"its journey" if during else
                f"compile journeys not exercised in this run (0 records during requests; "
                f"totals {({k: v[0] for k, v in comp.items()})})")
    print(f"tp disagg pair tp={tp} telemetry: /metrics scrapes once a second under the load "
          f"runner: prefill {sc['prefill'][0]} scrapes, median {sc['prefill'][1]:.2f} ms, max "
          f"{sc['prefill'][2]:.2f} ms; decode {sc['decode'][0]} scrapes, median "
          f"{sc['decode'][1]:.2f} ms, max {sc['decode'][2]:.2f} ms; decode role "
          f"{sc['tok_s']:.1f} tok/s in that window (its serving_tokens_total); TTFT count "
          f"{ttft:.0f} = prefill handoffs, ITL count {itl:.0f} = decode handoffs; transfer bytes "
          f"moved {moved} = the 1,000-token bundles; {compiles}; journeys of long-s (4 chunks) "
          f"and long-m complete on both roles; the armed disagg.decode.process fault (1 trip) "
          f"left one bundle unacked and its redelivery completed; a poison bundle of "
          f"{PAIR_POISON_LEN} rows ended errored (journey kept errored) and the next request "
          f"was served; decode profile {telemetry['profile_stacks']} collapsed stacks at "
          f"{PAIR_PROFILE_HZ:.0f} Hz")


def path_tp_disagg(torch, dev, tp: int, refs: dict, profile_nccl: bool = False) -> dict:
    """16. The tensor-parallel disaggregated pair at full width: the workers'
    int8-weight, bf16-K/V flagship (LWS_TPU_MODEL=flagship), each role a
    real OS process (`python -m lws_tpu_torch.serving.disagg_worker
    prefill|decode`) with LWS_TPU_TP=tp: on one card each role is a one-rank
    mesh; with 2 x tp cards prefill takes cards 0..tp-1 and decode the next
    tp. They pair over loopback TCP through a stand-in API server. Traffic:
    the 1,000-token prompt streamed (LWS_TPU_KV_CHUNK=CHUNK), the 100-token
    prompt, the JAX package's shared_prefix scenario (seed 0, its first
    PAIR_REQUESTS requests, ids lr-N) open-loop through loadgen.DisaggTarget;
    then the prefill role restarts with LWS_TPU_KV_CHUNK=0 and a budget of
    PAIR_POISON_MAX_LEN rows, and the 1,000-token prompt hands off
    monolithic; then the 100-token prompt under a live decode fault (its
    bundle redelivered), a poison prompt of PAIR_POISON_LEN tokens (past the
    decode role's max_len: ended errored) and the 100-token prompt again;
    then the prefill role drains by POST /debug/drain and the decode role
    by SIGTERM. Each measured
    prompt first goes through once unmeasured (a fresh process's warm-up). Checked: each
    bundle's bytes equal path 12's one-card handoff's for the prompt, and
    its tokens too (or fork only at an argmax near-tie); the handoff record
    says tp_gathered and carries its reshard; every load-runner request
    completes on the client and is handed off on both roles (their logs);
    each role's kernel launches, printed by its rank 0 at exit, equal the
    handoffs' formulas; both roles exit 0 and leave no process behind.
    Returns the two roles' launches."""
    import tempfile

    from lws_tpu_torch import loadgen
    from lws_tpu_torch.models.flagship import flagship_config

    t_path = time.perf_counter()
    pair_cfg = flagship_config("full" if PAIR_MODEL == "flagship" else "smoke")
    L = pair_cfg.n_layers
    cards_all = torch.cuda.device_count()
    split = cards_all >= 2 * tp
    cards = {"prefill": ",".join(str(c) for c in range(tp)),
             "decode": ",".join(str(c) for c in (range(tp, 2 * tp) if split else range(tp)))}
    ports = listen_ports(("prefill", "decode", "prefill-metrics", "decode-metrics"))
    api = StandInApi({role: ports[role] for role in ("prefill", "decode")})
    long_p, short_p = refs[(1000, 0)]["prompt"], refs[(100, 0)]["prompt"]
    spec = loadgen.load_scenario("shared_prefix")
    schedule = loadgen.build_schedule(spec, 0)[:PAIR_REQUESTS]
    results, launches, followers = {}, {}, []
    telemetry: dict = {}
    with tempfile.TemporaryDirectory() as log_dir:
        def start(role: str, chunk: int, tag: str, max_len: int = MAX_LEN) -> Role:
            return Role(role, ports[role], api.url, tp, cards[role], chunk, log_dir, tag,
                        ports[f"{role}-metrics"], max_len)

        roles = {"decode": start("decode", 0, "a"), "prefill": start("prefill", CHUNK, "a")}
        try:
            deadline = time.monotonic() + PAIR_READY_S
            for r in roles.values():
                r.wait_ready(deadline)
                check(r.http("/healthz") == (200, "ok"), f"the {r.role} role's /healthz")
            t_ready = time.perf_counter() - t_path
            t_requests = time.time()  # compile records from here on belong to requests
            followers = [c for r in roles.values() for c in r.children()]
            # A fresh process's first prefill and decode pay its warm-up
            # (library loads, first launches): each measured request runs once
            # unmeasured first.
            pair_request(roles, "warm-s", long_p)
            pair_request(roles, "warm-short", short_p)
            before = {role: r.metrics() for role, r in roles.items()}
            results["long-s"] = pair_request(roles, "long-s", long_p)
            telemetry["long-s"] = (before, {role: r.metrics() for role, r in roles.items()})
            results["short"] = pair_request(roles, "short", short_p)
            target = loadgen.DisaggTarget(roles["prefill"].ep, roles["decode"].ep, id_prefix="lr")
            scraper = Scraper({role: (r.metrics_port, "/metrics") for role, r in roles.items()},
                              tokens_of="decode")
            try:
                run = loadgen.run_schedule(schedule, target, max_wall_s=600.0)
            finally:
                telemetry["scrapes"] = scraper.stop()
            # The streamed journeys on both roles, before later traffic can
            # displace them: a role keeps its 16 slowest healthy journeys.
            check_journey(roles["prefill"], "long-s", {"serve.prefill", "kv.gather"},
                          chunks=-(-1000 // CHUNK))
            check_journey(roles["decode"], "long-s",
                          {"kv.deserialize", "kv.reshard", "serve.decode_dispatch"},
                          chunks=-(-1000 // CHUNK))
            # The first prefill process's own ledgers, before it drains.
            telemetry["compiles-prefill-a"] = check_compile_journeys(roles["prefill"], t_requests)
            check_card_gauges(torch, roles["prefill"], cards["prefill"])
            telemetry["prefill-a"] = roles["prefill"].metrics()
            launches["prefill-a"] = roles["prefill"].stop(http_drain=True)
            roles["prefill"] = start("prefill", 0, "b", PAIR_POISON_MAX_LEN)
            roles["prefill"].wait_ready(time.monotonic() + PAIR_READY_S)
            followers += roles["prefill"].children()
            pair_request(roles, "warm-m", long_p)
            before = {role: r.metrics() for role, r in roles.items()}
            results["long-m"] = pair_request(roles, "long-m", long_p)
            telemetry["long-m"] = (before, {role: r.metrics() for role, r in roles.items()})
            # A decode failure armed live: the raise leaves the bundle
            # unacked, prefill re-queues it, and the redelivery is served.
            dec = roles["decode"]
            code, text = dec.http("/debug/faults",
                                  {"arm": {"disagg.decode.process": "fail_n_times:1"}})
            check(code == 200 and json.loads(text)["armed"] == {
                "disagg.decode.process": "fail_n_times:1"}, f"POST /debug/faults: {code} {text}")
            results["fault"] = pair_request(roles, "fault", short_p)
            code, text = dec.http("/debug/faults")
            check(code == 200 and json.loads(text)["trips"] == {"disagg.decode.process": 1},
                  f"GET /debug/faults after the fault fired: {code} {text}")
            check_journey(dec, "fault", {"kv.deserialize", "kv.reshard", "serve.decode_dispatch"})
            # A poison bundle (more rows than the decode role's max_len)
            # ends its request errored, its journey kept so; the next one
            # is served.
            poison_p = np.random.default_rng(16).integers(
                1, pair_cfg.vocab_size, PAIR_POISON_LEN).astype(np.int32)
            poison_meta, _ = pair_request(roles, "poison", poison_p, expect_failed=True)
            check("max_len" in poison_meta["failed"],
                  f"tp disagg pair poison: failed {poison_meta['failed']!r}")
            check_journey(dec, "poison", set(), outcome="errored")
            results["after-poison"] = pair_request(roles, "after-poison", short_p)
            check_journey(dec, "long-m", {"kv.deserialize", "kv.reshard", "serve.decode_dispatch"})
            check_journey(roles["prefill"], "long-m", {"serve.prefill", "kv.gather"})
            code, text = dec.http("/debug/profile?format=collapsed")
            check(code == 200 and text.strip(), f"the decode role's collapsed profile: {code}")
            telemetry["profile_stacks"] = len(text.splitlines())
            for r in roles.values():
                for path in ("/debug/history", "/debug/flightrecorder", "/debug/faults"):
                    code, _ = r.http(path)
                    check(code == 200, f"the {r.role} role's {path} answered {code}")
            telemetry["compiles-prefill-b"] = check_compile_journeys(roles["prefill"], t_requests)
            telemetry["compiles-decode"] = check_compile_journeys(dec, t_requests)
            check_card_gauges(torch, dec, cards["decode"])
            telemetry["decode"] = dec.metrics()
            launches["prefill-b"] = roles["prefill"].stop(http_drain=True)
            launches["decode"] = roles["decode"].stop()
            logs = {name: open(os.path.join(log_dir, name)).read() for name in os.listdir(log_dir)}
        finally:
            for r in roles.values():
                if r.proc.poll() is None:
                    r.proc.kill()
            api.close()
    wait_until(lambda: not any(pid_alive(p) for p in followers), timeout=60.0)
    check(not [p for p in followers if pid_alive(p)],
          f"tp disagg pair: processes {[p for p in followers if pid_alive(p)]} outlived the drain")
    check(tp == 1 or len(followers) >= 2 * (tp - 1),
          f"tp disagg pair: {len(followers)} spawned processes for tp={tp}")
    # Client and server ledgers of the load runner's requests.
    outs = run.outcomes
    check(len(outs) == PAIR_REQUESTS and all(o.completed and not o.failed for o in outs),
          f"tp disagg pair: {sum(o.completed and not o.failed for o in outs)} of "
          f"{PAIR_REQUESTS} load-runner requests completed")
    for role, log in (("prefill", logs["prefill-a.log"]), ("decode", logs["decode-a.log"])):
        n = sum(1 for ln in log.splitlines() if ln.startswith(f"[{role}] HANDOFF lr-"))
        check(n == PAIR_REQUESTS, f"tp disagg pair: the {role} role handed off {n} of "
                                  f"{PAIR_REQUESTS} load-runner requests")
    check_pair_telemetry(refs, telemetry, logs, tp)
    # Bundles and tokens against path 12's one-card handoffs.
    model_box: dict = {}
    verdicts = {}
    for rid, (S, chunk) in (("long-s", (1000, CHUNK)), ("short", (100, 0)),
                            ("long-m", (1000, 0)), ("fault", (100, 0)),
                            ("after-poison", (100, 0))):
        meta, toks = results[rid]
        ref, h = refs[(S, chunk)], meta["handoff"]
        check(h["bundle_bytes"] == ref["stats"]["bundle_bytes"],
              f"tp disagg pair {rid}: bundle {h['bundle_bytes']} B, one card "
              f"{ref['stats']['bundle_bytes']} B")
        check(h["tp_gathered"] is True and bool(h.get("streamed")) == bool(chunk)
              and h["pos"] == S and "reshard_s" in h,
              f"tp disagg pair {rid}: handoff record {h}")
        names = {sp["name"] for sp in meta["spans"]}
        check({"kv.gather", "kv.reshard", "serve.decode_dispatch"} <= names,
              f"tp disagg pair {rid}: spans {sorted(names)}")
        verdicts[rid] = check_pair_stream(torch, dev, toks, ref, f"tp disagg pair {rid}",
                                          model_box)
        ttft = (h["wire_s"] if chunk else h["prefill_s"] + h["gather_s"] + h["wire_s"]) \
            + h["deserialize_s"] + h["reshard_s"]
        print(f"tp disagg pair tp={tp} {rid} ({S} tokens, "
              f"{'streamed' if chunk else 'monolithic'}): TTFT across the handoff "
              f"{ttft * 1e3:.1f} ms (prefill {h['prefill_s'] * 1e3:.1f} ms = "
              f"{S / h['prefill_s']:.0f} prompt tok/s on the prefill role, gather "
              f"{h['gather_s'] * 1e3:.1f} ms, wire {h['wire_s'] * 1e3:.1f} ms, deserialize "
              f"{h['deserialize_s'] * 1e3:.1f} ms, reshard {h['reshard_s'] * 1e3:.1f} ms); "
              f"decode role {HANDOFF_STEPS / h['decode_s']:.1f} tok/s; bundle "
              f"{h['bundle_bytes'] / 1e6:.2f} MB; tokens vs one card: {verdicts[rid]}")
    # Each role's launches, as its rank 0 printed them at exit.
    lg = [len(r.prompt) for r in schedule]
    mono = lambda S: {"flash_attention": L, "int8_matmul": 7 * L * (S <= 256) + 1}  # noqa: E731
    streamed_1000 = 7 * L * -(-1000 // CHUNK) + 1
    want = {"prefill-a": {"flash_attention": 0, "int8_matmul": 2 * streamed_1000},
            "prefill-b": {k: 2 * (v + mono(100)[k]) + mono(PAIR_POISON_LEN)[k]
                          for k, v in mono(1000).items()},
            "decode": {"int8_matmul": (7 * L + 1) * HANDOFF_STEPS * (8 + PAIR_REQUESTS)}}
    for S in [100, 100] + lg:
        for k, v in mono(S).items():
            want["prefill-a"][k] += v
    total = {name: 0 for name in kernel_counters()}
    for role, got in launches.items():
        check_launches(f"tp disagg pair {role}", got, want[role])
        for k, v in got.items():
            total[k] += v
    print(f"tp disagg pair tp={tp} ({'prefill on cards ' + cards['prefill'] + ', decode on '
                                       + cards['decode'] if split else 'both roles on card 0'}):"
          f" {PAIR_REQUESTS} load-runner requests of shared_prefix completed on the client and "
          f"both roles' logs; p50 TTFT {statistics.median(o.ttft_s for o in outs) * 1e3:.1f} ms "
          f"(the client's proxy: the prefill leg); roles ready {t_ready:.1f} s after launch; "
          f"the prefill role drained by POST /debug/drain (twice) and the decode role by "
          f"SIGTERM (exit 0), and {len(followers)} spawned processes; path "
          f"wall time {time.perf_counter() - t_path:.1f} s")
    if profile_nccl and split:
        p = disagg_decode_profile(tp, cards["decode"], long_p)
        print(f"tp disagg pair tp={tp} decode role profile: {HANDOFF_STEPS} decode steps (B=1) "
              f"wall {p['wall_ms']:.2f} ms ({p['wall_ms'] / HANDOFF_STEPS:.2f} ms/step), device "
              f"busy {p['busy_ms']:.2f} ms, NCCL {p['nccl_ms']:.3f} ms = "
              f"{p['nccl_ms'] / p['busy_ms']:.1%} of device time, "
              f"{p['nccl_ms'] / p['wall_ms']:.1%} of wall")
    return total


# ---------------------------------------------------------------------------
# Path 17: the deployed pair. The port's control plane (`python -m
# lws_tpu_torch serve`, backend local) deploys a DisaggregatedSet of the
# port's workers; the path finds them through its API server, serves the
# pair, kills the decode process and holds the group-atomic restart.

DEPLOY_NAME = "deployed"  # the DisaggregatedSet's name
DEPLOY_READY_S = 600.0  # serve's start and both roles': imports, the card, the full flagship
DEPLOY_EXIT_S = 60.0  # every worker's exit after the DS is deleted
PID_ANNOTATION = "local.lws.tpu/pid"  # lws_tpu_torch/runtime/local.py:PID_ANNOTATION_KEY


def deploy_manifests(api_url: str, ports: dict, auth: "ServeAuth") -> tuple[str, dict]:
    """The Configuration (backend local, no scheduler) and the
    DisaggregatedSet, in the shape of examples/disaggregated-live-demo.yaml
    with the port's workers: each role an LWS of size 1, 1 replica, the
    default RecreateGroupOnPodRestart, its KV port and its telemetry port
    (LWS_TPU_METRICS_PORT, which the fleet collector reads off the pod
    spec) in the template. Every journey is kept (LWS_TPU_JOURNEY_SAMPLE=1)
    and the decode role is profiled (LWS_TPU_PROFILE_HZ). The workers read
    the https API server (`api_url`) with the view token (LWS_TPU_TOKEN)
    and trust serve's CA through OpenSSL's SSL_CERT_FILE."""
    config = ("apiVersion: config.lws.tpu/v1alpha1\nkind: Configuration\n"
              "backend: local\nenableScheduler: false\n")

    def role(name: str) -> dict:
        env = [{"name": "LWS_TPU_MODEL", "value": PAIR_MODEL},
               {"name": "LWS_TPU_KV_PORT", "value": str(ports[name])},
               {"name": "LWS_TPU_METRICS_PORT", "value": str(ports[f"{name}-metrics"])},
               {"name": "LWS_TPU_JOURNEY_SAMPLE", "value": "1"},
               {"name": "LWS_TPU_API", "value": api_url},
               {"name": "LWS_TPU_TOKEN", "value": auth.tokens["view"]},
               {"name": "SSL_CERT_FILE", "value": auth.ca}]
        if name == "prefill":
            env.append({"name": "LWS_TPU_KV_CHUNK", "value": str(CHUNK)})
        else:
            env.append({"name": "LWS_TPU_PROFILE_HZ", "value": str(PAIR_PROFILE_HZ)})
        command = [sys.executable, "-m", "lws_tpu_torch.serving.disagg_worker", name,
                   "--steps", str(HANDOFF_STEPS), "--max-len", str(MAX_LEN),
                   "--device", PAIR_DEVICE]
        return {"name": name, "replicas": 1, "template": {"spec": {"leaderWorkerTemplate": {
            "size": 1, "workerTemplate": {"spec": {"containers": [
                {"name": name, "command": command, "env": env}]}}}}}}

    ds = {"apiVersion": "lws.tpu/v1", "kind": "DisaggregatedSet",
          "metadata": {"name": DEPLOY_NAME},
          "spec": {"roles": [role("prefill"), role("decode")]}}
    return config, ds


class ServeAuth:
    """What path 17's `serve` runs with besides its manifests: the state
    directory (snapshot + write-ahead log), the token file (one admin and
    one view token from the port's write_bootstrap_tokens) and the TLS
    directory, whose CA serve's CertManager writes on its start."""

    def __init__(self, work_dir: str) -> None:
        from lws_tpu_torch.core.auth import write_bootstrap_tokens

        self.state_dir = os.path.join(work_dir, "state")
        self.token_file = os.path.join(work_dir, "tokens.csv")
        self.tls_dir = os.path.join(work_dir, "tls")
        self.ca = os.path.join(self.tls_dir, "ca.crt")
        self.tokens = write_bootstrap_tokens(self.token_file)

    def flags(self) -> list:
        return ["--state-dir", self.state_dir, "--token-file", self.token_file,
                "--tls-dir", self.tls_dir]


class ServeProcess:
    """`python -m lws_tpu_torch serve --config ... [-f ...] --port P
    --state-dir ... --token-file ... --tls-dir ... [--standby]` as a process
    of its own, its output in `<name>.log`; the commands of the same CLI as
    processes against it, over https with the CA and the admin token."""

    def __init__(self, work_dir: str, port: int, config: str, manifests: list,
                 auth: ServeAuth, name: str = "serve", standby: bool = False) -> None:
        self.repo = os.path.dirname(os.path.abspath(__file__))
        self.port = port
        self.auth = auth
        cfg = os.path.join(work_dir, f"{name}-config.yaml")
        with open(cfg, "w") as f:
            f.write(config)
        argv = ["--config", cfg]
        if manifests:
            mf = os.path.join(work_dir, f"{name}-deploy.yaml")
            with open(mf, "w") as f:
                # JSON documents, one per line: each is a YAML document too.
                f.write("\n---\n".join(json.dumps(m) for m in manifests) + "\n")
            argv += ["-f", mf]
        # The decision plane records every verdict but moves nothing: a
        # role declaring its KV and telemetry ports in its template cannot
        # run two replicas on one host, so the pair's roles are not scaled
        # on the card (the autoscaler is driven on a port-free LWS). The
        # CLI's commands read the admin token from LWS_TPU_TOKEN (the pods
        # inherit it; their templates give them the view token instead).
        self.env = dict(os.environ, LWS_TPU_ACTUATION_DISABLE="scale,rollout",
                        LWS_TPU_TOKEN=auth.tokens["admin"],
                        PYTHONPATH=self.repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.log_path = os.path.join(work_dir, f"{name}.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "lws_tpu_torch", "serve", *argv, "--port", str(port),
             *auth.flags(), *(["--standby"] if standby else [])],
            env=self.env, cwd=self.repo, stdout=self._log, stderr=subprocess.STDOUT)
        API_AUTH[port] = (auth.ca, auth.tokens["admin"])

    def serving(self) -> bool:
        """The API server is up: serve printed its https address."""
        return f"serving on https://127.0.0.1:{self.port} " in self.log()

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def alive(self) -> None:
        check(self.proc.poll() is None,
              f"the serve process exited {self.proc.returncode}:\n{self.log()[-3000:]}")

    def pod_log_dir(self) -> str:
        line = next((ln for ln in self.log().splitlines() if ln.startswith("pod logs under ")),
                    None)
        check(line is not None, f"serve printed no log dir:\n{self.log()[-3000:]}")
        return line[len("pod logs under "):].strip()

    def cli(self, *argv: str, server: Optional[str] = None) -> subprocess.CompletedProcess:
        """A command of the same CLI as a process, against this API server
        (or `server`)."""
        return subprocess.run(
            [sys.executable, "-m", "lws_tpu_torch", "--cacert", self.auth.ca, *argv, "--server",
             server or f"https://127.0.0.1:{self.port}"],
            env=self.env, cwd=self.repo, capture_output=True, text=True, timeout=120)

    def stop(self) -> int:
        """SIGINT, as a user stops it; its exit code."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode


def holds_the_card(pid: int) -> bool:
    """A process with a CUDA context has the card's device nodes open."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def nvidia_smi_pids() -> list[int]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi --query-compute-apps: {out.stderr}")
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def deployed_pods(client, role: Optional[str] = None) -> list[dict]:
    from lws_tpu_torch.serving import kv_transport as kt

    try:
        pods = client.list("Pod")
    except OSError:
        return []
    return [p for p in pods
            if p["metadata"]["labels"].get(kt.DS_NAME_LABEL_KEY) == DEPLOY_NAME
            and (role is None or p["metadata"]["labels"].get(kt.DS_ROLE_LABEL_KEY) == role)]


def deployed_request(eps: dict, rid: str, prompt, serve: ServeProcess, deadline: float,
                     submit: bool = True) -> tuple:
    """One prompt through the deployed pair: submitted to prefill (with
    retries while its port comes up), its result polled from decode (with
    retries while decode is away). Returns (the result's meta, its tokens)."""
    from lws_tpu_torch.serving import kv_transport as kt

    while submit:
        serve.alive()
        try:
            kt.submit_prompt(eps["prefill"], rid, kt.arrays_to_bytes(prompt=prompt))
            break
        except OSError:
            check(time.monotonic() < deadline, f"deployed pair {rid}: prefill never took it")
            time.sleep(0.2)
    while time.monotonic() < deadline:
        serve.alive()
        try:
            got = kt.pull_result(eps["decode"], rid)
        except OSError:
            got = None
        if got is not None:
            meta, payload = got
            check("failed" not in meta, f"deployed pair {rid}: failed {meta.get('failed')!r}")
            return meta, kt.bytes_to_arrays(payload)["tokens"]
        time.sleep(0.05)
    check(False, f"deployed pair {rid}: no result by the deadline\n{serve.log()[-3000:]}")


def launch_line(log: str, role: str) -> dict:
    lines = [ln for ln in log.splitlines() if ln.startswith(f"[{role}] kernel launches ")]
    check(len(lines) == 1, f"deployed pair: the {role} worker printed {len(lines)} launch lines")
    return json.loads(lines[0].split(" kernel launches ", 1)[1])


AUTOSCALE_LWS = "sleeper"  # the port-free LWS the autoscaler scales on the card
AUTOSCALE_STEPS = 40  # metric reports allowed for one scale move


def check_fleet_view(api_port: int, pods: dict, metrics_ports: dict) -> dict:
    """The API server's /metrics/fleet at a quiet moment: it parses, and it
    carries both roles' pods (instance, role and revision labels) and the
    control plane; each role's transfer bytes and request counters summed
    over its instance equal what the worker's own /metrics says. Returns
    the compared sums."""
    from lws_tpu_torch.core import metrics as metricsmod
    from lws_tpu_torch.serving import kv_transport as kt

    code, text = http_call(api_port, "/metrics/fleet")
    check(code == 200, f"deployed pair: /metrics/fleet answered {code}")
    fams = metricsmod.parse_exposition(text)
    instances = {labels.get("instance") for fam in fams.values()
                 for _, labels, _, _ in fam["samples"]}
    want = {p["metadata"]["name"] for p in pods.values()} | {"control-plane"}
    check(want <= instances, f"deployed pair: /metrics/fleet instances {sorted(instances)}, "
                             f"want {sorted(want)}")
    compared = {}
    counters = {"prefill": ("serving_kv_transfer_bytes_total", "serving_kv_handoffs_total",
                            "serving_ttft_seconds_count"),
                "decode": ("serving_kv_transfer_bytes_total", "serving_itl_seconds_count",
                           "serving_tokens_total")}
    for role, pod in pods.items():
        name = pod["metadata"]["name"]
        revision = pod["metadata"]["labels"][kt.DS_REVISION_LABEL_KEY]
        mine = [labels for fam in fams.values() for _, labels, _, _ in fam["samples"]
                if labels.get("instance") == name]
        check(mine and all(lb.get("role") == role and lb.get("revision") == revision
                           for lb in mine),
              f"deployed pair: /metrics/fleet series of {name} lack role={role} "
              f"revision={revision}")
        own = worker_metrics(metrics_ports[role], role)
        for sample in counters[role]:
            family = sample[:-len("_count")] if sample.endswith("_count") else sample
            fleet_sum = metric_sum(fams, family, sample, instance=name)
            own_sum = metric_sum(own, family, sample)
            check(own_sum > 0 and fleet_sum == own_sum,
                  f"deployed pair: {sample} of {name}: /metrics/fleet {fleet_sum}, its own "
                  f"/metrics {own_sum}")
            compared[f"{role}/{sample}"] = own_sum
    return compared


def read_commands(serve, api_port: int, pods: dict, metrics_ports: dict, rid: str) -> dict:
    """The read commands as processes against the API server: `top` has a
    row per role; `devices` folds both workers' compile ledgers; `profile
    --fleet` shows both instances, the decode role sampled; `explain <rid>`
    renders one connected tree joining the prefill legs (serve.prefill,
    kv.gather) and the decode legs (kv.deserialize, serve.decode_dispatch)
    of two processes; `monitor` and `rollout` answer; `why <id>` renders a
    record that the fleet ingest's decision step wrote for a pair role.
    Returns facts for the path's line."""
    names = {role: p["metadata"]["name"] for role, p in pods.items()}

    def run(*argv: str) -> str:
        out = serve.cli(*argv)
        check(out.returncode == 0 and out.stdout.strip(),
              f"`{' '.join(argv)}` exited {out.returncode}: {out.stdout[-1500:]} "
              f"{out.stderr[-1500:]}")
        return out.stdout

    facts: dict = {}
    top = run("top")
    check(all(any(ln.startswith(n) for ln in top.splitlines()) for n in names.values()),
          f"top: no row for each of {sorted(names.values())}:\n{top}")
    fold = json.loads(run("devices", "--json"))
    folded = {(e.get("labels") or {}).get("instance") for e in fold["instances"]}
    check(set(names.values()) <= folded, f"devices: instances {sorted(folded)}")
    facts["compile_records"] = {
        (e.get("labels") or {}).get("instance"): len((e.get("compile") or {}).get("records", []))
        for e in fold["instances"]}
    check(f"instances={len(fold['instances'])}" in run("devices").splitlines()[0],
          "devices: header")
    code, text = http_call(api_port, "/debug/profile/fleet")
    check(code == 200, f"/debug/profile/fleet answered {code}")
    profiles = {e["labels"].get("instance"): e["profile"] for e in json.loads(text)["instances"]}
    check(set(names.values()) <= set(profiles), f"profile --fleet: instances {sorted(profiles)}")
    dec = profiles[names["decode"]]
    check(dec.get("enabled") and dec.get("samples", 0) > 0,
          f"profile --fleet: the decode role was not sampled ({dec.get('samples')} samples)")
    prof = run("profile", "--fleet")
    check(f"instances={len(profiles)}" in prof.splitlines()[0]
          and any(ln.startswith(names["decode"]) for ln in prof.splitlines()),
          f"profile --fleet:\n{prof[:2000]}")
    facts["decode_samples"] = dec["samples"]
    code, text = http_call(api_port, f"/debug/request/{rid}")
    check(code == 200, f"/debug/request/{rid} answered {code} {text[:300]}")
    joined = json.loads(text)
    by_instance: dict = {}
    for sp in joined["spans"]:
        by_instance.setdefault(sp["instance"], set()).add(sp["name"])
    check({"serve.prefill", "kv.gather"} <= by_instance.get(names["prefill"], set())
          and {"kv.deserialize", "serve.decode_dispatch"} <= by_instance.get(
              names["decode"], set()) and joined["connected"],
          f"explain {rid}: connected {joined['connected']}, spans by instance {by_instance}; "
          f"the workers' own legs: " + str({role: sorted(
              {sp["name"] for sp in json.loads(http_call(port, f"/debug/request/{rid}")[1])
               .get("spans", [])}) for role, port in metrics_ports.items()}))
    explained = run("explain", rid)
    check(explained.splitlines()[0].endswith("connected")
          and all(n in explained for n in ("serve.prefill", "kv.gather", "kv.deserialize",
                                           "serve.decode_dispatch")), f"explain {rid}:\n"
          f"{explained[:3000]}")
    facts["explain_spans"] = {k: len(v) for k, v in by_instance.items()}
    run("monitor")
    facts["rollout"] = len(json.loads(run("rollout", "--json"))["timeline"])
    check(facts["rollout"] > 0, "rollout: the ledger recorded no transition of the deployment")
    code, text = http_call(api_port, "/debug/decisions")
    check(code == 200, f"/debug/decisions answered {code}")
    decided = [r for r in json.loads(text)
               if r.get("plane") == "scale" and r.get("subject") in names]
    check(decided, f"why: no scale decision for a pair role among {text[:1500]}")
    record = decided[-1]
    why = run("why", record["id"])
    check(record["id"] in why, f"why {record['id']}:\n{why[:2000]}")
    facts["decision"] = (record["id"], record["subject"], record["verdict"],
                         (record.get("actuation") or {}).get("outcome"))
    return facts


def autoscale_loop(serve, client, work_dir: str) -> dict:
    """The Autoscaler over a port-free LWS in the same `serve`: a leader's
    reported `inflight` of 4.0 (target 2.0) scales it 1 -> 2; reports of
    1.0 scale it back to 1 after its stabilization (two fresh below-target
    observations). At each step the LWS's replicas, the Scaled events and
    the live processes of its pods are checked; then the Autoscaler and the
    LWS are deleted and every process of theirs ends. Returns the seconds
    of each move."""
    from lws_tpu_torch.api import contract

    lws = {"apiVersion": "lws.tpu/v1", "kind": "LeaderWorkerSet",
           "metadata": {"name": AUTOSCALE_LWS},
           "spec": {"replicas": 1, "leaderWorkerTemplate": {"size": 1, "workerTemplate": {
               "spec": {"containers": [{"name": "w", "command": [
                   sys.executable, "-c", "import time; time.sleep(3600)"]}]}}}}}
    asc = {"apiVersion": "lws.tpu/v1", "kind": "Autoscaler",
           "metadata": {"name": f"{AUTOSCALE_LWS}-scale"},
           "spec": {"target": AUTOSCALE_LWS, "minReplicas": 1, "maxReplicas": 2,
                    "metric": "inflight", "targetValue": 2.0, "scaleDownStabilization": 2}}
    path = os.path.join(work_dir, "autoscale.yaml")
    with open(path, "w") as f:
        f.write("\n---\n".join(json.dumps(m) for m in (lws, asc)) + "\n")
    out = serve.cli("apply", "-f", path)
    check(out.returncode == 0 and json.loads(out.stdout) == {"applied": [
        f"LeaderWorkerSet/{AUTOSCALE_LWS}", f"Autoscaler/{AUTOSCALE_LWS}-scale"]},
        f"apply the autoscaler: {out.returncode} {out.stdout} {out.stderr}")

    def leaders() -> list:
        pods = [p for p in client.list("Pod")
                if p["metadata"]["labels"].get(contract.SET_NAME_LABEL_KEY) == AUTOSCALE_LWS]
        return sorted((p for p in pods if (p.get("status") or {}).get("ready")
                       and PID_ANNOTATION in p["metadata"]["annotations"]),
                      key=lambda p: p["metadata"]["name"])

    def settle(n: int, what: str) -> list:
        deadline = time.monotonic() + 60.0
        while True:
            serve.alive()
            got = client.get("LeaderWorkerSet", "default", AUTOSCALE_LWS)["spec"]["replicas"]
            ready = leaders()
            pids = [int(p["metadata"]["annotations"][PID_ANNOTATION]) for p in ready]
            if got == n and len(ready) == n and all(pid_alive(p) for p in pids):
                return pids
            check(time.monotonic() < deadline, f"autoscaler {what}: replicas {got}, ready "
                                               f"pods {[p['metadata']['name'] for p in ready]}")
            time.sleep(0.2)

    def scaled_events() -> list:
        code, text = http_call(serve.port, f"/events?name={AUTOSCALE_LWS}-scale")
        check(code == 200, f"autoscaler events: {code}")
        return [e["message"] for e in json.loads(text) if e["reason"] == "Scaled"]

    def drive(value: float, n: int, what: str) -> float:
        t0 = time.perf_counter()
        for step in range(AUTOSCALE_STEPS):
            serve.alive()
            if client.get("LeaderWorkerSet", "default", AUTOSCALE_LWS)["spec"]["replicas"] == n:
                return time.perf_counter() - t0
            pods = leaders()
            client.report_metric("default", pods[step % len(pods)]["metadata"]["name"],
                                 {"inflight": value})
            time.sleep(0.5)
        check(False, f"autoscaler {what}: no move after {AUTOSCALE_STEPS} reports")

    pids1 = settle(1, "start")
    t_up = drive(4.0, 2, "1 -> 2")
    pids2 = settle(2, "1 -> 2")
    check(set(pids1) < set(pids2), f"autoscaler 1 -> 2: pids {pids1} -> {pids2}")
    check(scaled_events() == [f"scaled {AUTOSCALE_LWS} from 1 to 2 replicas"],
          f"autoscaler 1 -> 2: events {scaled_events()}")
    t_down = drive(1.0, 1, "2 -> 1")
    pids3 = settle(1, "2 -> 1")
    check(wait_until(lambda: sum(pid_alive(p) for p in pids2) == 1, timeout=30.0),
          f"autoscaler 2 -> 1: live processes {[p for p in pids2 if pid_alive(p)]}")
    check(scaled_events() == [f"scaled {AUTOSCALE_LWS} from 1 to 2 replicas",
                              f"scaled {AUTOSCALE_LWS} from 2 to 1 replicas"],
          f"autoscaler 2 -> 1: events {scaled_events()}")
    for kind, name in (("Autoscaler", f"{AUTOSCALE_LWS}-scale"),
                       ("LeaderWorkerSet", AUTOSCALE_LWS)):
        out = serve.cli("delete", kind, "default", name)
        check(out.returncode == 0, f"delete {kind} {name}: {out.stdout} {out.stderr}")
    check(wait_until(lambda: not any(pid_alive(p) for p in pids2 + pids3), timeout=30.0),
          "autoscaler: processes of the deleted LWS live on")
    return {"up_s": t_up, "down_s": t_down}


FAILOVER_S = 60.0  # kill -9 of the active serve to the standby's /readyz answering 200
ROUTE_CALLS = 40  # calls a route is timed over at the drill's quiet moment
INFORMER_KINDS = ("LeaderWorkerSet", "DisaggregatedSet", "Pod")
INFORMER_S = 30.0  # the Informer's cache to equal the store (quiet moment, write, takeover)
INFORMER_POLL_S = 2.0  # the Informer's /watch long-poll
INFORMER_NOTE = "chip-smoke.lws.tpu/informer"  # the annotation path 17 writes on the DS


def start_informer(api_url: str, auth: ServeAuth):
    """lws_tpu_torch.client.Informer over its own RemoteClient (https, the
    CA, the admin token) on INFORMER_KINDS, started: its first relist fills
    the cache, and its thread long-polls /watch. Every relist is recorded
    as (the time, the bookmark before it, the bookmark after it): a relist
    after the first follows an `expired` answer. So is the time each sync
    (one answered /watch) returns."""
    from lws_tpu_torch.client import Informer, RemoteClient

    class Recording(Informer):
        def relist(self) -> None:
            before = self._seq
            super().relist()
            self.relists.append((time.perf_counter(), before, self._seq))

        def sync(self, timeout: float = 0.0) -> int:
            applied = super().sync(timeout)
            self.synced.append(time.perf_counter())
            return applied

    informer = Recording(RemoteClient(api_url, ca_cert=auth.ca, token=auth.tokens["admin"]),
                         kinds=INFORMER_KINDS)
    informer.relists, informer.synced = [], []
    informer.start(poll_timeout=INFORMER_POLL_S)
    return informer


def informer_converges(informer, client, what: str, timeout: float = INFORMER_S) -> tuple:
    """Waits until the Informer's cache equals the store: a list of each of
    its kinds, read just before and just after one read of the cache, by
    (kind, namespace, name) -> (uid, resourceVersion), all three equal.
    Returns (the seconds it took, the objects compared)."""
    def listed() -> dict:
        return {(m["kind"], m["metadata"]["namespace"], m["metadata"]["name"]):
                (m["metadata"]["uid"], m["metadata"]["resourceVersion"])
                for kind in INFORMER_KINDS for m in client.list(kind)}

    def cached() -> dict:
        with informer._lock:
            return {k: (m["metadata"]["uid"], m["metadata"]["resourceVersion"])
                    for k, m in informer.cache.items()}

    t0 = time.perf_counter()
    while True:
        a, c, b = listed(), cached(), listed()
        if a == b == c:
            return time.perf_counter() - t0, len(c)
        check(time.perf_counter() - t0 < timeout, f"{what}: the Informer's cache never equalled "
              f"the store in {timeout:.0f} s: only cached {sorted(set(c.items()) - set(b.items()))}"
              f", only listed {sorted(set(b.items()) - set(c.items()))}")
        time.sleep(0.05)


def informer_sees_a_write(informer, client) -> dict:
    """One write through the client's server-side apply (an annotation on
    the DisaggregatedSet, field manager chip-smoke; the roles' revision
    does not read annotations, so nothing rolls): the Informer's cache
    holds the written resourceVersion, and then equals the store. Returns
    the seconds of each step and the written resourceVersion."""
    t0 = time.perf_counter()
    applied = client.server_side_apply("DisaggregatedSet", "default", DEPLOY_NAME,
                                       {"meta": {"annotations": {INFORMER_NOTE: "1"}}},
                                       field_manager="chip-smoke")
    rv = int(applied["metadata"]["resourceVersion"])
    check(applied["metadata"]["annotations"].get(INFORMER_NOTE) == "1",
          f"server-side apply: {applied['metadata']}")
    t_write = time.perf_counter()

    def seen() -> bool:
        got = informer.get("DisaggregatedSet", "default", DEPLOY_NAME)
        return bool(got) and int(got["metadata"]["resourceVersion"]) >= rv \
            and got["metadata"]["annotations"].get(INFORMER_NOTE) == "1"

    check(wait_until(seen, timeout=INFORMER_S),
          f"the Informer never saw the write (resourceVersion {rv})")
    t_seen = time.perf_counter()
    equal_s, n = informer_converges(informer, client, "after the write")
    return {"apply_s": t_write - t0, "seen_s": t_seen - t_write, "equal_s": equal_s,
            "resource_version": rv, "objects": n}


def traced_request(eps: dict, rid: str, prompt, serve, deadline: float, api_port: int,
                   work_dir: str) -> tuple:
    """One deployed request as one span tree, as tests/test_e2e_disagg.py
    assembles it: the DisaggregatedSet's latest `reconcile` root span, read
    from serve's /debug/traces; a client `serve.request` span grafted onto
    it, in which the prompt is submitted (its context rides the frame); the
    workers' subtrees that rode back with the result. The tree goes through
    Tracer.record, export_jsonl and read_jsonl, and what is read back must
    be the tree and connected. Returns (the request's (meta, tokens), facts)."""
    from lws_tpu_torch.core import trace

    code, text = http_call(api_port, "/debug/traces?limit=4096")
    check(code == 200, f"/debug/traces answered {code}")
    reconciles = [s for s in json.loads(text) if s["name"] == "reconcile"
                  and s["attrs"].get("controller") == "disaggregatedset"
                  and s["attrs"].get("object") == DEPLOY_NAME]
    check(reconciles, "serve's /debug/traces holds no reconcile of the DisaggregatedSet")
    root = reconciles[-1]
    request_span = trace.TRACER.span("serve.request", parent={
        "trace_id": root["trace_id"], "span_id": root["span_id"]}, role="client",
        request_id=rid)
    with request_span:
        out = deployed_request(eps, rid, prompt, serve, deadline)
    tree = [root, request_span.to_dict()] + list(out[0].get("spans") or [])
    names = {s["name"] for s in tree}
    want = {"reconcile", "serve.request", "serve.prefill", "kv.gather", "kv.deserialize",
            "kv.reshard", "serve.decode_dispatch"}
    check(want <= names and trace.connected_tree(tree),
          f"{rid}: the span tree is not one connected tree of {sorted(want)}: " + str(
              [(s["name"], s["trace_id"], s["parent_id"]) for s in tree]))
    collector = trace.Tracer(enabled=True)
    for s in tree:
        collector.record(s)
    path = os.path.join(work_dir, "request_trace.jsonl")
    n = collector.export_jsonl(path)
    back = trace.Tracer.read_jsonl(path)
    check(n == len(tree) and back == json.loads(json.dumps(tree)) and trace.connected_tree(back),
          f"{rid}: the span tree did not survive the JSONL round trip ({n} of {len(tree)})")
    order = [s["name"] for s in trace.walk(back, root["span_id"])]
    check(len(order) == len(tree) and order[0] == "reconcile",
          f"{rid}: walk from the reconcile visits {order}")
    return out, {"spans": len(tree), "jsonl_bytes": os.path.getsize(path)}


def store_clone(log: str, who: str) -> str:
    """The clone the store of a `serve` process used, from its start line
    (`store clone: native (<library>)`), which must be the only one and name
    the native clone built from the checkout's csrc/fastclone.c."""
    lines = [ln for ln in log.splitlines() if ln.startswith("store clone: ")]
    check(len(lines) == 1, f"{who} printed {len(lines)} store clone lines: {lines}")
    check(lines[0].startswith("store clone: native (") and "/lws_tpu_torch/_build/_fastclone-"
          in lines[0], f"{who}: {lines[0]}")
    return lines[0][len("store clone: "):]


def check_api_auth(api_port: int, auth: ServeAuth, ds: dict) -> dict:
    """serve's token auth over https: without a token (or with a wrong one)
    /apis/... answers 401 while /healthz answers 200; the view token reads
    and may not write (403). Returns the codes."""
    view = auth.tokens["view"]
    got = {"GET /apis/pods": http_call(api_port, "/apis/pods", token="")[0],
           "GET /apis/pods wrong token": http_call(api_port, "/apis/pods", token="x")[0],
           "GET /healthz": http_call(api_port, "/healthz", token=""),
           "GET /apis/pods view": http_call(api_port, "/apis/pods", token=view)[0],
           "POST /apply view": http_call(api_port, "/apply", body=ds, token=view)[0]}
    want = {"GET /apis/pods": 401, "GET /apis/pods wrong token": 401,
            "GET /healthz": (200, "ok"), "GET /apis/pods view": 200, "POST /apply view": 403}
    check(got == want, f"deployed pair: serve's auth answered {got}, want {want}")
    return {k: v if isinstance(v, int) else v[0] for k, v in got.items()}


def store_objects(client) -> dict:
    """{kind: sorted (namespace/name, uid)} of every kind the store keeps,
    read through the API server."""
    from lws_tpu_torch.core.serialize import _registry

    out = {}
    for kind in sorted(_registry()):
        objs = client.list(kind)
        if objs:
            out[kind] = sorted((f"{o['metadata']['namespace']}/{o['metadata']['name']}",
                                o["metadata"]["uid"]) for o in objs)
    return out


def listening(pid: int, port: int) -> bool:
    """Whether process `pid` holds a listening TCP socket on `port`."""
    inodes = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            link = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if link.startswith("socket:["):
            inodes.add(link[len("socket:["):-1])
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            fields = row.split()
            if (fields[3] == "0A" and int(fields[1].rsplit(":", 1)[1], 16) == port
                    and fields[9] in inodes):
                return True
    return False


def control_plane_failover(serve, standby, client, informer, eps: dict, ports: dict,
                           metrics_ports: dict, pods: dict, pids: dict, short_p, long_p) -> tuple:
    """Path 17's control-plane drill. At a quiet moment (two equal readings)
    the store's objects (each kind's names and uids) and every pod's pid are
    recorded, with the write-ahead log's records and bytes; the standby
    is alive and not listening. Then the active serve is SIGKILLed:
    - with no control plane, a 100-token request completes through the pair;
    - the standby's /readyz answers 200 within FAILOVER_S (kill-to-takeover),
      and its "restored N objects" line counts the recorded objects;
    - the Informer started before the deploy, which equalled the store at
      the quiet moment, has its first /watch answered by the standby and
      then equals the standby's store within INFORMER_S of its /readyz 200
      (its relists after the kill are counted: the standby's /watch
      sequence starts afresh, and only an `expired` answer makes an
      Informer relist);
    - the standby's store clones with the native clone (store_clone);
    - every pod keeps its uid and its pid (re-adopted, not respawned), no
      new process holds the card, and the standby holds none;
    - a 1,000-token streamed request completes under the new server as one
      span tree (traced_request); the new server's /metrics/fleet carries
      both workers (check_fleet_view), and `get` as a process lists the
      recorded objects of each kind.
    Returns (the drill's facts, {request id: (meta, tokens)})."""
    import signal

    seen: list = []
    deadline = time.monotonic() + 60.0
    while len(seen) < 2 or seen[-1] != seen[-2]:
        serve.alive()
        check(time.monotonic() < deadline, "failover: the store never went quiet")
        seen.append((store_objects(client), {
            p["metadata"]["name"]: (p["metadata"]["uid"],
                                    p["metadata"]["annotations"].get(PID_ANNOTATION))
            for p in client.list("Pod")}))
        time.sleep(0.5)
    objects, pod_pids = seen[-1]
    n_objects = sum(len(v) for v in objects.values())
    quiet_s, n_cached = informer_converges(informer, client, "failover, before the kill")
    bookmark, relists_before = informer._seq, len(informer.relists)
    with open(os.path.join(serve.auth.state_dir, "wal.jsonl"), "rb") as f:
        wal = f.read()
    snapshot_bytes = os.path.getsize(os.path.join(serve.auth.state_dir, "state.json"))
    smi_before = nvidia_smi_pids()
    # What one call costs at this quiet moment: /healthz over https (the TLS
    # handshake, no token check) on the API server and over plain http on
    # the decode worker's telemetry server (the same stdlib server), and
    # /metrics/fleet over https with the admin token.
    routes = {"api /healthz https": (ports["api"], "/healthz", ROUTE_CALLS),
              "worker /healthz http": (metrics_ports["decode"], "/healthz", ROUTE_CALLS),
              "api /metrics/fleet https": (ports["api"], "/metrics/fleet", ROUTE_CALLS // 2)}
    route_ms = {}
    for what, (port, path, calls) in routes.items():
        ms = []
        for _ in range(calls):
            t0 = time.perf_counter()
            code, _ = http_call(port, path)
            ms.append((time.perf_counter() - t0) * 1e3)
            check(code == 200, f"failover: {what} answered {code}")
        route_ms[what] = statistics.median(ms)
    print("control-plane failover, quiet moment: median ms a call " + ", ".join(
        f"{what} {v:.2f} ({routes[what][2]} calls)" for what, v in route_ms.items()), flush=True)
    standby.alive()
    check(not listening(standby.proc.pid, ports["api"]) and "restored " not in standby.log(),
          f"failover: the standby listens or restored before the kill:\n{standby.log()[-2000:]}")

    t_kill = time.perf_counter()
    os.kill(serve.proc.pid, signal.SIGKILL)
    serve.proc.wait(timeout=30)
    taken: dict = {}

    def watch() -> None:
        # Two steps of the takeover, each stamped when first seen (polled
        # every 10 ms): the standby's "restored" line (the lock taken and
        # the snapshot and WAL replayed), then its /readyz 200 (the resync,
        # the backend's re-adoption, TLS and tokens loaded, the port bound).
        while time.perf_counter() - t_kill < FAILOVER_S:
            if "restored" not in taken and "restored " in standby.log():
                taken["restored"] = time.perf_counter() - t_kill
            try:
                if http_call(ports["api"], "/readyz", timeout=2.0) == (200, "ok"):
                    taken["s"] = time.perf_counter() - t_kill
                    taken.setdefault("restored", taken["s"])
                    break
            except OSError:
                pass
            time.sleep(0.01)
        if "s" not in taken:
            return
        # Then the Informer: its first sync the standby answered (any that
        # returns after the standby's restored line: the old server died
        # before it), then its cache against the standby's store. (Before
        # that sync the cache may equal the store only because the restore
        # kept every object as it was.)
        try:
            t_restored = t_kill + taken["restored"]
            check(wait_until(lambda: informer.synced and informer.synced[-1] > t_restored,
                             timeout=INFORMER_S),
                  "failover: the standby answered none of the Informer's /watch polls")
            taken["synced"] = informer.synced[-1] - t_kill
            informer_converges(informer, client, "failover, after the takeover")
            taken["informer"] = time.perf_counter() - t_kill
            taken["seq"] = client.current_seq()
        except (SmokeFailure, OSError) as e:
            taken["informer_error"] = str(e)[:2000]

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    # The data plane needs no control plane: the pair serves meanwhile.
    t0 = time.perf_counter()
    results = {"cp-outage": deployed_request(eps, "cp-outage", short_p, standby,
                                             time.monotonic() + DEPLOY_READY_S)}
    outage_s = time.perf_counter() - t0
    watcher.join(FAILOVER_S + INFORMER_S)
    check("s" in taken, f"failover: the standby's /readyz never answered 200 within "
                        f"{FAILOVER_S:.0f} s of the kill:\n{standby.log()[-3000:]}")
    relists = informer.relists[relists_before:]
    clone = store_clone(standby.log(), "the standby")
    if relists:
        how = (f"by {len(relists)} relist(s) on `expired`: its bookmark {bookmark} from the "
               f"killed server stood ahead of the standby's sequence {relists[0][2]}")
    else:
        # The standby's /watch sequence passed the bookmark before the
        # Informer's first poll, so /watch answered with events instead of
        # `expired`: the Informer replays the new server's events after the
        # bookmark and never sees those up to it. A fault shared with the
        # JAX package (ROADMAP Queue 3; tests/test_torch_client_informer.py::
        # test_a_restarted_server_past_the_bookmark_leaves_both_caches_stale).
        how = (f"with no relist: the standby's sequence had passed the bookmark {bookmark} at "
               "the Informer's first poll (a fault shared with the JAX package, ROADMAP Queue "
               f"3), so the cache could only match by luck (the standby's sequence "
               f"{taken.get('seq', '-')} when it matched)")
    if "informer" in taken:
        converged = (f"equalled the standby's store {taken['informer'] - taken['s']:.3f} s after "
                     f"its /readyz 200 ({taken['informer']:.3f} s after the kill; the standby "
                     f"answered its first /watch {taken['synced']:.3f} s after the kill), {how}")
    else:
        check(not relists, f"failover: the Informer relisted and still differs from the store: "
                           f"{taken.get('informer_error', 'the watcher hung')}")
        # The fault struck: the cache stayed stale. A relist mends it.
        informer.relist()
        mended, _ = informer_converges(informer, client, "failover, after a relist")
        converged = (f"did not equal the standby's store within {INFORMER_S:.0f} s of its "
                     f"/readyz 200, {how} ({taken.get('informer_error')}); a relist by hand "
                     f"made it equal in {mended:.3f} s")
    print(f"control-plane failover, the Informer: its cache equalled the store at the quiet "
          f"moment ({n_cached} objects, {quiet_s:.3f} s), and {converged}; the standby's store "
          f"clone: {clone}", flush=True)
    restored = [ln for ln in standby.log().splitlines() if ln.startswith("restored ")]
    check(len(restored) == 1 and restored[0].startswith(
        f"restored {n_objects} objects from {serve.auth.state_dir} "),
        f"failover: the standby printed {restored}, {n_objects} objects were recorded")
    print(f"control-plane failover: kill-to-takeover {taken['s']:.3f} s (SIGKILL of the active "
          f"serve to the standby's /readyz 200: {taken['restored']:.3f} s to its restored line, "
          f"{taken['s'] - taken['restored']:.3f} s from there to /readyz 200); restored "
          f"{n_objects} objects; at the kill the "
          f"WAL held {wal.count(bytes([10]))} records in {len(wal)} bytes beside a "
          f"{snapshot_bytes}-byte snapshot; the 100-token request during the outage took "
          f"{outage_s:.3f} s", flush=True)

    # The streamed request under the new server, as one span tree grafted
    # onto the standby's own reconcile of the DS (its resync reconciles
    # every object).
    results["cp-long"], traced = traced_request(eps, "cp-long", long_p, standby,
                                                time.monotonic() + DEPLOY_READY_S, ports["api"],
                                                os.path.dirname(standby.log_path))
    got = client.list("Pod")
    after = {p["metadata"]["name"]: (p["metadata"]["uid"],
                                     p["metadata"]["annotations"].get(PID_ANNOTATION))
             for p in got}
    check(after == pod_pids and all((p.get("status") or {}).get("ready") for p in got),
          f"failover: pods {after} after the takeover, {pod_pids} before")
    check(all(pid_alive(pids[r]) for r in ("prefill", "decode-b")),
          "failover: a worker died across the takeover")
    smi_after = nvidia_smi_pids()
    check(len(smi_after) == len(smi_before) and not holds_the_card(standby.proc.pid),
          f"failover: nvidia-smi lists {smi_after} after the takeover, {smi_before} before")
    fleet = check_fleet_view(ports["api"], pods, metrics_ports)
    for kind, names in objects.items():
        out = standby.cli("get", kind)
        listed = sorted(ln.split("\t")[0] for ln in out.stdout.splitlines())
        check(out.returncode == 0 and listed == [n for n, _ in names],
              f"failover: `get {kind}` under the new server listed {listed}: {out.stderr}")
    check(store_objects(client) == objects, "failover: the store's objects changed")
    return ({"kill_to_takeover_s": taken["s"], "kill_to_restored_s": taken["restored"],
             "route_ms": route_ms, "restored": n_objects, "wal_records":
             wal.count(bytes([10])), "wal_bytes": len(wal), "outage_s": outage_s,
             "fleet": fleet, "informer": converged.split(", ", 1)[0],
             "informer_relists": len(relists), "traced": traced}, results)


def path_deployed_pair(torch, dev, refs: dict) -> dict:
    """17. The deployed pair and its fleet plane: `python -m lws_tpu_torch
    serve` (the port's ControlPlane, LocalBackend, fleet collector and
    ApiServer in a process that never touches the card) deploys a
    DisaggregatedSet of the port's full-width workers (LWS_TPU_MODEL=
    flagship: int8 weights, bf16 K/V; prefill streams in chunks of CHUNK),
    each role's template declaring its KV and telemetry ports. Both roles
    are found only through the port's API server (their `-prv` Services
    selecting ready pods, read with lws_tpu_torch.client.RemoteClient).
    The 100-token prompt goes through the pair. Then the decode pod's
    process is SIGKILLed: the pod goes Failed with one container restart
    (read from the API server's /watch), the controller recreates the group
    (a new pod uid), and a 100-token request submitted during the outage
    completes once the new pod is up (its bundle waited unacked on
    prefill). Then the 1,000-token prompt (streamed); the API server's
    /metrics/fleet at that quiet moment (check_fleet_view); the loadgen
    command against the pair with `--server` the API server, /metrics/fleet
    scraped under its load (command_over_deployed); the read commands as
    processes (read_commands); `faults --server <the decode worker's
    telemetry port>` arms a decode failure live, and the 100-token prompt
    after it is redelivered; the Autoscaler over a port-free LWS
    (autoscale_loop). Every request's bundle bytes and tokens equal path
    16's one-card references (tokens may fork only at an argmax near-tie).
    `get Pod`, `get DisaggregatedSet` and `logs` run as processes of the
    same CLI. `serve` keeps a state directory, serves https
    (--tls-dir) and wants bearer tokens (--token-file): every client here
    trusts its CA and carries the admin token, the workers the view token
    (check_api_auth holds the 401 and 403 answers); a `serve --standby` on
    the same directory and port waits from the pair's start, and after the
    autoscaler the active serve is SIGKILLed (control_plane_failover). Then
    `delete DisaggregatedSet` through the new server ends every worker
    within DEPLOY_EXIT_S; the launches the prefill role and the
    replacement decode role print at exit equal the handoff formulas, the
    loadgen command's and the failover's requests included, each worker
    started once; no spawned process outlives the path; the standby stops
    on SIGINT with a final snapshot that holds no DisaggregatedSet. Through
    it all an Informer (lws_tpu_torch.client, over https with the admin
    token) watches the LWSs, the DS and the pods: its cache equals the
    store at the quiet moment after the decode restart, after one
    server-side apply through RemoteClient, and after the standby's
    takeover (informer_converges); the 1,000-token request under the
    standby goes out as one span tree (traced_request); serve and the standby name
    the native store clone (store_clone). Prints deploy-to-ready,
    kill-to-result, kill-to-takeover and the path's seconds. Returns the
    two roles' launches."""
    import signal
    import tempfile

    from lws_tpu_torch import loadgen
    from lws_tpu_torch.client import RemoteClient
    from lws_tpu_torch.models.flagship import flagship_config
    from lws_tpu_torch.serving import kv_transport as kt

    t_path = time.perf_counter()
    L = flagship_config("full" if PAIR_MODEL == "flagship" else "smoke").n_layers
    ports = listen_ports(("api", "prefill", "decode", "prefill-metrics", "decode-metrics"))
    metrics_ports = {r: ports[f"{r}-metrics"] for r in ("prefill", "decode")}
    api_url = f"https://127.0.0.1:{ports['api']}"
    long_p, short_p = refs[(1000, 0)]["prompt"], refs[(100, 0)]["prompt"]
    workers: set = set()
    with tempfile.TemporaryDirectory() as work_dir:
        auth = ServeAuth(work_dir)
        config, ds = deploy_manifests(api_url, ports, auth)
        serve = ServeProcess(work_dir, ports["api"], config, [ds], auth)
        standby = informer = None
        try:
            deadline = time.monotonic() + DEPLOY_READY_S
            while not serve.serving():
                serve.alive()
                check(time.monotonic() < deadline, f"deployed pair: serve never served "
                                                   f"https\n{serve.log()[-3000:]}")
                time.sleep(0.1)
            client = RemoteClient(api_url, ca_cert=auth.ca, token=auth.tokens["admin"])
            # Started before the deploy settles; it runs across the failover.
            informer = start_informer(api_url, auth)
            clone = store_clone(serve.log(), "serve")
            auth_codes = check_api_auth(ports["api"], auth, ds)
            eps: dict = {}
            while len(eps) < 2:
                serve.alive()
                check(time.monotonic() < deadline, f"deployed pair: -prv endpoints {eps} by the "
                                                   f"deadline\n{serve.log()[-3000:]}")
                for role in ("prefill", "decode"):
                    try:
                        ep = kt.discover_role_endpoint(client, "default", DEPLOY_NAME, role)
                    except OSError:
                        ep = None
                    if ep is not None:
                        eps[role] = ep
                time.sleep(0.2)
            t_published = time.perf_counter() - t_path
            check(eps == {r: ("127.0.0.1", ports[r]) for r in ("prefill", "decode")},
                  f"deployed pair: discovered {eps}")
            pods = {r: deployed_pods(client, r) for r in ("prefill", "decode")}
            check(all(len(v) == 1 for v in pods.values()), f"deployed pair: pods {pods}")
            pods = {r: v[0] for r, v in pods.items()}
            pids = {r: int(p["metadata"]["annotations"][PID_ANNOTATION]) for r, p in pods.items()}
            workers |= set(pids.values())
            import socket

            for role in ("prefill", "decode"):
                while True:
                    serve.alive()
                    check(pid_alive(pids[role]), f"deployed pair: the {role} worker died")
                    try:
                        with socket.create_connection(eps[role], timeout=1.0):
                            break
                    except OSError:
                        check(time.monotonic() < deadline, f"deployed pair: the {role} worker "
                                                           "never listened")
                        time.sleep(0.5)
            t_ready = time.perf_counter() - t_path
            for role in ("prefill", "decode"):
                check(http_call(metrics_ports[role], "/healthz") == (200, "ok"),
                      f"deployed pair: the {role} worker's telemetry /healthz")
            # Only the workers hold the card; the serve process never does.
            check(not holds_the_card(serve.proc.pid),
                  "deployed pair: the serve process has the card's device nodes open")
            smi = nvidia_smi_pids()
            check(serve.proc.pid not in smi, f"deployed pair: nvidia-smi lists serve ({smi})")
            known = set(pids.values()) | {os.getpid()}
            if set(smi) & known:
                check(set(smi) <= known, f"deployed pair: nvidia-smi lists {smi}, workers "
                                         f"{sorted(pids.values())} and this script {os.getpid()}")
                smi_note = f"nvidia-smi lists {sorted(smi)}: the two workers and this script"
            else:
                # Its pids are another namespace's: count the contexts instead,
                # one for each worker and one for this script; serve would be
                # one more.
                check(len(smi) == len(known), f"deployed pair: nvidia-smi lists {len(smi)} "
                                              f"compute apps, expected {len(known)} (the two "
                                              "workers and this script)")
                smi_note = (f"nvidia-smi lists {len(smi)} compute apps (pids {smi} of another "
                            "namespace): the two workers and this script")
            for role in ("prefill", "decode"):
                check(holds_the_card(pids[role]), f"deployed pair: the {role} worker holds no "
                                                  "device node")
            results = {"short": deployed_request(eps, "short", short_p, serve, deadline)}
            # The hot spare: a second serve on the same state dir and port,
            # blocked on the state dir's lock (checked before the kill below).
            standby = ServeProcess(work_dir, ports["api"], config, [], auth, name="standby",
                                   standby=True)

            # Group-atomic restart: SIGKILL the decode pod's process.
            since = client.current_seq()
            old = pods["decode"]
            t_kill = time.perf_counter()
            os.kill(pids["decode"], signal.SIGKILL)
            check(wait_until(lambda: not pid_alive(pids["decode"]), timeout=30.0),
                  "deployed pair: the killed decode process lives on")
            deadline = time.monotonic() + DEPLOY_READY_S
            # Submitted while decode is down: the bundle waits on prefill.
            kt.submit_prompt(eps["prefill"], "outage", kt.arrays_to_bytes(prompt=short_p))
            failed = None
            while failed is None:
                serve.alive()
                check(time.monotonic() < deadline, "deployed pair: the killed pod never went "
                                                   "Failed on /watch")
                batch = client.watch(since, timeout=1)
                check("expired" not in batch, "deployed pair: the /watch bookmark expired")
                since = batch["next"]
                failed = next((e["object"] for e in batch["events"]
                               if e["object"]["kind"] == "Pod"
                               and e["object"]["metadata"]["uid"] == old["metadata"]["uid"]
                               and (e["object"].get("status") or {}).get("phase") == "Failed"),
                              None)
            check(failed["status"]["container_restarts"] == 1,
                  f"deployed pair: the killed pod's status {failed['status']}")
            new = None
            while new is None:
                serve.alive()
                check(time.monotonic() < deadline, "deployed pair: the decode group was never "
                                                   "recreated")
                got = deployed_pods(client, "decode")
                if (len(got) == 1 and got[0]["metadata"]["uid"] != old["metadata"]["uid"]
                        and (got[0].get("status") or {}).get("ready")
                        and PID_ANNOTATION in got[0]["metadata"]["annotations"]):
                    new = got[0]
                else:
                    time.sleep(0.2)
            check(new["metadata"]["name"] == old["metadata"]["name"],
                  f"deployed pair: the recreated pod is {new['metadata']['name']}")
            pods["decode"] = new
            pids["decode-b"] = int(new["metadata"]["annotations"][PID_ANNOTATION])
            workers.add(pids["decode-b"])
            results["outage"] = deployed_request(eps, "outage", short_p, serve, deadline,
                                                 submit=False)
            t_recover = time.perf_counter() - t_kill
            # The Informer at this quiet moment and after one write through
            # the client.
            informer_quiet = informer_converges(informer, client, "at the quiet moment")
            informer_write = informer_sees_a_write(informer, client)
            results["long-s"] = deployed_request(eps, "long-s", long_p, serve, deadline)

            # The fleet plane: the fleet view at a quiet moment, the loadgen
            # command under /metrics/fleet scrapes, the read commands.
            # (The read commands come before the command's requests, which
            # could displace long-s's journey: a role keeps its 16 slowest.)
            fleet_sums = check_fleet_view(ports["api"], pods, metrics_ports)
            facts = read_commands(serve, ports["api"], pods, metrics_ports, "long-s")
            command_prompts, fleet_scrapes = command_over_deployed(
                eps, ports["api"], metrics_ports, loadgen)
            # A decode failure armed live through the faults command: the
            # raise leaves the bundle unacked and its redelivery is served.
            armed = serve.cli("faults", "disagg.decode.process=fail_n_times:1",
                              server=f"127.0.0.1:{metrics_ports['decode']}")
            check(armed.returncode == 0 and json.loads(armed.stdout)["armed"] == {
                "disagg.decode.process": "fail_n_times:1"},
                f"faults --server <decode>: {armed.returncode} {armed.stdout} {armed.stderr}")
            results["fault"] = deployed_request(eps, "fault", short_p, serve, deadline)
            code, text = http_call(metrics_ports["decode"], "/debug/faults")
            check(code == 200 and json.loads(text)["trips"] == {"disagg.decode.process": 1},
                  f"deployed pair: the decode role's /debug/faults after the fault: {code} {text}")
            autoscale = autoscale_loop(serve, client, work_dir)

            # The CLI's commands as processes against the same server.
            listed = serve.cli("get", "Pod")
            check(listed.returncode == 0, f"get Pod exited {listed.returncode}: {listed.stderr}")
            pod_names = sorted(ln.split("\t")[0] for ln in listed.stdout.splitlines())
            want_names = sorted(f"default/{p['metadata']['name']}" for p in pods.values())
            check(pod_names == want_names, f"get Pod listed {pod_names}, the DS's pods "
                                           f"{want_names}")
            got_ds = serve.cli("get", "DisaggregatedSet")
            check(got_ds.returncode == 0 and [ln.split("\t")[0] for ln in
                                               got_ds.stdout.splitlines()]
                  == [f"default/{DEPLOY_NAME}"], f"get DisaggregatedSet: {got_ds.stdout!r}")
            logs = serve.cli("logs", new["metadata"]["name"])
            check(logs.returncode == 0 and "[decode] finished outage" in logs.stdout
                  and "[decode] finished long-s" in logs.stdout
                  and "finished short" not in logs.stdout,
                  f"logs of the new decode pod: {logs.stdout[-2000:]!r}")

            # The control plane dies with kill -9 while the pair serves; the
            # standby takes over with every acknowledged write and the live
            # workers.
            drill, drilled = control_plane_failover(serve, standby, client, informer, eps, ports,
                                                    metrics_ports, pods, pids, short_p, long_p)
            results.update(drilled)

            gone = standby.cli("delete", "DisaggregatedSet", "default", DEPLOY_NAME)
            check(gone.returncode == 0 and json.loads(gone.stdout) == {
                "deleted": f"DisaggregatedSet/default/{DEPLOY_NAME}"},
                f"delete DisaggregatedSet: {gone.returncode} {gone.stdout} {gone.stderr}")
            t_delete = time.perf_counter()
            live = [pids["prefill"], pids["decode-b"]]
            check(wait_until(lambda: not any(pid_alive(p) for p in live), timeout=DEPLOY_EXIT_S),
                  f"deployed pair: workers {[p for p in live if pid_alive(p)]} outlived the "
                  f"delete by {DEPLOY_EXIT_S:.0f} s")
            t_exit = time.perf_counter() - t_delete
            check(not deployed_pods(client), "deployed pair: pods left after the delete")
            log_dir = serve.pod_log_dir()

            def pod_log(pod: dict) -> str:
                m = pod["metadata"]
                with open(os.path.join(log_dir, f"{m['namespace']}_{m['name']}_{m['uid']}.log"),
                          errors="replace") as f:
                    return f.read()

            launches = {"prefill": launch_line(pod_log(pods["prefill"]), "prefill"),
                        "decode-b": launch_line(pod_log(new), "decode")}
            leftover = proc_children(serve.proc.pid) + proc_children(standby.proc.pid)
            check(not leftover, f"deployed pair: serve's children {leftover} outlived the path")
            for role, pod in (("prefill", pods["prefill"]), ("decode", new)):
                started = [ln for ln in pod_log(pod).splitlines()
                           if ln.startswith(f"[{role} ") and " serving " in ln]
                check(len(started) == 1, f"deployed pair: the {role} worker started "
                                         f"{len(started)} times (one model load across the "
                                         "failover)")
        finally:
            if informer is not None:
                informer.stop()
            rc = serve.stop()
            rc_standby = standby.stop() if standby is not None else None
            stray = [p for p in workers if pid_alive(p)]
            for p in stray:
                os.kill(p, signal.SIGKILL)
        check(not stray, f"deployed pair: processes {stray} outlived the path")
        check(rc == -signal.SIGKILL, f"deployed pair: the killed serve exited {rc}")
        check(rc_standby == 0, f"deployed pair: the standby exited {rc_standby} on SIGINT:\n"
                               f"{standby.log()[-3000:]}")
        # Its final compaction: the snapshot holds no DisaggregatedSet.
        with open(os.path.join(auth.state_dir, "state.json")) as f:
            final = json.load(f)
        check(not final.get("DisaggregatedSet") and not final.get("Pod"),
              f"deployed pair: the standby's final snapshot holds {sorted(final)}")
    # Bundles and tokens against path 16's references.
    model_box: dict = {}
    verdicts = {}
    for rid, (S, chunk) in (("short", (100, 0)), ("outage", (100, 0)),
                            ("long-s", (1000, CHUNK)), ("fault", (100, 0)),
                            ("cp-outage", (100, 0)), ("cp-long", (1000, CHUNK))):
        meta, toks = results[rid]
        ref, h = refs[(S, chunk)], meta["handoff"]
        check(h["bundle_bytes"] == ref["stats"]["bundle_bytes"],
              f"deployed pair {rid}: bundle {h['bundle_bytes']} B, one card "
              f"{ref['stats']['bundle_bytes']} B")
        check(bool(h.get("streamed")) == bool(chunk) and h["pos"] == S,
              f"deployed pair {rid}: handoff record {h}")
        verdicts[rid] = check_pair_stream(torch, dev, toks, ref, f"deployed pair {rid}",
                                          model_box)
    # The launches each role printed at exit, its counters kept across the
    # control plane's failover: prefill handled the streamed 1,000-token
    # prompt twice, four 100-token prompts and the loadgen command's
    # prompts; the replacement decode role decoded all but `short`.
    mono = lambda S: {"flash_attention": L, "int8_matmul": 7 * L * (S <= 256) + 1}  # noqa: E731
    want = {"prefill": {"flash_attention": 0,
                        "int8_matmul": 2 * (7 * L * -(-1000 // CHUNK) + 1)},
            "decode-b": {"int8_matmul": (7 * L + 1) * HANDOFF_STEPS
                         * (5 + len(command_prompts))}}
    for S in [100, 100, 100, 100] + command_prompts:
        for k, v in mono(S).items():
            want["prefill"][k] += v
    total = {name: 0 for name in kernel_counters()}
    for role, got in launches.items():
        check_launches(f"deployed pair {role}", got, want[role])
        for k, v in got.items():
            total[k] += v
    print(f"deployed pair: serve (pid {serve.proc.pid}) held no CUDA context ({smi_note}); "
          f"-prv endpoints published {t_published:.1f} s and both roles listening "
          f"{t_ready:.1f} s after `serve` started (deploy-to-ready); tokens vs one card: "
          f"{verdicts}; SIGKILL of the decode process -> pod Failed (container_restarts 1) -> "
          f"group recreated (uid {old['metadata']['uid']} -> {new['metadata']['uid']}) -> the "
          f"outage request's result {t_recover:.1f} s after the kill (kill-to-result); "
          f"/metrics/fleet at rest equals each worker's own /metrics {fleet_sums}; under the "
          f"loadgen command {fleet_scrapes[0]} /metrics/fleet scrapes, median "
          f"{fleet_scrapes[1]:.2f} ms, max {fleet_scrapes[2]:.2f} ms; read commands: top, "
          f"monitor, rollout ({facts['rollout']} timeline entries), devices (compile records "
          f"{facts['compile_records']}), profile --fleet (decode {facts['decode_samples']} "
          f"samples), explain long-s (one connected tree, spans by instance "
          f"{facts['explain_spans']}), why {facts['decision']}; faults armed on the decode "
          f"worker, its request redelivered; autoscaler {AUTOSCALE_LWS} 1 -> 2 in "
          f"{autoscale['up_s']:.1f} s, 2 -> 1 in {autoscale['down_s']:.1f} s; serve over https "
          f"with token auth {auth_codes}; the control plane's failover (kill -9 of serve, the "
          f"standby restored {drill['restored']} objects, every pod re-adopted with its uid and "
          f"pid, no new process on the card, the outage and post-takeover requests equal their "
          f"references, /metrics/fleet of the new server {drill['fleet']}); workers gone "
          f"{t_exit:.1f} s after `delete` through the new server; serve's store clone "
          f"{clone}; the Informer (LWS, DS, Pod) equalled the store at the quiet moment "
          f"({informer_quiet[1]} objects, {informer_quiet[0]:.3f} s), saw a server-side apply "
          f"(resourceVersion {informer_write['resource_version']}) {informer_write['seen_s']:.4f}"
          f" s after it and equalled the store {informer_write['equal_s']:.3f} s later; after the "
          f"takeover it {drill['informer']} ({drill['informer_relists']} relist(s) on expired); "
          f"cp-long as one span tree of "
          f"{drill['traced']['spans']} spans (the standby's reconcile, the client, both "
          f"workers) through record, export_jsonl ({drill['traced']['jsonl_bytes']} bytes) and "
          f"read_jsonl, connected; path wall "
          f"time {time.perf_counter() - t_path:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Path 15: training (loss and backward, AdamW, checkpoints; the ring and
# GPipe in their one-rank forms here, on several cards with --train-only).

# benchmarks/train_bench.py's on-accelerator run: its config, batch x
# sequence, steps and make_optimizer().
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
TRAIN_TIMED = 3        # steps timed with remat off, for its cost
TRAIN_SMALL = (2, 256)  # the degenerate layouts' batch x sequence, f32
BF16_LOSS_RTOL = 2e-2  # bf16 compute against f32 compute, same weights
REMAT_RTOL = 1e-5      # remat on against off: loss, and ||g - g'|| / ||g'||
LAYOUT_RTOL = 1e-4     # degenerate GPipe / ring logits vs plain, of max |plain|, f32
CKPT_RTOL = 1e-6       # step 3's loss after a restore (JAX's own check)
# A one-rank NCCL mesh against mesh=None from the same weights: the
# collectives are copies, so each gradient equals mesh=None's (||g - g'|| /
# ||g'||) but the embedding's, which may differ by the order of f32 atomic
# adds in its backward (index_put_ with accumulate on CUDA). After a step,
# the parameters but the embedding stay within MESH_PARAM_ATOL (the clip's
# scale moves with the embedding's norm); an embedding element may move by
# 2 lr where that order flips the sign of a gradient near 0 (Adam's first
# step is about lr sign(g)).
MESH_GRAD_RTOL = 1e-6
MESH_EMBED_GRAD_RTOL = 1e-5
MESH_PARAM_ATOL = 1e-6
MESH_EMBED_PARAM_ATOL = 2 * 3e-4 + 1e-6
# A layout on several cards against the single card, steps 1-3 of the same
# seed and batch: |l - l'| <= rtol |l'| + atol. Sound layouts differ only by
# bf16 reduction order (step 2: 0.7050-0.7053 against 0.7051); a gradient
# off by a sign, or a stage that does not learn, moves step 1's loss (4.93)
# by far more than 1 %.
LAYOUT_LOSS_RTOL, LAYOUT_LOSS_ATOL = 1e-2, 5e-3
# The initial loss of JAX's init: the final norm leaves each row with mean
# square 1 and lm_head's columns have variance 1/d, so the logits are about
# N(0, 1) over the vocabulary and the expected loss is ln V + 1/2 (the log
# of V E[e^z]), not ln V: a bound of 0.5 around ln V would sit on the edge.
INIT_LOSS_TOL = 0.1


def train_config(torch, **kw):
    from lws_tpu_torch.models.llama import LlamaConfig

    cfg = dict(vocab_size=32000, d_model=1536, n_layers=12, n_heads=12, n_kv_heads=6,
               d_ff=4096, max_seq_len=2048, remat=True, dtype=torch.bfloat16,
               param_dtype=torch.float32)
    cfg.update(kw)
    return LlamaConfig(**cfg)


def train_tokens(torch, dev, cfg, B: int = TRAIN_BATCH, S: int = TRAIN_SEQ, seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).to(dev)


def with_cfg(model, **kw):
    """The same parameters under a changed config (remat, compute dtype,
    the GPipe or ring switch): a shallow copy of the module."""
    import copy
    import dataclasses

    out = copy.copy(model)
    out.cfg = dataclasses.replace(model.cfg, **kw)
    return out


def grad_rel(a: dict, b: dict) -> float:
    return max(float((a[n].float() - b[n].float()).norm() / b[n].float().norm().clamp(min=1e-30))
               for n in b)


def all_finite(torch, tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def profile_train_steps(torch, run, params, state, tokens, steps: int = 2) -> tuple:
    """torch.profiler over `steps` steady training steps: wall, device busy,
    kernels a step, NCCL's device time, and the largest kernels by device
    time. Returns (record, params, state)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            params, state, _, _ = run(params, state, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = nccl = 0.0
    kernels = 0
    top = []
    for ev in device_kernels(prof):
        busy += ev.self_device_time_total
        kernels += ev.count
        top.append((ev.self_device_time_total, ev.key, ev.count))
        if "nccl" in ev.key.lower():
            nccl += ev.self_device_time_total
    top.sort(reverse=True)
    rec = {"steps": steps, "wall_ms": wall * 1e3 / steps, "busy_ms": busy / 1e3 / steps,
           "nccl_ms": nccl / 1e3 / steps, "kernels": kernels / steps,
           "top": [(t / 1e3 / steps, k[:60], c // steps) for t, k, c in top[:8]]}
    return rec, params, state


def path_train(torch, dev, profile: bool = False) -> dict:
    """Path 15 on one card, at benchmarks/train_bench.py's on-accelerator
    config (train_config: 0.41 B parameters in f32, bf16 compute, remat)
    with make_optimizer() (AdamW, lr 3e-4) on a fixed batch of 4 x 1024:
    the bf16 loss within BF16_LOSS_RTOL of the f32-compute loss on the same
    weights; remat on and off give the same loss and gradients (REMAT_RTOL);
    8 steps: the first loss within INIT_LOSS_TOL of ln V + 1/2, the last
    below it, every
    gradient and parameter finite; ms per step, tokens/s, MFU against the
    H100 SXM dense bf16 peak, peak memory and remat's cost (3 steps without
    it); a checkpoint saved after step 2 restores bit for bit and its step-3
    loss equals the run's (CKPT_RTOL); a one-rank NCCL mesh gives
    mesh=None's gradients (MESH_GRAD_RTOL, the embedding's
    MESH_EMBED_GRAD_RTOL) and, after a step, its parameters
    (MESH_PARAM_ATOL, the embedding's MESH_EMBED_PARAM_ATOL); on that mesh, GPipe
    at pp = 1 with 2 microbatches and the ring at cp = 1 give the plain f32
    forward's logits (LAYOUT_RTOL). No kernel of the repo may launch: JAX
    trains on XLA attention. Returns the launch counts (all 0)."""
    import math
    import shutil
    import tempfile
    import warnings

    import torch.distributed as dist

    from lws_tpu_torch.models.checkpoint import restore_checkpoint, save_checkpoint
    from lws_tpu_torch.models.llama import init_params, loss_fn
    from lws_tpu_torch.models.train import (
        TrainState,
        make_optimizer,
        make_train_step,
        value_and_grad,
    )
    from lws_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env

    t_path = time.perf_counter()
    card = card_line()
    reset_counts()
    cfg = train_config(torch)
    N = cfg.n_params()
    # 6 N tokens counts the products: the embedding table is looked up.
    N_mm = N - cfg.vocab_size * cfg.d_model
    opt = make_optimizer()
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    model = init_params(cfg, gen(), dev)
    tokens = train_tokens(torch, dev, cfg)

    with torch.no_grad():
        l16 = float(loss_fn(model, {"tokens": tokens})[0])
        l32 = float(loss_fn(with_cfg(model, dtype=torch.float32), {"tokens": tokens})[0])
    check(abs(l16 - l32) <= BF16_LOSS_RTOL * abs(l32),
          f"training: bf16 loss {l16:.5f} vs f32 {l32:.5f}")
    # Remat's cost on the forward and backward alone (the optimizer's
    # temporaries would hide its memory in a whole step's peak): the
    # second of two calls each, timed and its peak read.
    fb = {}
    for remat in (True, False):
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss, _, grads = value_and_grad(with_cfg(model, remat=remat), tokens)
            torch.cuda.synchronize()
            fb[remat] = (float(loss), grads, time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated(dev))
            del grads
    (lr_on, g_on, fb_on_s, fb_on_peak), (lr_off, g_off, fb_off_s, fb_off_peak) = fb[True], fb[False]
    del fb
    remat_err = grad_rel(g_on, g_off)
    check(abs(lr_on - lr_off) <= REMAT_RTOL * abs(lr_off) and remat_err <= REMAT_RTOL,
          f"training: remat loss {lr_on} vs {lr_off}, grads {remat_err:.3e}")
    check(all_finite(torch, g_on.values()), "training: a gradient is not finite")
    del g_on, g_off
    print(f"training: {N / 1e9:.3f} B parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ}; loss bf16 "
          f"{l16:.5f} vs f32 compute {l32:.5f} (rel {abs(l16 - l32) / l32:.2e}); remat on/off "
          f"loss {lr_on:.6f}/{lr_off:.6f}, grads rel {remat_err:.2e}")

    run = make_train_step(cfg, None, opt)
    params, state = model, opt.init(model)
    ckpt_dir = tempfile.mkdtemp(prefix="lws_train_ckpt_")
    try:
        losses, saved = [], None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = None
        for i in range(TRAIN_STEPS):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            params, state, loss, _ = run(params, state, {"tokens": tokens})
            losses.append(loss)
            if i == 1:  # after step 2
                torch.cuda.synchronize()
                tc = time.perf_counter()
                saved = {n: p.detach().to("cpu", copy=True) for n, p in params.named_parameters()}
                ts = time.perf_counter()
                save_checkpoint(ckpt_dir, TrainState(step=2, params=params, opt_state=state))
                save_s = time.perf_counter() - ts
                t0 += time.perf_counter() - tc  # the copy and the save are not a step
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 1)
        peak_on = torch.cuda.max_memory_allocated(dev)
        losses = [float(x) for x in losses]
        expect = math.log(cfg.vocab_size) + 0.5
        check(abs(losses[0] - expect) <= INIT_LOSS_TOL,
              f"training: initial loss {losses[0]:.4f}, ln V + 1/2 = {expect:.4f}")
        check(losses[-1] < losses[0], f"training: no learning on a fixed batch: {losses}")
        check(all_finite(torch, params.parameters())
              and all_finite(torch, state["mu"].values()) and all_finite(torch, state["nu"].values()),
              "training: a parameter or moment is not finite")

        tc = time.perf_counter()
        back = restore_checkpoint(ckpt_dir, cfg, None, opt, device=dev)
        restore_s = time.perf_counter() - tc
        check(back.step == 2 and int(back.opt_state["count"]) == 2,
              f"checkpoint: step {back.step}, count {int(back.opt_state['count'])}")
        for n, p in back.params.named_parameters():
            check(torch.equal(p.cpu(), saved[n]), f"checkpoint: {n} differs after the restore")
        _, _, l3, _ = run(back.params, back.opt_state, {"tokens": tokens})
        check(abs(float(l3) - losses[2]) <= CKPT_RTOL * abs(losses[2]),
              f"checkpoint: step 3 loss {float(l3)} after the restore, {losses[2]} without")
        del back, saved
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    if profile:
        prof, params, state = profile_train_steps(torch, run, params, state, tokens)
        busy = prof["busy_ms"]
        print(f"profile training ({card}): {prof['wall_ms']:.1f} ms of wall a step, device busy "
              f"{busy:.1f} ms ({busy / prof['wall_ms']:.1%}), {prof['kernels']:.0f} kernels a "
              f"step; largest: " + "; ".join(f"{k} {t:.2f} ms x{c}" for t, k, c in prof["top"]))
    off = with_cfg(params, remat=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        off, state, loss, _ = run(off, state, {"tokens": tokens})
    torch.cuda.synchronize()
    off_s = (time.perf_counter() - t0) / TRAIN_TIMED
    del model, params, off, state
    torch.cuda.empty_cache()
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    mfu = 6 * N_mm * TRAIN_BATCH * TRAIN_SEQ / step_s / H100_BF16_FLOPS
    print(f"training ({card}): losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f" (ln V = {math.log(cfg.vocab_size):.4f}, ln V + 1/2 = {expect:.4f})")
    print(f"training ({card}): {step_s * 1e3:.1f} ms/step with remat (steps 2-{TRAIN_STEPS}), "
          f"{tok_s:.0f} tokens/s, MFU {mfu:.1%} (6 N tokens / step time / 989 TFLOP/s, the "
          f"H100 SXM dense bf16 peak of NVIDIA's data sheet; N = {N_mm / 1e6:.1f} M, the "
          f"{N / 1e6:.1f} M parameters less the embedding table), peak memory {peak_on / 1e9:.2f} GB "
          f"(the AdamW step's temporaries included); without remat {off_s * 1e3:.1f} ms/step: "
          f"remat costs {step_s / off_s - 1:.1%} of a step")
    print(f"training ({card}): forward and backward alone, remat on / off: "
          f"{fb_on_s * 1e3:.1f} / {fb_off_s * 1e3:.1f} ms, peak {fb_on_peak / 1e9:.2f} / "
          f"{fb_off_peak / 1e9:.2f} GB: remat costs {fb_on_s / fb_off_s - 1:.1%} of it and saves "
          f"{(fb_off_peak - fb_on_peak) / 1e9:.2f} GB of activations")
    print(f"checkpoint: {3 * 4 * N / 1e9:.2f} GB saved in {save_s:.1f} s, restored in "
          f"{restore_s:.1f} s, bit for bit; step 3 loss {float(l3):.6f} vs {losses[2]:.6f}")

    # A one-rank NCCL mesh, and the degenerate layouts on it.
    initialize_from_env(env={}, device=dev, group_of_one=True, timeout_s=TP_TIMEOUT_S)
    try:
        mesh = build_mesh(MeshSpec())
        got = []
        for m in (None, mesh):
            p = init_params(cfg, gen(), dev, mesh=m)
            _, _, grads = value_and_grad(p, tokens, mesh=m)
            p, _, loss, _ = make_train_step(cfg, m, opt)(p, opt.init(p), {"tokens": tokens})
            got.append((float(loss), grads, p))
        (l_none, g_none, model_none), (l_mesh, g_mesh, meshed) = got
        p_none, p_mesh = dict(model_none.named_parameters()), dict(meshed.named_parameters())
        embed = "embed.weight"
        g_err = {n: grad_rel({n: g_mesh[n]}, {n: g_none[n]}) for n in g_none}
        g_worst = max(v for n, v in g_err.items() if n != embed)
        check(sorted(g_mesh) == sorted(g_none) and g_worst <= MESH_GRAD_RTOL
              and g_err[embed] <= MESH_EMBED_GRAD_RTOL,
              f"one-rank mesh: gradients rel {g_worst:.3e}, the embedding's {g_err[embed]:.3e}")
        p_err = {n: float((p_mesh[n] - p_none[n]).detach().abs().max()) for n in p_none}
        worst = max(v for n, v in p_err.items() if n != embed)
        check(l_mesh == l_none and worst <= MESH_PARAM_ATOL
              and p_err[embed] <= MESH_EMBED_PARAM_ATOL,
              f"one-rank mesh: loss {l_mesh} vs {l_none}, params differ by {worst:.3e}, "
              f"the embedding by {p_err[embed]:.3e}")
        del got, g_none, g_mesh, model_none, p_none, p_mesh
        torch.cuda.empty_cache()
        small = train_tokens(torch, dev, cfg, *TRAIN_SMALL)[:, :-1]
        with torch.no_grad(), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the ring over one rank says so
            from lws_tpu_torch.models.llama import forward

            plain, plain_aux = forward(with_cfg(meshed, dtype=torch.float32), small)
            errs = {}
            for what, kw in (("gpipe pp=1 M=2", {"pipeline_microbatches": 2}),
                             ("ring cp=1", {"context_parallel": True})):
                logits, aux = forward(with_cfg(meshed, dtype=torch.float32, **kw), small)
                errs[what] = float((logits - plain).abs().max() / plain.abs().max())
                check(errs[what] <= LAYOUT_RTOL and float(aux) == float(plain_aux),
                      f"{what}: logits rel {errs[what]:.3e} vs the plain forward")
        del meshed
        torch.cuda.empty_cache()
        print(f"one-rank NCCL mesh: gradients within {g_worst:.2e} of mesh=None's (the "
              f"embedding's {g_err[embed]:.2e}), step loss equal, parameters within {worst:.2e} "
              f"(the embedding's {p_err[embed]:.2e}); degenerate layouts vs the plain f32 forward: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    finally:
        dist.destroy_process_group()
    counts = read_counts()
    check_launches("training", counts, {})
    print(f"training: path wall time {time.perf_counter() - t_path:.1f} s")
    return counts


def parse_mesh(text: str) -> tuple:
    """--mesh DP,PP,CP,TP[:M]: the mesh, and GPipe's microbatches (0: the
    weight-gathered stack). cp > 1 runs the ring."""
    shape, _, m = text.partition(":")
    dims = [int(x) for x in shape.split(",")]
    check(len(dims) == 4 and all(d >= 1 for d in dims), f"--mesh {text}: want DP,PP,CP,TP[:M]")
    return tuple(dims), int(m or 0)


def mesh_label(dims, m: int) -> str:
    dp, pp, cp, tp = dims
    parts = [f"{a} {n}" for a, n in (("dp", dp), ("pp", pp), ("cp", cp), ("tp", tp)) if n > 1]
    how = f"GPipe M={m}" if m else ("weight-gathered" if pp > 1 else "")
    return "(" + ", ".join(parts or ["one rank"]) + ")" + (f" {how}" if how else "")


NCCL_KINDS = ("AllReduce", "ReduceScatter", "AllGather", "SendRecv")


def nccl_kind(key: str):
    """The collective an NCCL kernel's name says it runs (NCCL_KINDS, else
    "other"), or None for a kernel that is not NCCL's."""
    if "nccl" not in key.lower():
        return None
    return next((k for k in NCCL_KINDS if k.lower() in key.lower()), "other")


def forward_collectives(torch, params, batch, mesh) -> tuple:
    """One training forward (loss_fn with autograd, no backward) with the
    collectives it posts counted on the host: (its loss, {every
    all-reduce's element count and whether it runs over the tp group, the
    reduce-scatters, the all-gathers}), the last two through
    parallel/collectives.py's own calls. `mesh` may be None."""
    import torch.distributed as dist

    from lws_tpu_torch.models.llama import loss_fn
    from lws_tpu_torch.parallel import collectives

    calls = {"all_reduce": [], "reduce_scatter": 0, "all_gather": 0}
    real_all_reduce = dist.all_reduce
    # A package without sequence parallelism has no reduce-scatter to count.
    wrapped = {k: getattr(collectives, name) for k, name in (
        ("reduce_scatter", "_reduce_scatter_single"), ("all_gather", "_all_gather_single"))
        if hasattr(collectives, name)}

    tp = None if mesh is None else mesh.tp_group

    def all_reduce(t, *a, group=None, **kw):
        calls["all_reduce"].append((t.numel(), tp is not None and group is tp))
        return real_all_reduce(t, *a, group=group, **kw)

    def counted(key):
        def fn(*a, **kw):
            calls[key] += 1
            return wrapped[key](*a, **kw)
        return fn

    dist.all_reduce = all_reduce
    for key in wrapped:
        setattr(collectives, f"_{key}_single", counted(key))
    try:
        loss, _ = loss_fn(params, batch)
    finally:
        dist.all_reduce = real_all_reduce
        for key, fn in wrapped.items():
            setattr(collectives, f"_{key}_single", fn)
    return loss, calls


def train_layout_run(torch, dev, mesh, m: int, steps: int = 4) -> dict:
    """One layout on every rank: the seed-0 weights as this rank's shards,
    `steps` steps on train_tokens (the first's loss is step 0's), the later
    ones timed, each training block's input sequence lengths recorded
    (forward pre-hooks), then one step under torch.profiler for NCCL's
    share and its kernels by kind, and one forward with its collectives
    counted (forward_collectives)."""
    from torch.profiler import ProfilerActivity, profile

    from lws_tpu_torch.models.llama import init_params
    from lws_tpu_torch.models.train import dp_rows, make_optimizer, make_train_step, value_and_grad

    cfg = train_config(torch, context_parallel=mesh.cp > 1, pipeline_microbatches=m)
    opt = make_optimizer()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, mesh=mesh)
    state = opt.init(params)
    run = make_train_step(cfg, mesh, opt)
    tokens = train_tokens(torch, dev, cfg)
    block_seq = set()
    hooks = [blk.register_forward_pre_hook(lambda mod, args: block_seq.add(args[0].shape[1]))
             for blk in params.layers]
    losses = []
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, state, loss, _ = run(params, state, {"tokens": tokens})
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (steps - 1)
    for h in hooks:
        h.remove()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, loss, _ = run(params, state, {"tokens": tokens})
        torch.cuda.synchronize()
    busy = nccl = 0.0
    kinds = {}
    for ev in device_kernels(prof):
        busy += ev.self_device_time_total
        kind = nccl_kind(ev.key)
        if kind is not None:
            nccl += ev.self_device_time_total
            n, us = kinds.get(kind, (0, 0.0))
            kinds[kind] = (n + ev.count, us + ev.self_device_time_total)
    # The annotations device_kernels leaves out, to show what they repeat.
    notes = {ev.key: [ev.count, ev.self_device_time_total / 1e3] for ev in prof.key_averages()
             if getattr(ev, "is_user_annotation", False) and "nccl" in ev.key.lower()
             and ev.self_device_time_total > 0}
    peak = torch.cuda.max_memory_allocated(dev)
    # The forward and backward alone (path 15's remat measurement): the
    # step's peak is the AdamW update's, which activations do not reach.
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    grads = value_and_grad(params, tokens, mesh)[2]
    torch.cuda.synchronize()
    fb_peak = torch.cuda.max_memory_allocated(dev)
    del grads
    calls = forward_collectives(torch, params, {"tokens": dp_rows(tokens, cfg, mesh)}, mesh)[1]
    out = {"losses": [float(x) for x in losses], "step_ms": step_s * 1e3,
           "peak_gb": peak / 1e9, "fb_above_mb": (fb_peak - resident) / 1e6,
           "busy_ms": busy / 1e3, "nccl_ms": nccl / 1e3,
           "nccl_kinds": {k: [n, us / 1e3] for k, (n, us) in sorted(kinds.items())},
           "nccl_annotations": notes,
           "block_seq": sorted(block_seq), "forward_calls": calls}
    del params, state
    torch.cuda.empty_cache()
    return out


def train_member(rank: int, layouts, out_dir: str) -> None:
    """A spawned rank of --train-only --mesh: bootstraps from the env contract
    in os.environ (NCCL, its own card), then runs every layout in order."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lws_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env, local_device
    from lws_tpu_torch.parallel.bootstrap import bootstrap_info_from_env

    env = dict(os.environ)
    dev = local_device(bootstrap_info_from_env(env))
    initialize_from_env(env=env, device=dev, timeout_s=TP_TIMEOUT_S)
    recs = []
    for dims, m in layouts:
        dp, pp, cp, tp = dims
        mesh = build_mesh(MeshSpec(dp=dp, pp=pp, cp=cp, tp=tp))
        recs.append(train_layout_run(torch, dev, mesh, m))
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(recs, f)
    dist.barrier()
    dist.destroy_process_group()


def path_train_meshes(torch, dev, layouts) -> None:
    """--train-only --mesh ...: train_config on several cards, one rank per
    card, every layout in one group of max(dp pp cp tp) ranks: every rank's
    losses agree, the step-0 loss is within BF16_LOSS_RTOL of the single
    card's and steps 1-3 within LAYOUT_LOSS_RTOL/ATOL of its (computed here
    first from the same seed, with the single card's ms per step in this
    call), and each layout prints ms per step, tokens/s
    per card against the single card's, peak memory and NCCL's share of a
    step's device time (torch.profiler)."""
    import tempfile

    from lws_tpu_torch.models.llama import init_params, loss_fn
    from lws_tpu_torch.models.train import make_optimizer, make_train_step
    from lws_tpu_torch.parallel import launch

    card = card_line()
    world = int(np.prod(layouts[0][0]))
    check(all(int(np.prod(d)) == world for d, _ in layouts) and world <= torch.cuda.device_count(),
          f"--mesh: every layout must use the same {world} of "
          f"{torch.cuda.device_count()} cards")
    cfg = train_config(torch)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = train_tokens(torch, dev, cfg)
    with torch.no_grad():
        ref = float(loss_fn(model, {"tokens": tokens})[0])
    opt = make_optimizer()
    run, state = make_train_step(cfg, None, opt), opt.init(model)
    ref_losses = []
    for i in range(4):  # train_layout_run's steps
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        model, state, loss, _ = run(model, state, {"tokens": tokens})
        ref_losses.append(loss)
    torch.cuda.synchronize()
    ref_tok_s = TRAIN_BATCH * TRAIN_SEQ / ((time.perf_counter() - t0) / 3)
    ref_losses = [float(x) for x in ref_losses]
    print(f"training on one card ({card}): step-0 loss {ref:.5f}, losses "
          + ", ".join(f"{x:.5f}" for x in ref_losses) + f", {ref_tok_s:.0f} tokens/s")
    del model, state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx, _ = launch.spawn_group(train_member, world, args=(layouts, out_dir))
        try:
            launch.join(ctx, timeout_s=1200)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        recs = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.json")) as f:
                recs.append(json.load(f))
    for i, (dims, m) in enumerate(layouts):
        per = [rec[i] for rec in recs]
        l0 = per[0]["losses"][0]
        for r, p in enumerate(per):
            check(all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(p["losses"], per[0]["losses"])),
                  f"{mesh_label(dims, m)}: rank {r} losses {p['losses']} vs rank 0's")
        check(abs(l0 - ref) <= BF16_LOSS_RTOL * abs(ref),
              f"{mesh_label(dims, m)}: step-0 loss {l0} vs the single card's {ref}")
        later = list(zip(per[0]["losses"][1:], ref_losses[1:]))
        check(len(later) == 3 and all(abs(a - b) <= LAYOUT_LOSS_RTOL * abs(b) + LAYOUT_LOSS_ATOL
                                      for a, b in later),
              f"{mesh_label(dims, m)}: losses {per[0]['losses']} vs the single card's "
              f"{ref_losses}")
        rel = ", ".join(f"{abs(a - b) / abs(b):.1e}" for a, b in later)
        step_ms = max(p["step_ms"] for p in per)
        per_card = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3) / world
        shares = [p["nccl_ms"] / p["busy_ms"] for p in per if p["busy_ms"] > 0]
        nccl = (f"{min(shares):.1%}-{max(shares):.1%} over the ranks; NCCL kernels also wait "
                f"for their peers" if len(shares) == len(per)
                else "not measured: the profiler recorded no device time")
        print(f"training {mesh_label(dims, m)} on {world} cards ({card}): step-0 loss {l0:.5f} "
              f"(single card {ref:.5f}), losses " + ", ".join(f"{x:.5f}" for x in per[0]["losses"])
              + f" (steps 1-3 rel {rel} of the single card's); {step_ms:.1f} ms/step, {per_card:.0f} tokens/s per card "
              f"({per_card / ref_tok_s:.3f}x one card's), peak "
              f"{max(p['peak_gb'] for p in per):.3f} GB (a forward and backward alone: "
              f"{max(p['fb_above_mb'] for p in per):.1f} MB above the resident state); NCCL "
              f"{per[0]['nccl_ms']:.1f} ms of {per[0]['busy_ms']:.1f} ms device time in a profiled "
              f"step on rank 0 ({nccl})")
        kinds = ", ".join(f"{k} x{n} {ms:.2f} ms" for k, (n, ms) in per[0]["nccl_kinds"].items())
        calls = per[0]["forward_calls"]
        tp_ar = sum(1 for _, on_tp in calls["all_reduce"] if on_tp)
        print(f"training {mesh_label(dims, m)}: NCCL kernels of that step on rank 0: "
              f"{kinds or 'none recorded'}; block inputs (B, s, D) by rank: s = "
              + ", ".join(f"{p['block_seq']}" for p in per)
              + "; GPU user annotations left out: "
              + (", ".join(f"{k} x{n} {ms:.2f} ms" for k, (n, ms)
                           in sorted(per[0]["nccl_annotations"].items())) or "none")
              + f"; one forward on rank 0 posts {calls['reduce_scatter']} reduce-scatters, "
              f"{calls['all_gather']} all-gathers, {len(calls['all_reduce'])} all-reduces "
              f"({tp_ar} over tp, largest {max((n for n, _ in calls['all_reduce']), default=0)} "
              f"elements)")
    # Sequence parallelism, checked once every layout has printed its line.
    for i, (dims, m) in enumerate(layouts):
        dp, pp, cp, tp = dims
        per = [rec[i] for rec in recs]
        S_local = TRAIN_SEQ // cp
        share = -(-S_local // tp)
        for r, p in enumerate(per):
            calls = p["forward_calls"]
            check(p["block_seq"] == [share],
                  f"{mesh_label(dims, m)}: rank {r}'s blocks took sequence lengths "
                  f"{p['block_seq']}, not its share {share} of {S_local} over tp {tp}")
            check(not any(on_tp for _, on_tp in calls["all_reduce"]),
                  f"{mesh_label(dims, m)}: rank {r}'s training forward all-reduced over tp: "
                  f"{calls['all_reduce']} (element counts, over tp)")
            if tp > 1:
                check(calls["reduce_scatter"] > 0
                      and p["nccl_kinds"].get("ReduceScatter", [0])[0] > 0,
                      f"{mesh_label(dims, m)}: rank {r} ran no reduce-scatter at tp {tp}: "
                      f"{calls}, {p['nccl_kinds']}")


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
                         "engine, and steady verify passes (torch.profiler); on path 14, "
                         "NCCL's share of a TP decode step; on path 15, two training steps")
    ap.add_argument("--tp", type=int, default=0,
                    help="path 14's group size, one rank per card (default: every visible card)")
    ap.add_argument("--tp-only", action="store_true",
                    help="build, then path 14 alone, against single-card references of its "
                         "own (the multi-card run; no kernels line)")
    ap.add_argument("--disagg-only", action="store_true",
                    help="build, then path 16 alone at --tp (default 1) against one-card "
                         "handoffs of its own; with 2 x tp cards the roles take separate "
                         "cards and NCCL's share of the decode role's steps is printed")
    ap.add_argument("--deploy-only", action="store_true",
                    help="build, then path 17 alone (the port's control plane deploying the "
                         "full-width pair) against one-card handoffs of its own")
    ap.add_argument("--train-only", action="store_true",
                    help="path 15 alone (no build, no kernels line); with --mesh, its config "
                         "on several cards")
    ap.add_argument("--mesh", action="append", default=[], metavar="DP,PP,CP,TP[:M]",
                    help="with --train-only: a layout to train (repeatable); M > 0 runs GPipe "
                         "with M microbatches, cp > 1 the ring")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from lws_tpu_torch.models.flagship import flagship_config
        from lws_tpu_torch.models.llama import init_params
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
    if args.train_only:
        if args.mesh:
            path_train_meshes(torch, dev, [parse_mesh(m) for m in args.mesh])
        else:
            path_train(torch, dev, args.profile)
        print(f"chip_smoke: path 15 passed in {time.perf_counter() - t_start:.1f} s")
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
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
    world = args.tp or torch.cuda.device_count()
    check(1 <= world <= torch.cuda.device_count(),
          f"--tp {world}: {torch.cuda.device_count()} card(s) visible")
    if args.disagg_only:
        path_tp_disagg(torch, dev, args.tp or 1, pair_refs(torch, dev), profile_nccl=True)
        print(f"chip_smoke: path 16 passed in {time.perf_counter() - t_start:.1f} s")
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.deploy_only:
        path_deployed_pair(torch, dev, pair_refs(torch, dev))
        print(f"chip_smoke: path 17 passed in {time.perf_counter() - t_start:.1f} s")
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.tp_only:
        path_tp_only(torch, dev, cfg, world, args.profile)
        print(f"chip_smoke: path 14 passed in {time.perf_counter() - t_start:.1f} s")
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
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
    by_path["bf16 paged engine"], engine, prompts, bf16_streams = path_bf16_paged(torch, dev, cfg)
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
    by_path["int8 dense engine"], dense_tokens = path_int8_dense(torch, dev, cfg8, model8)
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
    by_path["disagg handoff"], handoff_refs = path_disagg(torch, dev, model8)
    watch.end("disagg handoff")
    torch.cuda.empty_cache()
    watch.begin()
    by_path["load runner"] = path_loadgen(torch, dev, cfg8, model8, watch.recorder)
    watch.end("load runner")
    torch.cuda.empty_cache()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)  # path 5's
    by_path["tensor-parallel group"] = path_tp_group(
        torch, dev, world, {"bf16": model, "int8": model8}, prompts, dense_batch(cfg8)[1],
        {"bf16": bf16_streams, "int8": paged_streams, "dense": dense_tokens}, args.profile)
    del model, model8  # the flagships go before the MoE model is built
    torch.cuda.empty_cache()
    by_path["tensor-parallel disagg pair"] = path_tp_disagg(torch, dev, 1, handoff_refs)
    torch.cuda.empty_cache()
    by_path["deployed pair"] = path_deployed_pair(torch, dev, handoff_refs)
    torch.cuda.empty_cache()
    watch.begin()
    by_path["int8 MoE engines"], kernels["int8_matmul"]["moe_expert_rows"] = path_int8_moe(
        torch, dev, profile=args.profile)
    watch.end("int8 MoE engines")
    torch.cuda.empty_cache()
    by_path["training"] = path_train(torch, dev, args.profile)
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
