#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lws_tpu_torch) on one GPU and hold its
kernels to their plain PyTorch versions.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # build + kernel checks only (no engine)
    python3 chip_smoke.py --profile    # every phase, then a torch.profiler
                                       # breakdown of steady decode steps

Phases (each raises on failure; the script then exits non-zero and prints
no result line):
  1. the card (nvidia-smi name and power limit, CUDA version) and the build of
     both CUDA kernels from lws_tpu_torch/csrc/ for sm_90a, one nvcc per
     source, started together;
  2. the flash prefill kernel against reference_attention at the flagship's
     attention shapes (B=1, H=32, Hkv=8, D=128, bf16, causal) for several S,
     with times of the kernel, the plain version and, as a yardstick only,
     torch's scaled_dot_product_attention;
  3. the paged-decode kernel against its plain version (gather + dense
     attention) on the flagship pool (32 layers, block 16) with a scrambled
     table, block-boundary positions, a null row and a nonzero layer;
  4. the engine at full width: flagship_config("full") in bf16 from a seeded
     torch.Generator. Kernel-path prefill and decode-step logits are held to
     the plain path's on the same weights; then PagedBatchEngine(slots=8,
     max_len=2048, block_size=16) serves 8 greedy requests (prompts of
     100..1000 tokens, 64 new tokens each), three rounds, with the kernels'
     launch counts reset just before and read just after.
The last lines are a JSON line of per-kernel numbers, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
FLASH_TOL = 2e-2          # atol = rtol, bf16 outputs (2^-8 relative rounding, f32 sums)
PAGED_TOL = 2e-2
LOGITS_REL_TOL = 5e-2     # max |kernel - plain| / max |plain| over the vocab, bf16 model


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_flash(torch, dev, cfg) -> dict:
    import torch.nn.functional as F

    from lws_tpu_torch.ops.attention import flash_attention, reference_attention

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(1)
    record, worst = None, 0.0
    for S in (16, 128, 1000, 1024, 2048):
        q = torch.randn(1, S, H, D, generator=g, device=dev, dtype=torch.bfloat16)
        k = torch.randn(1, S, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16)
        v = torch.randn(1, S, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16)
        out = flash_attention(q, k, v, causal=True)
        ref = reference_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"flash S={S}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        check(torch.allclose(out.float(), ref.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
              f"flash S={S}: max abs err {err} beyond atol=rtol={FLASH_TOL}")
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
        flops = 4 * H * D * S * (S + 1) / 2  # QK^T and PV over the causal half
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, k, v in; o out
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"flash S={S:5d}: max_abs_err={err:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"sdpa={library_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}) "
              f"roofline={bound_ms / ms:.1%}")
        if S == 1024:  # the bucket of the longest prompt on the main path
            record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}
    record["max_abs_err"] = worst
    return record


def phase_paged(torch, dev, cfg) -> dict:
    from lws_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_reference,
    )

    H, Hkv, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    slots, max_len, bs = 8, 2048, 16
    MB = max_len // bs
    NB = slots * MB + 1
    g = torch.Generator(device=dev).manual_seed(2)
    k_pool = torch.randn(L, NB, bs, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16)
    v_pool = torch.randn(L, NB, bs, Hkv, D, generator=g, device=dev, dtype=torch.bfloat16)
    q = torch.randn(slots, 1, H, D, generator=g, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    free = list(rng.permutation(np.arange(1, NB)))
    # Block-boundary positions (bs-1, bs, 2bs-1), long mixed lengths, and a
    # released slot (row 7: all null, position frozen).
    pos = np.array([bs - 1, bs, 2 * bs - 1, 1000, 517, 263, 1063, 40], np.int32)
    table = np.zeros((slots, MB), np.int32)
    for b in range(slots - 1):
        n_live = pos[b] // bs + 1
        table[b, :n_live] = [free.pop() for _ in range(n_live)]
    table[2, 2:6] = table[3, :4]  # stale tail entries pointing at another slot's blocks
    table_d = torch.tensor(table, device=dev)
    pos_d = torch.tensor(pos, device=dev)
    layer = 17
    out = paged_decode_attention(q, k_pool, v_pool, table_d, pos_d, layer)
    ref = paged_decode_attention_reference(q, k_pool, v_pool, table_d, pos_d, layer)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "paged decode: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.allclose(out.float(), ref.float(), atol=PAGED_TOL, rtol=PAGED_TOL),
          f"paged decode: max abs err {err} beyond atol=rtol={PAGED_TOL}")
    for other in (0, L - 1):  # first and last layer of the pool too
        o2 = paged_decode_attention(q, k_pool, v_pool, table_d, pos_d, other)
        r2 = paged_decode_attention_reference(q, k_pool, v_pool, table_d, pos_d, other)
        e2 = (o2.float() - r2.float()).abs().max().item()
        err = max(err, e2)
        check(torch.allclose(o2.float(), r2.float(), atol=PAGED_TOL, rtol=PAGED_TOL),
              f"paged decode layer {other}: max abs err {e2}")
    # Cold L2 between launches, as in a decode step (31 other layers and the
    # weights pass through the cache between two launches on one layer).
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = scrub.zero_
    ms = time_cuda(torch, lambda: paged_decode_attention(q, k_pool, v_pool, table_d, pos_d, layer),
                   reps=50, flush=flush)
    plain_ms = time_cuda(
        torch, lambda: paged_decode_attention_reference(q, k_pool, v_pool, table_d, pos_d, layer),
        reps=20, flush=flush)
    tokens = int((np.minimum(pos, MB * bs - 1) + 1).sum())  # keys this data attends
    nbytes = tokens * Hkv * D * 2 * 2 + 2 * q.numel() * 2 + table.nbytes + pos.nbytes
    flops = 4 * H * D * tokens
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"paged decode B={slots} pos={pos.tolist()} layer={layer}: max_abs_err={err:.3e} "
          f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}) "
          f"roofline={bound_ms / ms:.1%} ({nbytes / ms / 1e6:.1f} GB/s)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "max_abs_err": err}


def engine_bounds(cfg, param_bytes: int, lens, new_tokens: int) -> tuple[float, float]:
    """The least the card could take for the engine phase's work, bf16:
    (median over requests of the prefill bound in seconds, the decode
    tok/s bound). A prefill runs 2*params flops per token through every
    product but the lm_head (last token only) plus causal attention, and
    reads the weights once; a decode step reads every weight but the
    embedding table (a row gather) and every live K/V row once."""
    V, D, L = cfg.vocab_size, cfg.d_model, cfg.n_layers
    H, hd, Hkv = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    weight_bytes = param_bytes - V * D * 2
    prod_params = cfg.n_params() - 2 * V * D
    prefill = []
    for n in lens:
        bucket = 16
        while bucket < n:
            bucket *= 2
        flops = 2 * prod_params * bucket + 2 * V * D + L * 4 * H * hd * bucket * (bucket + 1) / 2
        prefill.append(bound(flops, weight_bytes)[0] / 1e3)
    kv_row = 2 * L * Hkv * hd * 2  # K and V bytes of one token, all layers
    steps = new_tokens - 1
    kv_tokens = sum(int(n) + i + 1 for i in range(steps) for n in lens)
    decode_s = (steps * weight_bytes + kv_tokens * kv_row) / H100_HBM_BYTES
    return statistics.median(prefill), len(lens) * steps / decode_s


def phase_engine(torch, dev, cfg) -> tuple:
    from lws_tpu_torch.models.llama import (
        PagedKVCache,
        forward_decode_paged,
        forward_prefill,
        init_cache,
        init_paged_cache,
        init_params,
        paged_insert,
    )
    from lws_tpu_torch.ops.attention import flash_attention
    from lws_tpu_torch.ops.paged_attention import paged_decode_attention
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"engine: flagship 'full' init {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB")
    V = cfg.vocab_size
    rng = np.random.default_rng(0)

    # Kernel path vs plain path on the same weights: prefill, then one step.
    plen, bucket, bs, max_len = 300, 512, 16, 2048
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :plen] = rng.integers(1, V, plen)
    toks = torch.from_numpy(padded).to(dev)
    ck = init_cache(cfg, 1, bucket, dev)
    cp = init_cache(cfg, 1, bucket, dev)
    lk, ck = forward_prefill(model, toks, ck, last_pos=plen - 1)
    lp, cp = forward_prefill(model, toks, cp, last_pos=plen - 1, plain=True)
    check(tuple(lk.shape) == (1, V) and bool(torch.isfinite(lk).all()), "prefill logits shape/finite")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    kv_err = (ck.k[:, :, :plen].float() - cp.k[:, :, :plen].float()).abs().max().item()
    print(f"engine: prefill logits kernel vs plain: max rel err {rel:.3e} "
          f"(argmax {int(lk.argmax())} vs {int(lp.argmax())}); K cache max abs err {kv_err:.3e}")
    check(rel <= LOGITS_REL_TOL, f"prefill logits rel err {rel} > {LOGITS_REL_TOL}")
    n_prefill_blocks = bucket // bs
    pool_k = init_paged_cache(cfg, n_prefill_blocks + 2, bs, dev)
    paged_insert(pool_k, ck.k[:, 0], ck.v[:, 0],
                 torch.arange(1, n_prefill_blocks + 1, device=dev))
    pool_p = PagedKVCache(k=pool_k.k.clone(), v=pool_k.v.clone())
    table = torch.zeros(1, max_len // bs, dtype=torch.int32, device=dev)
    table[0, :n_prefill_blocks + 1] = torch.arange(1, n_prefill_blocks + 2, device=dev)
    pos = torch.tensor([plen], dtype=torch.int32, device=dev)
    first = lk.argmax(-1).to(torch.int32)
    dk, _ = forward_decode_paged(model, first, pool_k, table, pos)
    dp, _ = forward_decode_paged(model, first, pool_p, table, pos, plain=True)
    check(tuple(dk.shape) == (1, V) and bool(torch.isfinite(dk).all()), "decode logits shape/finite")
    rel_d = ((dk - dp).abs().max() / dp.abs().max()).item()
    print(f"engine: decode-step logits kernel vs plain: max rel err {rel_d:.3e} "
          f"(argmax {int(dk.argmax())} vs {int(dp.argmax())})")
    check(rel_d <= LOGITS_REL_TOL, f"decode logits rel err {rel_d} > {LOGITS_REL_TOL}")
    del ck, cp, pool_k, pool_p

    slots, new_tokens = 8, 64
    engine = PagedBatchEngine(cfg, model, slots=slots, max_len=max_len, block_size=bs)
    warm = engine.submit(rng.integers(1, V, 64).astype(np.int32), 8)  # cuBLAS/allocator warm-up
    engine.run_until_drained()
    check(engine.result(warm) is not None, "warm-up request did not finish")

    lens = np.linspace(100, 1000, slots).astype(int)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in lens]
    rounds = 3  # the same batch three times: host-bound numbers vary, so show the spread
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps0 = engine.stats["decode_steps"]
    flash_attention.launches = 0
    paged_decode_attention.launches = 0
    ttfts, rates = [], []
    for r in range(rounds):
        ttft, ids = [], []
        for p in prompts:  # submit returns once the first token is on the host
            t0 = time.perf_counter()
            rid = engine.submit(p, new_tokens)
            ttft.append(time.perf_counter() - t0)
            check(rid is not None, "engine refused a request with free slots and blocks")
            ids.append(rid)
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        for rid in ids:
            out = engine.result(rid)
            check(out is not None and len(out) == new_tokens,
                  f"request {rid}: {out and len(out)} tokens")
            check(all(0 <= t < V for t in out), f"request {rid}: token outside [0, {V})")
        acct = engine.pool_accounting()
        check(acct["free"] == acct["total"] and acct["live"] == 0, f"pool not returned: {acct}")
        decoded = slots * (new_tokens - 1)
        ttfts.append(statistics.median(ttft))
        rates.append(decoded / decode_s)
        print(f"engine round {r}: {slots} requests, prompts {lens.tolist()}, {new_tokens} tokens "
              f"each: median TTFT {ttfts[-1] * 1e3:.1f} ms (max {max(ttft) * 1e3:.1f} ms), "
              f"decode {decoded} tokens in {decode_s:.3f} s = {rates[-1]:.1f} tok/s")
    launches = {"flash_attention": flash_attention.launches,
                "paged_decode_attention": paged_decode_attention.launches}
    steps = engine.stats["decode_steps"] - steps0
    peak = torch.cuda.max_memory_allocated(dev)
    ttft_bound, rate_bound = engine_bounds(cfg, n_bytes, lens, new_tokens)
    print(f"engine: median over {rounds} rounds: TTFT {statistics.median(ttfts) * 1e3:.1f} ms "
          f"(bound {ttft_bound * 1e3:.1f} ms), decode {statistics.median(rates):.1f} tok/s "
          f"(bound {rate_bound:.1f} tok/s, {statistics.median(rates) / rate_bound:.1%} of it); "
          f"{steps} decode steps; peak memory {peak / 1e9:.2f} GB")
    admissions = rounds * slots
    check(launches["flash_attention"] == cfg.n_layers * admissions,
          f"flash launches {launches['flash_attention']} != {cfg.n_layers} x {admissions} admissions")
    check(steps > 0 and launches["paged_decode_attention"] == cfg.n_layers * steps,
          f"paged launches {launches['paged_decode_attention']} != {cfg.n_layers} x {steps} steps")
    print(f"engine: launches flash={launches['flash_attention']} "
          f"({launches['flash_attention'] / admissions:g} per admission), "
          f"paged={launches['paged_decode_attention']} "
          f"({launches['paged_decode_attention'] / steps:g} per decode step)")
    return launches, engine, prompts


def phase_profile(torch, engine, prompts, steps: int = 16) -> None:
    """Device time by kernel family over `steps` steady decode steps of the
    8-slot engine (torch.profiler, CUDA activity), and the device's busy
    share of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        check(engine.submit(p, steps + 8) is not None, "profile: admission refused")
    engine.step_n(4)  # settle the in-flight ring
    engine._pipeline.flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = 0
        while done < steps:
            done += engine.step_n(min(8, steps - done))
        engine._pipeline.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.run_until_drained()
    families = {"paged_decode": 0.0, "flash": 0.0, "products (cuBLAS)": 0.0, "other": 0.0}
    rows, launches = [], 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # CPU ops carry their kernels' time too
            continue
        us = ev.self_device_time_total
        name, low = ev.key, ev.key.lower()
        rows.append((us, ev.count, name))
        launches += ev.count
        if "paged_decode" in low:
            families["paged_decode"] += us
        elif "flash_fwd" in low:
            families["flash"] += us
        elif any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
            families["products (cuBLAS)"] += us
        else:
            families["other"] += us
    busy = sum(families.values()) / 1e6
    check(busy > 0, "profile: torch.profiler recorded no device time")
    print(f"profile: {steps} decode steps, 8 slots: wall {wall * 1e3:.2f} ms "
          f"({wall * 1e3 / steps:.2f} ms/step under the profiler), device busy "
          f"{busy * 1e3:.2f} ms = {busy / wall:.1%} of wall (idle {1 - busy / wall:.1%}), "
          f"{launches / steps:.0f} kernels/step")
    for fam, us in families.items():
        print(f"profile: {fam}: {us / 1e3:.3f} ms ({us / 1e3 / steps:.3f} ms/step, "
              f"{us / 1e6 / busy:.1%} of device time)")
    for us, count, name in sorted(rows, reverse=True)[:12]:
        print(f"profile:   {us / 1e3:9.3f} ms  x{count:<6d} {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only (no engine, no result line)")
    ap.add_argument("--profile", action="store_true",
                    help="after every phase, profile steady decode steps (torch.profiler)")
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

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _ext.build(["flash_attention", "paged_attention"])
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"build[{name}]: {line.strip()}")

    cfg = flagship_config("full")
    kernels = {
        "flash_attention": {
            "route": "cuda", "source": "lws_tpu_torch/csrc/flash_attention.cu",
            "replaces": "lws_tpu/ops/attention.py:84", **phase_flash(torch, dev, cfg)},
        "paged_decode_attention": {
            "route": "cuda", "source": "lws_tpu_torch/csrc/paged_attention.cu",
            "replaces": "lws_tpu/ops/paged_attention.py:102", **phase_paged(torch, dev, cfg)},
    }
    torch.cuda.empty_cache()
    if args.kernels:
        print(json.dumps({"kernels": kernels}))
        return 0
    launches, engine, prompts = phase_engine(torch, dev, cfg)
    if args.profile:
        phase_profile(torch, engine, prompts)
    rows = [{"name": name, "launches": launches[name], **rec} for name, rec in kernels.items()]
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
