#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lws_tpu_torch) on one GPU and hold its
kernels to their plain PyTorch versions.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # build + kernel checks only (no engine)
    python3 chip_smoke.py --profile    # every phase, and a torch.profiler breakdown
                                       # of steady decode steps of both paged engines

Phases (each raises on failure; the script then exits non-zero and prints
no result line):
  1. the card (nvidia-smi name and power limit, CUDA version) and the build of
     every CUDA source in lws_tpu_torch/csrc/ for sm_90a, one nvcc per source,
     started together;
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
  4. the int8_matmul kernel against its plain version at m = 1, 8, 128 and
     256 rows for the flagship's five product shapes, with two yardsticks
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
     rounds;
  6. the int8 paged engine: the bf16 model is freed, then
     flagship_config("full", kv_quant=True) with init_quantized_params (int8
     weights, int8 KV) serves the same requests the same way;
  7. the dense Engine on the same int8 model: its batched prefill and one
     decode step held to the plain path, then one batch of 8 prompts of 512
     tokens, 64 new tokens each.
Every engine path is driven with all kernels' launch counts set to 0 just
before it and read just after, and the counts are checked exactly. The last
lines are a JSON line of per-kernel numbers, the card line, and
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
SLOTS, MAX_LEN, BLOCK, NEW_TOKENS, ROUNDS = 8, 2048, 16, 64, 3


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
        for m in (1, 8, 128, 256):
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
    """The paged engine's prefill length for an n-token prompt: a power of
    two, at least one block."""
    bucket = BLOCK
    while bucket < n:
        bucket *= 2
    return min(bucket, MAX_LEN)


def engine_bounds(cfg, weight_bytes: int, lens, new_tokens: int,
                  batched: bool = False) -> tuple[float, float]:
    """The least the card could take for an engine phase's work: (the
    prefill bound in seconds: the median over requests, or with `batched`
    that of one prefill of them all; the decode tok/s bound). A prefill
    runs 2*params flops per token through every product but the lm_head
    (last token only) plus causal attention, and reads the weights once; a
    decode step reads `weight_bytes` and every live K/V row (kv_row_bytes,
    int8 with scales when kv_quant) once."""
    from lws_tpu_torch.models.flagship import kv_row_bytes

    V, D, L = cfg.vocab_size, cfg.d_model, cfg.n_layers
    H, hd = cfg.n_heads, cfg.head_dim
    prod_params = cfg.n_params() - 2 * V * D
    prefill = []
    for n in lens:
        bucket = bucket_of(n)
        prefill.append(2 * prod_params * bucket + 2 * V * D
                       + L * 4 * H * hd * bucket * (bucket + 1) / 2)
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
    kv_err = (ck.k[:, :, :plen].float() - cp.k[:, :, :plen].float()).abs().max().item()
    print(f"{what}: prefill logits kernel vs plain: max rel err {rel:.3e} "
          f"(argmax {int(lk.argmax())} vs {int(lp.argmax())}); K cache max abs err {kv_err:.3e}")
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


def serve_paged(torch, dev, cfg, model, prompts, what: str) -> tuple:
    """PagedBatchEngine(slots=8, max_len=2048, block_size=16) serves the 8
    prompts for ROUNDS rounds (64 new tokens each) after a warm-up request,
    with the launch counts reset just before and read just after. Returns
    (launches, decode steps, the engine)."""
    from lws_tpu_torch.models.quant import quantized_bytes
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    V = cfg.vocab_size
    engine = PagedBatchEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK)
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
    for r in range(ROUNDS):
        ttft, ids = [], []
        for p in prompts:  # submit returns once the first token is on the host
            t0 = time.perf_counter()
            rid = engine.submit(p, NEW_TOKENS)
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
            check(out is not None and len(out) == NEW_TOKENS,
                  f"{what}: request {rid}: {out and len(out)} tokens")
            check(all(0 <= tok < V for tok in out), f"{what}: request {rid}: token outside [0, {V})")
        acct = engine.pool_accounting()
        check(acct["free"] == acct["total"] and acct["live"] == 0, f"{what}: pool not returned: {acct}")
        decoded = SLOTS * (NEW_TOKENS - 1)
        ttfts.append(statistics.median(ttft))
        rates.append(decoded / decode_s)
        print(f"{what} round {r}: {SLOTS} requests, prompts {lens}, {NEW_TOKENS} tokens "
              f"each: median TTFT {ttfts[-1] * 1e3:.1f} ms (max {max(ttft) * 1e3:.1f} ms), "
              f"decode {decoded} tokens in {decode_s:.3f} s = {rates[-1]:.1f} tok/s")
    launches = read_counts()
    steps = engine.stats["decode_steps"] - steps0
    peak = torch.cuda.max_memory_allocated(dev)
    ttft_bound, rate_bound = engine_bounds(cfg, weight_bytes_per_step(cfg, model), lens, NEW_TOKENS)
    print(f"{what}: median over {ROUNDS} rounds: TTFT {statistics.median(ttfts) * 1e3:.1f} ms "
          f"(bound {ttft_bound * 1e3:.1f} ms), decode {statistics.median(rates):.1f} tok/s "
          f"(bound {rate_bound:.1f} tok/s, {statistics.median(rates) / rate_bound:.1%} of it); "
          f"{steps} decode steps; parameters {quantized_bytes(model) / 1e9:.2f} GB; "
          f"peak memory {peak / 1e9:.2f} GB")
    print(f"{what}: median TTFT by prefill bucket: " + ", ".join(
        f"{b}: {statistics.median(ts) * 1e3:.1f} ms ({len(ts)} admissions)"
        for b, ts in sorted(by_bucket.items())))
    check(steps > 0, f"{what}: no decode step ran")
    return launches, steps, engine


def check_launches(what: str, got: dict, want: dict) -> None:
    """Exact launch counts of one main-path run; kernels not in `want`
    must not have launched."""
    for name, n in got.items():
        check(n == want.get(name, 0), f"{what}: {name} launched {n} times, expected "
                                      f"{want.get(name, 0)}")
    print(f"{what}: launches " + ", ".join(f"{k}={v}" for k, v in got.items() if v))


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
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in np.linspace(100, 1000, SLOTS).astype(int)]
    launches, steps, engine = serve_paged(torch, dev, cfg, model, prompts, "bf16 engine")
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
    launches, steps, engine = serve_paged(torch, dev, cfg, model, prompts, "int8 engine")
    L, admissions = cfg.n_layers, ROUNDS * SLOTS
    small = ROUNDS * sum(1 for p in prompts if bucket_of(len(p)) <= 256)
    check_launches("int8 engine", launches, {
        "flash_attention": L * admissions,
        "paged_decode_attention_int8": L * steps,
        # decode: 7 products per layer + lm_head per step; prefill: the 7L
        # products at buckets <= 256 rows, and the lm_head row per admission.
        "int8_matmul": (7 * L + 1) * steps + 7 * L * small + admissions,
    })
    return launches, engine


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


def phase_profile(torch, engine, prompts, what: str, steps: int = 16) -> None:
    """Device time by kernel family over `steps` steady decode steps of an
    8-slot paged engine (torch.profiler, CUDA activity), and the device's
    busy share of the window's wall time."""
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
    print(f"profile {what}: {steps} decode steps, 8 slots: wall {wall * 1e3:.2f} ms "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only (no engine, no result line)")
    ap.add_argument("--profile", action="store_true",
                    help="profile steady decode steps of both paged engines (torch.profiler)")
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
    sources = sorted(p.stem for p in _ext.CSRC_DIR.glob("*.cu"))
    reports = _ext.build(sources)
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
    by_path["bf16 paged engine"], engine, prompts = path_bf16_paged(torch, dev, cfg)
    if args.profile:
        phase_profile(torch, engine, prompts, "bf16 engine")
    del engine  # the bf16 weights and pool go before the int8 model is built
    torch.cuda.empty_cache()
    cfg8 = flagship_config("full", kv_quant=True)
    by_path["int8 paged engine"], engine = path_int8_paged(torch, dev, cfg8, prompts)
    if args.profile:
        phase_profile(torch, engine, prompts, "int8 engine")
    model8 = engine.params
    del engine  # its pool goes before the dense engine's cache is built
    torch.cuda.empty_cache()
    by_path["int8 dense engine"] = path_int8_dense(torch, dev, cfg8, model8)
    rows = []
    for name, rec in kernels.items():
        per_path = {path: counts[name] for path, counts in by_path.items() if counts[name]}
        check(per_path, f"{name}: no main path launched it")
        rows.append({"name": name, "launches": sum(per_path.values()),
                     "launches_by_path": per_path, **rec})
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
