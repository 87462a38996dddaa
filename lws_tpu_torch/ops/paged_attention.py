"""Paged decode attention over the whole KV block pool: the CUDA kernel
(csrc/paged_attention.cu) and its plain PyTorch version, for a bf16 pool
(`paged_decode_attention`) and an int8 pool with per-(token, kv head) f32
scales (`paged_decode_attention_int8`).

Counterpart of lws_tpu/ops/paged_attention.py (both branches). Same
contract as `cached_attention` with S=1: for slot b, the keys at logical
positions <= pos_b[b] of the sequence the block-table row table[b] maps
are attended. The pool is passed whole with a layer index, never sliced.

`plan_items` is the kernel's launch plan in Python: the kernel computes the
same plan on the device from pos (csrc/decode_common.cuh), so the launch
never reads pos on the host; the CPU tests check the plan here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from lws_tpu_torch.ops import _ext
from lws_tpu_torch.ops.attention import HEAD_DIM, NEG_INF

_SIGNATURES = {
    "lws_paged_decode_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k_pool v_pool
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # table pos layer out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # chunk partials: acc, (m, l); tickets
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Hkv NB
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # MB grid prefer
        ctypes.c_float, ctypes.c_void_p,  # scale stream
    ],
    "lws_paged_decode_attention_int8": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k_pool k_scale
        ctypes.c_void_p, ctypes.c_void_p,  # v_pool v_scale
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # table pos layer out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # chunk partials: acc, (m, l); tickets
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Hkv NB
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # MB grid prefer
        ctypes.c_float, ctypes.c_void_p,  # scale stream
    ],
    "lws_decode_chunk_sizes": [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int],
}
BLOCK_SIZE = 16  # the kernel's compiled pool block size
STAGED_BLOCKS = 8  # bf16 blocks the kernel stages at once (int8: 16); longer items run in passes
LARGEST_CHUNK = 512  # blocks: the largest work item the plan makes
# The grid per SM, by pool, and the items per SM the plan prefers where a
# chunk size allows (PERF.md, PR 4): 2 items per SM are fastest while they
# fit; the bf16 kernel's registers and staging allow a third CTA per SM,
# the int8 kernel's staging does not.
CTAS_PER_SM = 3
INT8_CTAS_PER_SM = 2
PREFER_PER_SM = 2
MAX_SLOTS = 4096  # the plan's per-slot arrays live in shared memory (kMaxSlots)


def chunk_sizes(quant: bool) -> tuple:
    """The chunk sizes (blocks per work item) the kernel's plan picks from:
    1 up to the blocks staged at once, then doublings up to LARGEST_CHUNK
    (decode_common.cuh Smem::size; checked when a library is loaded)."""
    staged = 2 * STAGED_BLOCKS if quant else STAGED_BLOCKS
    doublings = []
    while (doublings[-1] if doublings else staged) < LARGEST_CHUNK:
        doublings.append(2 * (doublings[-1] if doublings else staged))
    return tuple(range(1, staged + 1)) + tuple(doublings)


class DecodePlan(NamedTuple):
    """The kernel's work: `chunk` blocks per item, and the items in the
    order the grid walks them, (slot, kv head, first block, end block)."""
    chunk: int
    items: tuple


def live_blocks(pos: Sequence[int], n_blocks: int, last_pos: int | None = None) -> list[int]:
    """Blocks each slot attends: through its position (clamped to
    [0, last_pos]), at most n_blocks (max_blocks, or the dense cache's
    ceil(T/16))."""
    out = []
    for p in pos:
        p = max(int(p), 0) if last_pos is None else min(max(int(p), 0), last_pos)
        out.append(min(p // BLOCK_SIZE + 1, n_blocks))
    return out


def decode_grid(B: int, Hkv: int, n_blocks: int, sms: int, quant: bool = False) -> int:
    """The fixed grid: CTAS_PER_SM (int8: INT8_CTAS_PER_SM) CTAs on each SM,
    never more than there could be one-block items. Shapes only: no live
    length enters it."""
    per_sm = INT8_CTAS_PER_SM if quant else CTAS_PER_SM
    return max(1, min(per_sm * sms, B * Hkv * n_blocks))


def decode_prefer(sms: int, grid: int) -> int:
    """The items the plan keeps to where a chunk size allows."""
    return min(PREFER_PER_SM * sms, grid)


def plan_items(n_live: Sequence[int], Hkv: int, grid: int, prefer: int | None = None,
               quant: bool = False) -> DecodePlan:
    """The smallest of chunk_sizes(quant) whose items number at most
    `prefer` (default: the grid), else at most `grid`, else the largest;
    item h * chunks + (first chunk of slot b) + c covers blocks
    [c * chunk, min((c + 1) * chunk, n_live[b])) of slot b, kv head h."""
    def items_at(c):
        return Hkv * sum(-(-n // c) for n in n_live)

    sizes = chunk_sizes(quant)
    fits = [c for limit in (grid if prefer is None else prefer, grid)
            for c in sizes if items_at(c) <= limit]
    chunk = fits[0] if fits else sizes[-1]
    items = [(b, h, j0, min(j0 + chunk, n))
             for h in range(Hkv) for b, n in enumerate(n_live) for j0 in range(0, n, chunk)]
    return DecodePlan(chunk, tuple(items))


def scratch_items(B: int, Hkv: int, n_blocks: int, grid: int) -> int:
    """The most items any positions give: at most `grid` (>= prefer) when a
    chunk size fits, else Hkv * sum(ceil(n / LARGEST_CHUNK)) <= this
    bound."""
    return max(grid, Hkv * B * -(-n_blocks // LARGEST_CHUNK))


# Chunk partials and arrival tickets by (device, stream): launches on two
# streams may run at once, and each leaves its tickets at 0 for the next.
_scratch: dict[tuple[torch.device, int], tuple] = {}


_checked_libs: dict[tuple[str, bool], ctypes.CDLL] = {}


def load_decode_library(name: str, signatures: dict, quant: bool) -> ctypes.CDLL:
    """The built decode library `name`, once its plan's chunk sizes are
    known to be chunk_sizes(quant): scratch_items sizes the partials from
    them, and a kernel making more items would write past them."""
    lib = _checked_libs.get((name, quant))
    if lib is None:
        lib = _ext.load(name, signatures)
        buf = (ctypes.c_int * 32)()
        compiled = tuple(buf[:lib.lws_decode_chunk_sizes(int(quant), buf, 32)])
        if compiled != chunk_sizes(quant):
            raise RuntimeError(f"lws_tpu_torch: {name} plans chunks of {compiled} blocks, the "
                               f"wrapper sizes scratch for {chunk_sizes(quant)}")
        _checked_libs[name, quant] = lib
    return lib


def decode_scratch(dev: torch.device, stream: int, items: int, rows: int, tickets: int):
    """(part_acc f32 [>= items*rows*128], part_ml f32 [>= items*rows*2],
    zeroed int32 tickets [>= tickets]) for launches on `stream` of `dev`,
    made once and grown when a launch needs more: the kernel leaves every
    ticket at 0."""
    cached = _scratch.get((dev, stream))
    n = items * rows
    if cached is None or cached[1].numel() < 2 * n or cached[2].numel() < tickets:
        if cached is not None:
            n, tickets = max(n, cached[1].numel() // 2), max(tickets, cached[2].numel())
        cached = _scratch[dev, stream] = (
            torch.empty(n * HEAD_DIM, dtype=torch.float32, device=dev),
            torch.empty(n * 2, dtype=torch.float32, device=dev),
            torch.zeros(tickets, dtype=torch.int32, device=dev))
    return cached


def cached_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos) -> torch.Tensor:
    """q [B,S,H,hd] attends to cache [B,T,Hkv,hd] at key positions <=
    pos + q_idx; `pos` is an int (whole-batch offset) or a [B] tensor
    (per-slot positions). lws_tpu/models/llama.py:_cached_attention."""
    B, S, H, hd = q.shape
    T, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, cache_k).float() * hd**-0.5
    key_pos = torch.arange(T, device=q.device)
    pos_t = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    q_pos = pos_t + torch.arange(S, device=q.device)  # [1|B, S]
    mask = key_pos[None, None, :] <= q_pos[:, :, None]  # [1|B, S, T]
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, cache_v)
    return out.reshape(B, S, H, hd)


def paged_decode_attention_reference(q, k_pool, v_pool, block_table, pos_b,
                                     layer_idx: int) -> torch.Tensor:
    """The plain version: gather each slot's logical view of layer
    `layer_idx` through its block-table row, then dense cached attention
    (the gather path of lws_tpu/models/llama.py:969-973)."""
    B = q.shape[0]
    Hkv, hd = k_pool.shape[3], k_pool.shape[4]
    idx = block_table.long()
    k_view = k_pool[layer_idx][idx].reshape(B, -1, Hkv, hd)
    v_view = v_pool[layer_idx][idx].reshape(B, -1, Hkv, hd)
    return cached_attention(q, k_view, v_view, pos_b)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 K/V [..., hd] with scales [...] -> values in `dtype`
    (lws_tpu/models/llama.py:_dequantize_kv)."""
    return (q.float() * scale[..., None]).to(dtype)


def paged_decode_attention_int8_reference(q, k_pool, k_scale, v_pool, v_scale, block_table,
                                          pos_b, layer_idx: int) -> torch.Tensor:
    """The plain version over an int8 pool: gather each slot's view and its
    scales, dequantize to q's dtype, then dense cached attention (the XLA
    path of lws_tpu/models/llama.py:931-941)."""
    B = q.shape[0]
    Hkv, hd = k_pool.shape[3], k_pool.shape[4]
    idx = block_table.long()
    k_view = dequantize_kv(k_pool[layer_idx][idx], k_scale[layer_idx][idx], q.dtype)
    v_view = dequantize_kv(v_pool[layer_idx][idx], v_scale[layer_idx][idx], q.dtype)
    return cached_attention(q, k_view.reshape(B, -1, Hkv, hd), v_view.reshape(B, -1, Hkv, hd),
                            pos_b)


def _check_inputs(what: str, q, k_pool, v_pool, block_table, pos_b, layer_idx: int,
                  pool_dtype: torch.dtype, scales=()) -> None:
    dev = q.device
    if not all(t.device == dev for t in (k_pool, v_pool, block_table, pos_b, *scales)):
        raise ValueError(f"{what}: all inputs must be on one CUDA device")
    if q.dtype != torch.bfloat16 or k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"{what}: bf16 q and {pool_dtype} pools only "
                        f"(got {q.dtype}/{k_pool.dtype}/{v_pool.dtype})")
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError(f"{what}: f32 scales only")
    if block_table.dtype != torch.int32 or pos_b.dtype != torch.int32:
        raise TypeError(f"{what}: int32 block_table and pos_b")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{what}: q must be [B,1,H,hd], got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{what}: pools must be [L,NB,bs,Hkv,hd] and equal")
    L, NB, bs, Hkv, hd_pool = k_pool.shape
    if any(s.shape != k_pool.shape[:4] for s in scales):
        raise ValueError(f"{what}: scales must be [L,NB,bs,Hkv] = {tuple(k_pool.shape[:4])}")
    if hd != HEAD_DIM or hd_pool != HEAD_DIM:
        raise ValueError(f"{what}: head dim {HEAD_DIM} only, got {hd}/{hd_pool}")
    if Hkv < 1 or H % Hkv or H // Hkv > 32:
        raise ValueError(f"{what}: need Hkv | H and H/Hkv <= 32 (H={H}, Hkv={Hkv})")
    if block_table.dim() != 2 or block_table.shape[0] != B or pos_b.shape != (B,):
        raise ValueError(f"{what}: block_table [B, max_blocks], pos_b [B]")
    if bs != BLOCK_SIZE:
        raise ValueError(f"{what}: block size {BLOCK_SIZE} only, got {bs}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"{what}: layer {layer_idx} outside [0, {L})")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, block_table, pos_b, *scales)):
        raise ValueError(f"{what}: inputs must be contiguous")


def _launch_kernel(q, k_pool, v_pool, block_table, pos_b, layer_idx: int,
                   scales=None) -> torch.Tensor:
    """Launch the bf16 entry point, or with `scales` (k_scale, v_scale) the
    int8 one; both run decode_attention (csrc/decode_common.cuh). Host work
    is shape checks and cached scratch: pos stays on the device."""
    quant = scales is not None
    what = "paged_decode_attention_int8" if quant else "paged_decode_attention"
    _check_inputs(what, q, k_pool, v_pool, block_table, pos_b, layer_idx,
                  torch.int8 if quant else torch.bfloat16, scales or ())
    dev = q.device
    B, _, H, hd = q.shape
    NB, Hkv = k_pool.shape[1], k_pool.shape[3]
    MB = block_table.shape[1]
    if B > MAX_SLOTS:
        raise ValueError(f"{what}: at most {MAX_SLOTS} slots, got {B}")
    sms = _ext.sm_count(dev)
    grid = decode_grid(B, Hkv, MB, sms, quant)
    stream = torch.cuda.current_stream(dev).cuda_stream
    items = scratch_items(B, Hkv, MB, grid)
    part_acc, part_ml, tickets = decode_scratch(dev, stream, items, H // Hkv, B * Hkv)
    out = torch.empty_like(q)
    lib = load_decode_library("paged_attention", _SIGNATURES, quant)
    pools = ((k_pool.data_ptr(), scales[0].data_ptr(), v_pool.data_ptr(), scales[1].data_ptr())
             if quant else (k_pool.data_ptr(), v_pool.data_ptr()))
    with torch.cuda.device(dev):
        rc = getattr(lib, "lws_" + what)(
            q.data_ptr(), *pools, block_table.data_ptr(), pos_b.data_ptr(), layer_idx,
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
            B, H, Hkv, NB, MB, grid, decode_prefer(sms, grid), float(hd) ** -0.5, stream,
        )
    _ext.check(lib, rc, what)
    (paged_decode_attention_int8 if quant else paged_decode_attention).launches += 1
    return out


def paged_decode_attention(
    q: torch.Tensor,            # [B, 1, H, hd]
    k_pool: torch.Tensor,       # [L, num_blocks, bs, Hkv, hd], whole
    v_pool: torch.Tensor,       # same
    block_table: torch.Tensor,  # [B, max_blocks] int32: slot -> pool blocks
    pos_b: torch.Tensor,        # [B] int32: each slot's current write position
    layer_idx: int,
) -> torch.Tensor:
    """[B, 1, H, hd] in q's dtype. CUDA tensors launch the kernel (bf16,
    hd 128, block size 16) and raise on anything it does not take; CPU
    tensors compute the plain version."""
    if q.is_cuda:
        return _launch_kernel(q, k_pool, v_pool, block_table, pos_b, int(layer_idx))
    return paged_decode_attention_reference(q, k_pool, v_pool, block_table, pos_b,
                                            int(layer_idx))


paged_decode_attention.launches = 0  # kernel launches since the caller last set it to 0


def paged_decode_attention_int8(
    q: torch.Tensor,            # [B, 1, H, hd]
    k_pool: torch.Tensor,       # [L, num_blocks, bs, Hkv, hd] int8, whole
    k_scale: torch.Tensor,      # [L, num_blocks, bs, Hkv] f32
    v_pool: torch.Tensor,       # same as k_pool
    v_scale: torch.Tensor,      # same as k_scale
    block_table: torch.Tensor,  # [B, max_blocks] int32
    pos_b: torch.Tensor,        # [B] int32
    layer_idx: int,
) -> torch.Tensor:
    """[B, 1, H, hd] in q's dtype over an int8 pool, dequantized in the
    kernel. CUDA tensors launch the kernel (bf16 q, hd 128, block size 16)
    and raise on anything it does not take; CPU tensors compute the plain
    version."""
    if q.is_cuda:
        return _launch_kernel(q, k_pool, v_pool, block_table, pos_b, int(layer_idx),
                              (k_scale, v_scale))
    return paged_decode_attention_int8_reference(q, k_pool, k_scale, v_pool, v_scale,
                                                 block_table, pos_b, int(layer_idx))


paged_decode_attention_int8.launches = 0  # kernel launches since the caller last set it to 0
