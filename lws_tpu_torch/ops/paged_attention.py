"""Paged decode attention over the whole KV block pool: the CUDA kernel
(csrc/paged_attention.cu) and its plain PyTorch version, for a bf16 pool
(`paged_decode_attention`) and an int8 pool with per-(token, kv head) f32
scales (`paged_decode_attention_int8`).

Counterpart of lws_tpu/ops/paged_attention.py (both branches). Same
contract as `cached_attention` with S=1: for slot b, the keys at logical
positions <= pos_b[b] of the sequence the block-table row table[b] maps
are attended. The pool is passed whole with a layer index, never sliced.
"""

from __future__ import annotations

import ctypes

import torch

from lws_tpu_torch.ops import _ext
from lws_tpu_torch.ops.attention import HEAD_DIM, NEG_INF

_SIGNATURES = {
    "lws_paged_decode_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k_pool v_pool
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # table pos layer out
        ctypes.c_void_p, ctypes.c_void_p,  # split partials: acc, (m, l)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Hkv NB
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # MB splits blocks_per_split
        ctypes.c_float, ctypes.c_void_p,  # scale stream
    ],
    "lws_paged_decode_attention_int8": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k_pool k_scale
        ctypes.c_void_p, ctypes.c_void_p,  # v_pool v_scale
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # table pos layer out
        ctypes.c_void_p, ctypes.c_void_p,  # split partials: acc, (m, l)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Hkv NB
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # MB splits blocks_per_split
        ctypes.c_float, ctypes.c_void_p,  # scale stream
    ],
}
BLOCK_SIZE = 16  # the kernel's compiled pool block size


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


def split_scratch(q, Hkv: int, splits: int):
    B, _, H, hd = q.shape
    n = B * Hkv * splits * (H // Hkv)
    return (torch.empty(n * hd, dtype=torch.float32, device=q.device),
            torch.empty(n * 2, dtype=torch.float32, device=q.device))


def _launch_kernel(q, k_pool, v_pool, block_table, pos_b, layer_idx: int,
                   scales=None) -> torch.Tensor:
    """Launch the bf16 entry point, or with `scales` (k_scale, v_scale) the
    int8 one; both run the same split pass (csrc/decode_common.cuh)."""
    quant = scales is not None
    what = "paged_decode_attention_int8" if quant else "paged_decode_attention"
    _check_inputs(what, q, k_pool, v_pool, block_table, pos_b, layer_idx,
                  torch.int8 if quant else torch.bfloat16, scales or ())
    dev = q.device
    B, _, H, hd = q.shape
    NB, Hkv = k_pool.shape[1], k_pool.shape[3]
    # Split each slot's table row so the first pass fills the card: the
    # live length is device data, so the split is sized from max_blocks.
    MB = block_table.shape[1]
    splits, per_split = _ext.split_plan(dev, B * Hkv, MB)
    part_acc, part_ml = split_scratch(q, Hkv, splits)
    out = torch.empty_like(q)
    lib = _ext.load("paged_attention", _SIGNATURES)
    pools = ((k_pool.data_ptr(), scales[0].data_ptr(), v_pool.data_ptr(), scales[1].data_ptr())
             if quant else (k_pool.data_ptr(), v_pool.data_ptr()))
    with torch.cuda.device(dev):
        rc = getattr(lib, "lws_" + what)(
            q.data_ptr(), *pools, block_table.data_ptr(), pos_b.data_ptr(), layer_idx,
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            B, H, Hkv, NB, MB, splits, per_split, float(hd) ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream,
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
