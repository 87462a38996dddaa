"""Paged decode attention over the whole KV block pool: the CUDA kernel
(csrc/paged_attention.cu) and its plain PyTorch version.

Counterpart of lws_tpu/ops/paged_attention.py (bf16-pool branch). Same
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
}
BLOCK_SIZE = 16  # the kernel's compiled pool block size
CTAS_PER_SM = 4  # sequence splits aim at this many first-pass CTAs per SM


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


def _launch_kernel(q, k_pool, v_pool, block_table, pos_b, layer_idx: int) -> torch.Tensor:
    dev = q.device
    if not all(t.device == dev for t in (k_pool, v_pool, block_table, pos_b)):
        raise ValueError("paged_decode_attention: all inputs must be on one CUDA device")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise TypeError("paged_decode_attention: bf16 q and pools only "
                        f"(got {q.dtype}/{k_pool.dtype}/{v_pool.dtype})")
    if block_table.dtype != torch.int32 or pos_b.dtype != torch.int32:
        raise TypeError("paged_decode_attention: int32 block_table and pos_b")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: q must be [B,1,H,hd], got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError("paged_decode_attention: pools must be [L,NB,bs,Hkv,hd] and equal")
    L, NB, bs, Hkv, hd_pool = k_pool.shape
    if hd != HEAD_DIM or hd_pool != HEAD_DIM:
        raise ValueError(f"paged_decode_attention: head dim {HEAD_DIM} only, got {hd}/{hd_pool}")
    if Hkv < 1 or H % Hkv or H // Hkv > 32:
        raise ValueError(f"paged_decode_attention: need Hkv | H and H/Hkv <= 32 (H={H}, Hkv={Hkv})")
    if block_table.dim() != 2 or block_table.shape[0] != B or pos_b.shape != (B,):
        raise ValueError("paged_decode_attention: block_table [B, max_blocks], pos_b [B]")
    if bs != BLOCK_SIZE:
        raise ValueError(f"paged_decode_attention: block size {BLOCK_SIZE} only, got {bs}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"paged_decode_attention: layer {layer_idx} outside [0, {L})")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, block_table, pos_b)):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    # Split each slot's table row so the first pass fills the card: the
    # live length is device data, so the split is sized from max_blocks.
    MB = block_table.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = min(MB, max(1, -(-CTAS_PER_SM * sms // (B * Hkv))))
    per_split = -(-MB // splits)
    splits = -(-MB // per_split)
    G = H // Hkv
    part_acc = torch.empty(B * Hkv * splits * G * hd, dtype=torch.float32, device=dev)
    part_ml = torch.empty(B * Hkv * splits * G * 2, dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = _ext.load("paged_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.lws_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), pos_b.data_ptr(), layer_idx, out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(),
            B, H, Hkv, NB, MB, splits, per_split, float(hd) ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.check(lib, rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
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
