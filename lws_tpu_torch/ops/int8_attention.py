"""Decode attention over a dense int8 KV cache: the CUDA kernel
(csrc/int8_attention.cu) and its plain PyTorch version.

Counterpart of lws_tpu/ops/int8_attention.py: q [B, 1, H, hd] attends to one
layer of the cache in its own layout, int8 [B, T, Hkv, hd] with f32 scales
[B, T, Hkv]; keys at positions > pos (an int for the whole batch, or a [B]
tensor) are masked, the contract of `cached_attention` with S=1.
"""

from __future__ import annotations

import ctypes

import torch

from lws_tpu_torch.ops import _ext
from lws_tpu_torch.ops.attention import HEAD_DIM
from lws_tpu_torch.ops.paged_attention import (
    BLOCK_SIZE,
    MAX_SLOTS,
    cached_attention,
    decode_grid,
    decode_prefer,
    decode_scratch,
    dequantize_kv,
    load_decode_library,
    scratch_items,
)

_SIGNATURES = {
    "lws_int8_decode_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k k_scale
        ctypes.c_void_p, ctypes.c_void_p,  # v v_scale
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # pos (or null) pos_all out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # chunk partials: acc, (m, l); tickets
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B T H Hkv
        ctypes.c_int, ctypes.c_int,  # grid prefer
        ctypes.c_float, ctypes.c_void_p,  # scale stream
    ],
    "lws_decode_chunk_sizes": [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int],
}


def int8_decode_attention_reference(q, k, k_scale, v, v_scale, pos) -> torch.Tensor:
    """The plain version: dequantize the layer to q's dtype, then dense
    cached attention (lws_tpu/models/llama.py:541-543)."""
    return cached_attention(q, dequantize_kv(k, k_scale, q.dtype),
                            dequantize_kv(v, v_scale, q.dtype), pos)


def _launch_kernel(q, k, k_scale, v, v_scale, pos) -> torch.Tensor:
    dev = q.device
    per_row = isinstance(pos, torch.Tensor)
    tensors = (k, k_scale, v, v_scale) + ((pos,) if per_row else ())
    if not all(t.device == dev for t in tensors):
        raise ValueError("int8_decode_attention: all inputs must be on one CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"int8_decode_attention: bf16 q, int8 k/v only "
                        f"(got {q.dtype}/{k.dtype}/{v.dtype})")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("int8_decode_attention: f32 scales only")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"int8_decode_attention: q must be [B,1,H,hd], got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B:
        raise ValueError("int8_decode_attention: k/v must be [B,T,Hkv,hd] and equal")
    T, Hkv = k.shape[1], k.shape[2]
    if k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
        raise ValueError(f"int8_decode_attention: scales must be [B,T,Hkv] = {tuple(k.shape[:3])}")
    if hd != HEAD_DIM or k.shape[3] != HEAD_DIM:
        raise ValueError(f"int8_decode_attention: head dim {HEAD_DIM} only")
    if Hkv < 1 or H % Hkv or H // Hkv > 32 or T < 1:
        raise ValueError(f"int8_decode_attention: need Hkv | H, H/Hkv <= 32 and T >= 1 "
                         f"(H={H}, Hkv={Hkv}, T={T})")
    if per_row and (pos.dtype != torch.int32 or pos.shape != (B,)):
        raise ValueError("int8_decode_attention: pos must be an int or an int32 [B] tensor")
    if not all(t.is_contiguous() for t in (q,) + tensors):
        raise ValueError("int8_decode_attention: inputs must be contiguous")
    if B > MAX_SLOTS:
        raise ValueError(f"int8_decode_attention: at most {MAX_SLOTS} rows, got {B}")
    # The kernel plans the live blocks of every row on the device, from pos
    # or from the scalar position; the grid and scratch depend on shapes only.
    blocks = -(-T // BLOCK_SIZE)
    sms = _ext.sm_count(dev)
    grid = decode_grid(B, Hkv, blocks, sms, quant=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    items = scratch_items(B, Hkv, blocks, grid)
    part_acc, part_ml, tickets = decode_scratch(dev, stream, items, H // Hkv, B * Hkv)
    out = torch.empty_like(q)
    lib = load_decode_library("int8_attention", _SIGNATURES, quant=True)
    with torch.cuda.device(dev):
        rc = lib.lws_int8_decode_attention(
            q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(),
            pos.data_ptr() if per_row else None, 0 if per_row else min(max(int(pos), 0), T - 1),
            out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
            B, T, H, Hkv, grid, decode_prefer(sms, grid), float(hd) ** -0.5, stream,
        )
    _ext.check(lib, rc, "int8_decode_attention")
    int8_decode_attention.launches += 1
    return out


def int8_decode_attention(q, k, k_scale, v, v_scale, pos) -> torch.Tensor:
    """[B, 1, H, hd] in q's dtype. CUDA tensors launch the kernel (bf16 q,
    hd 128) and raise on anything it does not take; CPU tensors compute the
    plain version."""
    if q.is_cuda:
        return _launch_kernel(q, k, k_scale, v, v_scale, pos)
    return int8_decode_attention_reference(q, k, k_scale, v, v_scale, pos)


int8_decode_attention.launches = 0  # kernel launches since the caller last set it to 0
