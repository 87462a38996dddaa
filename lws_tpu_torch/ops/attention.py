"""Prefill attention: the CUDA flash kernel (csrc/flash_attention.cu) and its
plain PyTorch version.

Counterpart of lws_tpu/ops/attention.py. Layout is the JAX package's:
q [B, S, H, D], k/v [B, Skv, Hkv, D] with Hkv | H (grouped-query attention;
query head h reads kv head h // (H // Hkv)).
"""

from __future__ import annotations

import ctypes

import torch

from lws_tpu_torch.ops import _ext

NEG_INF = -1e30

_SIGNATURES = {
    "lws_flash_attention_fwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S Skv H Hkv
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,  # causal scale stream
    ],
}
HEAD_DIM = 128  # the kernel's compiled head dim


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain GQA attention with an f32 softmax (lws_tpu/ops/attention.py:21):
    scores in the input dtype cast to f32 and scaled, probabilities cast back
    to v's dtype. The causal mask aligns query i with key i."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * D**-0.5
    if causal:
        Sk = k.shape[1]
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, S, H, D)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Launch the CUDA flash kernel: q [B,S,H,128], k/v [B,Skv,Hkv,128],
    contiguous bf16 on one CUDA device -> [B,S,H,128] bf16. Ragged S/Skv
    are masked inside the kernel. Raises on anything it does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be CUDA tensors on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention: bf16 only, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q [B,S,H,D], k/v [B,Skv,Hkv,D]")
    B, S, H, D = q.shape
    _, Skv, Hkv, Dk = k.shape
    if D != HEAD_DIM or Dk != HEAD_DIM or k.shape[0] != B:
        raise ValueError(f"flash_attention: head dim {HEAD_DIM} and matching batch, "
                         f"got q {tuple(q.shape)} k {tuple(k.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: n_kv_heads {Hkv} must divide n_heads {H}")
    if S < 1 or Skv < 1:
        raise ValueError("flash_attention: empty sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _ext.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.lws_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Skv, H, Hkv, int(causal), float(D) ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _ext.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the caller last set it to 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Prefill attention: the CUDA flash kernel for CUDA tensors, the plain
    version for CPU tensors (lws_tpu/ops/attention.py:143)."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal)
    return reference_attention(q, k, v, causal)
