"""W8A16 product: the CUDA kernel (csrc/int8_matmul.cu) and its plain PyTorch
version.

Counterpart of lws_tpu/ops/int8_matmul.py: out = (x @ q) * scale with int8
weights and a per-output-channel f32 scale applied to the f32 accumulator
(lws_tpu/ops/int8_matmul.py:43). The port keeps nn.Linear's layout, so q is
[F, D] (out, in) and the product is x @ q.T. JAX's `supported` rule
(m <= 256, decided from shapes) picks the callers' route in
models/quant.py; the kernel itself takes any D and F and masks the ragged
edge.
"""

from __future__ import annotations

import ctypes

import torch

from lws_tpu_torch.ops import _ext

_SIGNATURES = {
    "lws_int8_matmul": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x q scale out
        ctypes.c_void_p,  # f32 split partials (or null)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M D F
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bm splits k_chunk
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # vec_x vec_w stream
    ],
}
MAX_ROWS = 256   # lws_tpu/ops/int8_matmul.py _TM_MAX: the decode-shaped products
_BN, _BK = 64, 128  # the kernel's channel tile and contraction stage


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 product of x and the int8 values, times the
    f32 scale, cast to x's dtype."""
    return ((x.float() @ q.float().T) * scale).to(x.dtype)


def _launch_kernel(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    dev = x.device
    if q.device != dev or scale.device != dev:
        raise ValueError("int8_matmul: x, q and scale must be on one CUDA device")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul: bf16 x, int8 q, f32 scale only "
                        f"(got {x.dtype}/{q.dtype}/{scale.dtype})")
    if q.dim() != 2 or scale.shape != (q.shape[0],) or x.dim() < 1 or x.shape[-1] != q.shape[1]:
        raise ValueError(f"int8_matmul: x [..., D], q [F, D], scale [F]; got x {tuple(x.shape)} "
                         f"q {tuple(q.shape)} scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul: inputs must be contiguous")
    F, D = q.shape
    lead = x.shape[:-1]
    M = x.numel() // D if D else 0
    if M < 1 or M > MAX_ROWS or D < 1 or F < 1:
        raise ValueError(f"int8_matmul: 1 <= rows <= {MAX_ROWS} and nonempty D, F "
                         f"(got rows={M}, D={D}, F={F})")
    bm = 16 if M <= 16 else 64
    # Split D until the first pass fills the card.
    splits, per_split = _ext.split_plan(dev, -(-M // bm) * -(-F // _BN), -(-D // _BK))
    k_chunk = per_split * _BK
    out = torch.empty(*lead, F, dtype=x.dtype, device=dev)
    partial = torch.empty(splits * M * F if splits > 1 else 0, dtype=torch.float32, device=dev)
    vec_x = int(D % 8 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(D % 16 == 0 and q.data_ptr() % 16 == 0)
    lib = _ext.load("int8_matmul", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.lws_int8_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if splits > 1 else None,
            M, D, F, bm, splits, k_chunk, vec_x, vec_w,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.check(lib, rc, "int8_matmul")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., D] times (q int8 [F, D], scale f32 [F]) -> [..., F] in x's
    dtype. CUDA tensors launch the kernel (bf16 x, at most 256 rows) and
    raise on anything it does not take; CPU tensors compute the plain
    version."""
    if x.is_cuda:
        return _launch_kernel(x, q, scale)
    return int8_matmul_reference(x, q, scale)


int8_matmul.launches = 0  # kernel launches since the caller last set it to 0
