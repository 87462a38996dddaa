"""W8A16 product: the CUDA kernel (csrc/int8_matmul.cu) and its plain PyTorch
version.

Counterpart of lws_tpu/ops/int8_matmul.py: out = (x @ q) * scale with int8
weights and a per-output-channel f32 scale applied to the f32 accumulator
(lws_tpu/ops/int8_matmul.py:43). The port keeps nn.Linear's layout, so q is
[F, D] (out, in) and the product is x @ q.T. JAX's `supported` rule
(m <= 256, decided from shapes) picks the callers' route in
models/quant.py; the kernel itself takes any D and F and masks the ragged
edge. `plan` picks the kernel's body and split of D from the shapes alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lws_tpu_torch.ops import _ext

_SIGNATURES = {
    "lws_int8_matmul": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x q scale out
        ctypes.c_void_p, ctypes.c_void_p,  # f32 split partials, tile counters (or null)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M D F
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bm splits k_chunk
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # vec_x vec_w stream
    ],
}
MAX_ROWS = 256   # lws_tpu/ops/int8_matmul.py _TM_MAX: the decode-shaped products
SMALL_ROWS = 16  # up to this many rows the swapped (weight-streaming) body runs
MAX_SPLITS = 8  # the last CTA of a tile sums every split's partial: keep that read short


class Plan(NamedTuple):
    """One launch of the kernel: `bm` rows per tile (8 or 16: the swapped
    small body; 64: the mma.sync body; 128: the wgmma body), `bn` channels
    and `bk` of D per pipeline stage, D split `splits` ways in chunks of
    `k_chunk`, and `counters` tile counters for the in-kernel split
    reduction (0 when D is not split)."""
    bm: int
    bn: int
    bk: int
    splits: int
    k_chunk: int
    counters: int


@functools.lru_cache(maxsize=1024)
def plan(M: int, D: int, F: int, sms: int, aligned: bool = True) -> Plan:
    """The launch for an [M, D] x [F, D] product on a card with `sms` SMs.
    Above 64 rows the wgmma body runs where TMA can read both operands (16-byte
    aligned pointers, D % 16 == 0: `aligned`), the mma.sync body otherwise.

    D is split only when there are fewer output tiles than SMs (with a tile
    for every SM, partials would cost a round trip at the end for no more
    bytes in flight), toward `per_sm` CTAs per SM: the small body needs
    about two for enough loads in flight, the tensor-core bodies one wave.
    The count is then cut to the fewest splits that deal min(blocks,
    MAX_SPLITS) blocks in the same chunks (so 5-7 of 8 become 4: on the
    H100, 5 splits of 32 tiles measured slower than 4), and no split is
    empty."""
    if M <= SMALL_ROWS:
        bm, bn, bk, per_sm = (8 if M <= 8 else 16), 64, 128, 2
    else:
        wg = M > 64 and aligned and D % 16 == 0
        bm, bn, bk, per_sm = (128 if wg else 64), 128, 64, 1
    tiles = -(-M // bm) * -(-F // bn)
    blocks = -(-D // bk)
    splits = 1
    if tiles < sms:
        cap = min(blocks, MAX_SPLITS)
        want = min(cap, -(-per_sm * sms // tiles))
        splits = -(-cap // -(-cap // want))
    per_split = -(-blocks // splits)
    splits = -(-blocks // per_split)  # no empty split
    return Plan(bm, bn, bk, splits, per_split * bk, tiles if splits > 1 else 0)


# Tile counters by (device, stream): products on two streams may run at
# once, and each takes its tickets from counter 0 up.
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _tile_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n zeroed int32 counters for launches on `stream` of `dev`,
    zeroed once when made (on that stream): the kernel leaves every counter
    it takes at 0 for the next launch on the stream."""
    buf = _counters.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _counters[dev, stream] = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
    return buf


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
    p = plan(M, D, F, _ext.sm_count(dev), x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(*lead, F, dtype=x.dtype, device=dev)
    partial = counters = None  # the split reduction's scratch, when D is split
    if p.splits > 1:
        partial = torch.empty(p.splits * M * F, dtype=torch.float32, device=dev)
        counters = _tile_counters(dev, stream, p.counters)
    vec_x = int(D % 8 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(D % 16 == 0 and q.data_ptr() % 16 == 0)
    lib = _ext.load("int8_matmul", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.lws_int8_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            counters.data_ptr() if counters is not None else None,
            M, D, F, p.bm, p.splits, p.k_chunk, vec_x, vec_w, stream,
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
