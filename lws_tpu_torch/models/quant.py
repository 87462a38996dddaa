"""int8 weight quantization for serving (per-output-channel scales), and the
weight products and embedding lookup for plain and quantized weights.

Counterpart of lws_tpu/models/quant.py. Weights use PyTorch's nn.Linear
layout, [out, in]:
`matmul(x, w)` is the JAX package's `x @ w` with w stored transposed. A
quantized product weight is q int8 [F, D] with scale f32 [F] (one per output
channel, amax over the contraction axis / 127), so `(x @ q.T) * scale ==
x @ (q * scale[:, None]).T` exactly; the embedding table [V, D] is quantized
per row (scale [V]) for lookups. MoE expert weights stack one such weight
per expert: [E, out, in] with scales [E, out]. In the port's layout every
weight's contraction axis is its last.

Routes of a quantized product (`matmul`): on CUDA with at most 256 rows
(JAX's `supported` rule, lws_tpu/ops/int8_matmul.py:46-50) the int8_matmul
kernel; on CUDA with more rows (prefill buckets 512 and up) the product JAX
leaves to XLA, `(x @ q) * scale` in the compute dtype (quant.py:117); on the
CPU, and with `plain=True`, the kernel's plain version. `expert_einsum`
applies the same rule to each expert's rows: one int8_matmul launch per
expert when the rows fit, else that expert's dequantized product. Each
dequantizing copy is timed as the `dequant` section of the live span
(core/trace.py), with the bf16 bytes it writes as `dequant_bytes`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from lws_tpu_torch.core import trace
from lws_tpu_torch.ops.int8_matmul import MAX_ROWS, int8_matmul, int8_matmul_reference


@dataclass
class QuantizedArray:
    """int8 values + per-output-channel (per-row for embeddings) f32
    dequantization scales: q [F, D], scale [F]."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim


Weight = Union[torch.Tensor, QuantizedArray]


class QuantizedWeight(nn.Module):
    """A quantized weight held as buffers, q int8 [rows, cols] and scale f32
    [rows] (with `n_experts`, q [n_experts, rows, cols] and scale
    [n_experts, rows]); `.weight` is their QuantizedArray, so call sites
    written for nn.Linear/nn.Embedding's `.weight` take it unchanged."""

    def __init__(self, rows: int, cols: int, device, n_experts: int = 0):
        super().__init__()
        lead = (n_experts,) if n_experts else ()
        self.register_buffer("q", torch.empty(*lead, rows, cols, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(*lead, rows, dtype=torch.float32, device=device))

    @property
    def weight(self) -> QuantizedArray:
        return QuantizedArray(self.q, self.scale)


def quantize_array(w: torch.Tensor, contract_axis: int = -1) -> QuantizedArray:
    """Symmetric int8 quantization with scales over `contract_axis`:
    scale = max(amax |w|, 1e-8) / 127, q = clip(round-half-even(w / scale))."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=contract_axis), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(contract_axis)), -127, 127)
    return QuantizedArray(q=q.to(torch.int8), scale=scale)


def dequantize_array(w: QuantizedArray, dtype: torch.dtype, contract_axis: int = -1) -> torch.Tensor:
    return (w.q.float() * w.scale.unsqueeze(contract_axis)).to(dtype)


def dequant_copy(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The `dtype` copy of int8 weight values that a product over MAX_ROWS
    multiplies, timed as the live span's `dequant` section, with the bytes
    it writes added as `dequant_bytes`."""
    with trace.section("dequant") as sec:
        out = q.to(dtype)
        sec.add(dequant_bytes=out.numel() * out.element_size())
    return out


def matmul(x: torch.Tensor, w: Weight, dtype: Optional[torch.dtype] = None,
           plain: bool = False) -> torch.Tensor:
    """x [..., in] @ w.T (w [out, in], plain or quantized) in `dtype`
    (default: x's)."""
    dtype = dtype or x.dtype
    x = x.to(dtype)
    if isinstance(w, QuantizedArray):
        if plain:
            return int8_matmul_reference(x, w.q, w.scale)
        if x.is_cuda and x.numel() // x.shape[-1] > MAX_ROWS:
            return F.linear(x, dequant_copy(w.q, dtype)) * w.scale.to(dtype)
        return int8_matmul(x, w.q, w.scale)
    return F.linear(x, w.to(dtype))


def expert_einsum(x: torch.Tensor, w: Weight, plain: bool = False) -> torch.Tensor:
    """Each expert's rows through its own weight: x [E, ..., in] and w
    [E, out, in] (plain, or quantized with scales [E, out]) -> [E, ..., out]
    in x's dtype. lws_tpu/models/quant.py:expert_einsum, whose
    einsum specs ("ebcd,edf->ebcf", "ebcf,efd->ebcd") this fixes. Plain
    weights: one batched product. Quantized: the plain version (CPU, or
    `plain=True`) is int8_matmul's plain version batched over the experts;
    on CUDA each expert's rows take one int8_matmul launch when they are at
    most MAX_ROWS, else that expert's dequantized product, as `matmul`
    routes (no bf16 copy of every expert is made)."""
    dtype = x.dtype
    E, lead, d_in = x.shape[0], x.shape[1:-1], x.shape[-1]
    x3 = x.reshape(E, -1, d_in)
    if not isinstance(w, QuantizedArray):
        y = torch.bmm(x3, w.to(dtype).transpose(1, 2))
    elif plain or not x3.is_cuda:
        y = ((x3.float() @ w.q.float().transpose(1, 2)) * w.scale[:, None, :]).to(dtype)
    elif x3.shape[1] <= MAX_ROWS:
        x3 = x3.contiguous()
        y = torch.stack([int8_matmul(x3[e], w.q[e], w.scale[e]) for e in range(E)])
    else:
        y = torch.stack([F.linear(x3[e], dequant_copy(w.q[e], dtype)) * w.scale[e].to(dtype)
                         for e in range(E)])
    return y.reshape(E, *lead, y.shape[-1])


def embed_lookup(embed: Weight, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of the [vocab, d] table for `tokens`, in `dtype`; a per-row
    quantized table dequantizes the gathered rows in `dtype`."""
    idx = tokens.long()
    if isinstance(embed, QuantizedArray):
        return embed.q[idx].to(dtype) * embed.scale[idx][..., None].to(dtype)
    return embed[idx].to(dtype)


@torch.no_grad()
def quantize_params(model: nn.Module) -> nn.Module:
    """Quantize a dense model for serving: a new model of the same class
    built with `quantized=True`, whose product weights (each expert's, for
    MoE) and lm_head are quantized per output channel and whose embedding
    table per row; norms and the MoE router are copied as they are. The
    input is untouched. A tensor-parallel shard is refused: a row-parallel
    weight's scale spans every shard, so quantize the full model, then
    shard it."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError("quantize_params: quantize the full model, then shard it")
    out = type(model)(model.cfg, model.device, quantized=True)
    for name, dst in out.named_modules():
        if isinstance(dst, QuantizedWeight):
            qa = quantize_array(model.get_submodule(name).weight)
            dst.q.copy_(qa.q)
            dst.scale.copy_(qa.scale)
    for name, p in out.named_parameters():
        p.copy_(model.get_parameter(name))
    return out


def quantized_bytes(model: torch.nn.Module) -> int:
    """Device bytes of a (possibly quantized) model's tensors, parameters and
    buffers: the honest numerator for decode roofline accounting."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
