"""int8 weight quantization for serving (per-output-channel scales), and the
weight products and embedding lookup for plain and quantized weights.

Counterpart of lws_tpu/models/quant.py:26-126 (without `expert_einsum`:
MoE is not ported). Weights use PyTorch's nn.Linear layout, [out, in]:
`matmul(x, w)` is the JAX package's `x @ w` with w stored transposed. A
quantized product weight is q int8 [F, D] with scale f32 [F] (one per output
channel, amax over the contraction axis / 127), so `(x @ q.T) * scale ==
x @ (q * scale[:, None]).T` exactly; the embedding table [V, D] is quantized
per row (scale [V]) for lookups. In the port's layout every weight's
contraction axis is its last.

Routes of a quantized product (`matmul`): on CUDA with at most 256 rows
(JAX's `supported` rule, lws_tpu/ops/int8_matmul.py:46-50) the int8_matmul
kernel; on CUDA with more rows (prefill buckets 512 and up) the product JAX
leaves to XLA, `(x @ q) * scale` in the compute dtype (quant.py:117); on the
CPU, and with `plain=True`, the kernel's plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

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
    [rows]; `.weight` is their QuantizedArray, so call sites written for
    nn.Linear/nn.Embedding's `.weight` take it unchanged."""

    def __init__(self, rows: int, cols: int, device):
        super().__init__()
        self.register_buffer("q", torch.empty(rows, cols, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(rows, dtype=torch.float32, device=device))

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
            return F.linear(x, w.q.to(dtype)) * w.scale.to(dtype)
        return int8_matmul(x, w.q, w.scale)
    return F.linear(x, w.to(dtype))


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
    built with `quantized=True`, whose product weights and lm_head are
    quantized per output channel and whose embedding table per row; norms
    are copied as they are. The input is untouched."""
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
