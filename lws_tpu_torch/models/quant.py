"""Weight products and embedding lookup for plain (unquantized) weights.

Counterpart of lws_tpu/models/quant.py:94-126 without `QuantizedArray`
(int8 weights are a later slice). Weights use PyTorch's nn.Linear layout,
[out_features, in_features]: `matmul(x, w)` is the JAX package's `x @ w`
with w stored transposed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., in] @ w.T (w [out, in]) in `dtype` (default: x's)."""
    dtype = dtype or x.dtype
    return F.linear(x.to(dtype), w.to(dtype))


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of the [vocab, d] table for `tokens`, in `dtype`."""
    return embed[tokens.long()].to(dtype)
