"""The flagship serving configuration (lws_tpu/models/flagship.py:39-80).

"full" is the llama-3-8B geometry (vocab 128256, d_model 4096, 32 layers,
32 heads, 8 KV heads, head_dim 128, d_ff 14336, rope theta 500000; about
8.03 B parameters, 16.1 GB in bf16). An 80 GB H100 holds it in bf16, so the
port serves it with bf16 weights (the JAX package needed int8 weights to fit
a 16 GB chip; `init_quantized_params` waits for the int8 slice). "smoke" is
the ~1.1M-parameter miniature with the same structural ratios, in f32, for
CPU tests.
"""

from __future__ import annotations

import torch

from lws_tpu_torch.models.llama import LlamaConfig


def flagship_config(scale: str = "full", *, max_seq_len: int = 2048) -> LlamaConfig:
    """The flagship LlamaConfig at `scale` ("full" | "smoke")."""
    if scale == "full":
        return LlamaConfig(
            vocab_size=128256,
            d_model=4096,
            n_layers=32,
            n_heads=32,
            n_kv_heads=8,
            d_ff=14336,
            rope_theta=500_000.0,
            max_seq_len=max_seq_len,
            dtype=torch.bfloat16,
            param_dtype=torch.bfloat16,
        )
    if scale == "smoke":
        return LlamaConfig(
            vocab_size=512,
            d_model=128,
            n_layers=4,
            n_heads=8,
            n_kv_heads=2,
            d_ff=448,
            max_seq_len=min(max_seq_len, 256),
            dtype=torch.float32,
            param_dtype=torch.float32,
        )
    raise ValueError(f"unknown flagship scale {scale!r}")
