"""The flagship serving configuration (lws_tpu/models/flagship.py).

"full" is the llama-3-8B geometry (vocab 128256, d_model 4096, 32 layers,
32 heads, 8 KV heads, head_dim 128, d_ff 14336, rope theta 500000; about
8.03 B parameters). The JAX package serves it with int8 weights
(`init_quantized_params`, about 8.0 GB) and optionally an int8 KV cache
(`kv_quant=True`); the port serves it either that way or in bf16 (16.1 GB
of weights, which an 80 GB H100 also holds). "smoke" is the ~1.1M-parameter
miniature with the same structural ratios, in f32, for CPU tests.

`init_quantized_params` draws each weight directly as int8 values on the
device, never through a bf16 tree, with flat per-channel scales chosen to
reproduce the magnitude statistics of `init_params` (uniform int8 has rms
254/sqrt(12) ~= 73.3, so scale = fan_in**-0.5 / 73.3 gives a dequantized rms
of fan_in**-0.5). The weights are random either way; what matters is the
exact byte widths, shapes and dataflow.
"""

from __future__ import annotations

from typing import Optional

import torch

from lws_tpu_torch._device import DeviceLike
from lws_tpu_torch.models.llama import Llama, LlamaConfig
from lws_tpu_torch.models.quant import quantized_bytes

# rms of ints drawn uniformly from [-127, 127].
_INT8_UNIFORM_RMS = 254.0 / (12.0 ** 0.5)


def flagship_config(scale: str = "full", *, kv_quant: bool = False,
                    max_seq_len: int = 2048) -> LlamaConfig:
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
            remat=False,
            kv_quant=kv_quant,
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
            remat=False,
            kv_quant=kv_quant,
        )
    raise ValueError(f"unknown flagship scale {scale!r}")


@torch.no_grad()
def init_quantized_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                          device: DeviceLike = None) -> Llama:
    """Random int8-weight model with the exact structure and dtypes of
    `quantize_params(init_params(cfg))`, drawn from `generator` (seed 0 on
    the model's device if None) directly into the int8 buffers: values
    uniform in [-127, 127], flat scales fan_in**-0.5 / 73.3, wo and w_down
    further damped by (2L)**-0.5 (lws_tpu/models/flagship.py:83-118). On
    device="meta" nothing is allocated or drawn: the shapes alone."""
    if cfg.n_experts:
        # As in the JAX package: this draws the dense flagship's leaves only.
        raise ValueError("init_quantized_params: dense configs only (no router or experts)")
    model = Llama(cfg, device, quantized=True)
    dev = model.device
    if dev.type == "meta":
        return model
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def fill(w, fan_in: int, damp: float = 1.0) -> None:
        w.q.random_(-127, 128, generator=generator)
        w.scale.fill_(fan_in**-0.5 * damp / _INT8_UNIFORM_RMS)

    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    depth_damp = (2 * L) ** -0.5  # matches init_params' wo/w_down damping
    for blk in model.layers:
        fill(blk.wq, d)
        fill(blk.wk, d)
        fill(blk.wv, d)
        fill(blk.wo, cfg.n_heads * cfg.head_dim, depth_damp)
        fill(blk.w_gate, d)
        fill(blk.w_up, d)
        fill(blk.w_down, f, depth_damp)
    fill(model.embed, 1)
    fill(model.lm_head, d)
    return model


def kv_row_bytes(cfg: LlamaConfig) -> int:
    """Device bytes one cached token costs across all layers (K + V,
    including the f32 scales when cfg.kv_quant)."""
    per = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
    if cfg.kv_quant:
        return per + 2 * cfg.n_layers * cfg.n_kv_heads * 4  # int8 + f32 scales
    return per * torch.empty((), dtype=cfg.dtype).element_size()


def memory_plan(cfg: LlamaConfig, params: Llama, slots: int, tokens_per_slot: int) -> dict:
    """Sizing arithmetic for a serving config (lws_tpu/models/flagship.py:130)."""
    row = kv_row_bytes(cfg)
    return {
        "param_gb": round(quantized_bytes(params) / 1e9, 2),
        "kv_gb": round(slots * tokens_per_slot * row / 1e9, 2),
        "kv_row_kb_per_token": round(row / 1e3, 1),
        "slots": slots,
        "tokens_per_slot": tokens_per_slot,
    }
