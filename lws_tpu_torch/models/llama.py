"""Llama-class decoder, serving subset: the port of lws_tpu/models/llama.py
that the paged continuous-batching path and the dense Engine run.

Parameters live in `nn.Module`s (`Llama` holding one `LlamaBlock` per
layer, weights in nn.Linear's [out, in] layout, or int8 `QuantizedWeight`s
with per-output-channel scales when built with `quantized=True`); the
forward functions are plain functions over a module and tensors, mirroring
the JAX functions of the same names. Caches are updated IN PLACE (JAX
returns new arrays): the pool is the largest tensor of a server after the
weights, and an in-place write is what the JAX package's buffer donation
buys it. With cfg.kv_quant the caches hold int8 K/V with per-(token, kv
head) f32 scales.

On CUDA tensors the kernels run: the flash kernel (prefill), the paged-decode
kernel (bf16 or int8 pool), the int8 dense-cache decode kernel, and the
int8_matmul kernel for quantized products of at most 256 rows; on CPU
tensors, their plain versions. `plain=True` runs the plain versions on any
device, products included; it exists so a comparison can hold the kernel
path against the plain path on the card, and the engines never pass it.

Left out here (lws_tpu/models/llama.py names): MoE, ring/context parallel,
forward/loss_fn, forward_prefill_chunk, forward_decode_slotted, the
speculative functions and all sharding specs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.models.quant import QuantizedWeight, embed_lookup, matmul
from lws_tpu_torch.ops.attention import attention, reference_attention
from lws_tpu_torch.ops.int8_attention import (
    int8_decode_attention,
    int8_decode_attention_reference,
)
from lws_tpu_torch.ops.paged_attention import (
    cached_attention as _cached_attention,
    dequantize_kv as _dequantize_kv,
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_int8_reference,
    paged_decode_attention_reference,
)

__all__ = [
    "LlamaConfig", "Llama", "LlamaBlock", "init_params", "rms_norm", "rope",
    "rope_tables", "apply_rope",
    "KVCache", "init_cache", "forward_prefill", "forward_with_cache", "PagedKVCache",
    "init_paged_cache", "paged_insert", "forward_decode_paged", "_cached_attention",
    "_quantize_kv", "_dequantize_kv", "LAYER_PRODUCTS", "LAYER_NORMS",
]

LAYER_PRODUCTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LAYER_NORMS = ("attn_norm", "ffn_norm")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 5632
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32
    # Serving: store the KV cache as int8 with per-(token, kv head) f32 scales.
    kv_quant: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def n_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim \
            + self.n_heads * self.head_dim * d
        per_layer = attn + 3 * d * f + 2 * d
        return v * d * 2 + self.n_layers * per_layer + d


# ---------------------------------------------------------------------------
# Blocks


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize in f32, cast back, then scale in x's dtype (the cast order
    of lws_tpu/models/llama.py:186-189)."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * weight.to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [B, S, 1, hd/2] in f32 for `positions` [B, S]. A forward
    builds them once and every layer reuses them."""
    exponents = -torch.arange(0, hd // 2, dtype=torch.float32, device=positions.device) / (hd // 2)
    freqs = torch.pow(theta, exponents)  # a Python base: no host-to-device copy
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]: rotate-half RoPE in f32 with tables from rope_tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd], positions [B, S]: rotate-half RoPE in f32
    (lws_tpu/models/llama.py:192)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _linear(d_in: int, d_out: int, device, dtype, quantized: bool = False) -> nn.Module:
    """A product weight [d_out, d_in]: nn.Linear in `dtype`, or int8 with
    per-output-channel scales. Not initialized: init_params,
    init_quantized_params or the weight bridge writes it."""
    if quantized:
        return QuantizedWeight(d_out, d_in, device)
    return nn.utils.skip_init(nn.Linear, d_in, d_out, bias=False, device=device, dtype=dtype)


class LlamaBlock(nn.Module):
    """One decoder layer: RMSNorm, GQA attention with RoPE, RMSNorm, SwiGLU
    FFN, both with residuals (lws_tpu/models/llama.py:_block_core, dense)."""

    def __init__(self, cfg: LlamaConfig, device: torch.device, quantized: bool = False):
        super().__init__()
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
        pd = cfg.param_dtype
        self.n_heads, self.n_kv_heads, self.head_dim = cfg.n_heads, cfg.n_kv_heads, hd
        self.norm_eps = cfg.norm_eps
        self.attn_norm = nn.Parameter(torch.ones(d, dtype=pd, device=device))
        self.wq = _linear(d, cfg.n_heads * hd, device, pd, quantized)
        self.wk = _linear(d, cfg.n_kv_heads * hd, device, pd, quantized)
        self.wv = _linear(d, cfg.n_kv_heads * hd, device, pd, quantized)
        self.wo = _linear(cfg.n_heads * hd, d, device, pd, quantized)
        self.ffn_norm = nn.Parameter(torch.ones(d, dtype=pd, device=device))
        self.w_gate = _linear(d, f, device, pd, quantized)
        self.w_up = _linear(d, f, device, pd, quantized)
        self.w_down = _linear(f, d, device, pd, quantized)

    def forward(self, x: torch.Tensor, rope_cs: tuple[torch.Tensor, torch.Tensor],
                attn_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
                plain: bool = False) -> torch.Tensor:
        """x [B, S, D] -> [B, S, D]; `rope_cs` = rope_tables(positions) for
        x's positions; `attn_fn(q, k, v)` is the one step the forward
        variants (prefill, cached, paged decode) parameterize; `plain` sends
        quantized products through int8_matmul's plain version."""
        B, S, _ = x.shape
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        h = rms_norm(x, self.attn_norm, self.norm_eps)
        q = matmul(h, self.wq.weight, plain=plain).reshape(B, S, nh, hd)
        k = matmul(h, self.wk.weight, plain=plain).reshape(B, S, nkv, hd)
        v = matmul(h, self.wv.weight, plain=plain).reshape(B, S, nkv, hd)
        q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)
        attn = attn_fn(q, k, v).reshape(B, S, nh * hd)
        x = x + matmul(attn, self.wo.weight, plain=plain)
        h = rms_norm(x, self.ffn_norm, self.norm_eps)
        y = matmul(F.silu(matmul(h, self.w_gate.weight, plain=plain))
                   * matmul(h, self.w_up.weight, plain=plain),
                   self.w_down.weight, plain=plain)
        return x + y


class Llama(nn.Module):
    """The decoder's parameters: embed [V, D], layers, final norm, lm_head
    (D -> V, [V, D] as nn.Linear keeps it). Built uninitialized on `device`
    (CUDA by default); `init_params` or `models.convert.params_from_jax`
    fills it. With `quantized=True` every product weight, the lm_head and
    the embedding table are int8 `QuantizedWeight`s (the layout of
    lws_tpu/models/quant.py:quantize_params) and only the norms stay
    parameters; `init_quantized_params`, `quantize_params` or the weight
    bridge fills it."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None, quantized: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.quantized = quantized
        pd = cfg.param_dtype
        if quantized:
            self.embed = QuantizedWeight(cfg.vocab_size, cfg.d_model, device)
        else:
            self.embed = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, cfg.d_model,
                                            device=device, dtype=pd)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device, quantized)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=pd, device=device))
        self.lm_head = _linear(cfg.d_model, cfg.vocab_size, device, pd, quantized)
        self.requires_grad_(False)  # serving only: no autograd graph on any forward

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def logits(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """Final norm + lm_head in the compute dtype, returned as f32."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return matmul(x, self.lm_head.weight, plain=plain).float()


@torch.no_grad()
def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Llama:
    """Random dense weights with the scales of lws_tpu/models/llama.py:86-124
    (N(0,1) * fan_in**-0.5; wo and w_down further damped by (2L)**-0.5;
    embed unscaled; norms ones), drawn from `generator` (seed 0 if None) in
    f32 on `device` and stored in cfg.param_dtype. The streams differ from
    jax.random's: tests that compare with JAX convert JAX's weights instead."""
    model = Llama(cfg, device)
    dev = model.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def fill(w: torch.Tensor, fan_in: int, damp: float = 1.0) -> None:
        draw = torch.randn(w.shape, generator=generator, device=dev, dtype=torch.float32)
        w.copy_(draw.mul_(fan_in**-0.5 * damp))

    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    depth_damp = (2 * L) ** -0.5
    for blk in model.layers:
        fill(blk.wq.weight, d)
        fill(blk.wk.weight, d)
        fill(blk.wv.weight, d)
        fill(blk.wo.weight, cfg.n_heads * cfg.head_dim, depth_damp)
        fill(blk.w_gate.weight, d)
        fill(blk.w_up.weight, d)
        fill(blk.w_down.weight, f, depth_damp)
    fill(model.embed.weight, 1)
    fill(model.lm_head.weight, d)
    return model


# ---------------------------------------------------------------------------
# Dense KV cache (the prefill cache, and the dense Engine's cache)


@dataclass
class KVCache:
    """k/v [L, B, T, Hkv, hd]; pos = tokens filled. With cfg.kv_quant, k/v
    are int8 and k_scale/v_scale [L, B, T, Hkv] hold the per-(token, kv
    head) dequantization scales."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device: DeviceLike = None) -> KVCache:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device))


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., hd] -> (int8 values, per-(...) amax/127 scales)
    (lws_tpu/models/llama.py:475)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _write_kv(cache, layer_idx: int, index: tuple, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write K/V rows into `cache` (dense or paged) at cache.k[layer_idx][index],
    quantizing them first when the cache holds int8."""
    if cache.k_scale is not None:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        cache.k[layer_idx][index] = kq
        cache.v[layer_idx][index] = vq
        cache.k_scale[layer_idx][index] = ks
        cache.v_scale[layer_idx][index] = vs
    else:
        cache.k[layer_idx][index] = k.to(cache.k.dtype)
        cache.v[layer_idx][index] = v.to(cache.v.dtype)


@torch.no_grad()
def forward_prefill(params: Llama, tokens: torch.Tensor, cache: KVCache,
                    last_pos: Optional[int] = None, plain: bool = False
                    ) -> tuple[torch.Tensor, KVCache]:
    """Prefill an EMPTY cache (pos == 0) with tokens [B, S]: plain causal
    attention over the prompt (the flash kernel on CUDA), each layer's K/V
    written into cache[:, :, :S] in place (quantized per token and head for
    an int8 cache, the same values as JAX's whole-stack quantization).
    Returns (logits [B, V] f32 at `last_pos` — the true last token of a
    padded prompt; S-1 if None — and the cache with pos advanced to
    last_pos+1). lws_tpu/models/llama.py:622."""
    cfg = params.cfg
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embed_lookup(params.embed.weight, tokens, cfg.dtype)
    attn_op = reference_attention if plain else attention
    for layer_idx, block in enumerate(params.layers):

        def attn_fn(q, k, v, layer_idx=layer_idx):
            _write_kv(cache, layer_idx, (slice(None), slice(0, S)), k, v)
            return attn_op(q, k, v, causal=True)

        x = block(x, rope_cs, attn_fn, plain)
    if last_pos is None:
        last, advanced = x[:, -1], S
    else:
        last, advanced = x[:, int(last_pos)], int(last_pos) + 1
    cache.pos += advanced
    return params.logits(last, plain), cache


@torch.no_grad()
def forward_with_cache(params: Llama, tokens: torch.Tensor, cache: KVCache,
                       plain: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Append tokens [B, S] at cache.pos; returns (logits for the LAST token
    [B, V] f32, the cache with pos advanced by S). Each layer writes its K/V
    at [pos, pos + S) in place, then its queries attend to keys <= their
    position. lws_tpu/models/llama.py:561 (_block_with_cache :504): with an
    int8 cache and S == 1 the int8 decode kernel on CUDA; with an int8 cache
    otherwise, the dequantized layer through cached attention; with a bf16
    cache, cached attention (the path JAX leaves to XLA)."""
    cfg = params.cfg
    B, S = tokens.shape
    pos = cache.pos
    positions = pos + torch.arange(S, device=tokens.device).expand(B, S)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embed_lookup(params.embed.weight, tokens, cfg.dtype)
    decode_op = int8_decode_attention_reference if plain else int8_decode_attention
    for layer_idx, block in enumerate(params.layers):

        def attn_fn(q, k, v, layer_idx=layer_idx):
            _write_kv(cache, layer_idx, (slice(None), slice(pos, pos + S)), k, v)
            if cache.k_scale is None:
                return _cached_attention(q, cache.k[layer_idx], cache.v[layer_idx], pos)
            layer = (cache.k[layer_idx], cache.k_scale[layer_idx],
                     cache.v[layer_idx], cache.v_scale[layer_idx])
            if S == 1:
                return decode_op(q, *layer, pos)
            return _cached_attention(q, _dequantize_kv(layer[0], layer[1], cfg.dtype),
                                     _dequantize_kv(layer[2], layer[3], cfg.dtype), pos)

        x = block(x, rope_cs, attn_fn, plain)
    cache.pos += S
    return params.logits(x[:, -1], plain), cache


# ---------------------------------------------------------------------------
# Paged KV cache


@dataclass
class PagedKVCache:
    """k/v pools [L, num_blocks, block_size, Hkv, hd]. Block 0 is the NULL
    block: unallocated table entries point at it, its contents are never
    attendable (positions mask them), and inactive slots' dead writes land
    there. With cfg.kv_quant, k/v are int8 and k_scale/v_scale
    [L, num_blocks, block_size, Hkv] hold the per-(token, kv head) scales."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]


def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
                     device: DeviceLike = None) -> PagedKVCache:
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        return PagedKVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                            v=torch.zeros(shape, dtype=torch.int8, device=device),
                            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return PagedKVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                        v=torch.zeros(shape, dtype=cfg.dtype, device=device))


@torch.no_grad()
def paged_insert(cache: PagedKVCache, stacked_k: torch.Tensor, stacked_v: torch.Tensor,
                 block_ids: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Scatter a prefilled sequence's K/V [L, S, Hkv, hd] (S a multiple of
    block_size) into pool blocks `block_ids` [S/bs], in place. A quantized
    pool takes the prefill cache's int8 values WITH their scales [L, S, Hkv]:
    values are never re-quantized on the way in."""
    L, S = stacked_k.shape[0], stacked_k.shape[1]
    bs = cache.block_size
    if S % bs or block_ids.numel() != S // bs:
        raise ValueError(f"paged_insert: {S} rows do not fill {block_ids.numel()} blocks of {bs}")
    if cache.k_scale is not None and (k_scale is None or v_scale is None):
        raise ValueError("quantized paged pool: insert requires k_scale/v_scale")
    idx = block_ids.long()
    cache.k[:, idx] = stacked_k.reshape(L, S // bs, bs, *stacked_k.shape[2:]).to(cache.k.dtype)
    cache.v[:, idx] = stacked_v.reshape(L, S // bs, bs, *stacked_v.shape[2:]).to(cache.v.dtype)
    if cache.k_scale is not None:
        cache.k_scale[:, idx] = k_scale.reshape(L, S // bs, bs, -1)
        cache.v_scale[:, idx] = v_scale.reshape(L, S // bs, bs, -1)
    return cache


@torch.no_grad()
def forward_decode_paged(params: Llama, tokens: torch.Tensor, cache: PagedKVCache,
                         block_table: torch.Tensor, pos_b: torch.Tensor, plain: bool = False
                         ) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step over paged slots: tokens [B], block_table [B,
    max_blocks] int32, pos_b [B] int32 (each slot's current length). Each
    layer writes the new K/V at (table[b, pos//bs], pos % bs) in place
    (quantized for an int8 pool), then attends through the paged-decode
    kernel (CUDA; the bf16 or the int8 entry) or its plain version (gather,
    dequantize, dense attention). Returns (logits [B, V] f32, cache).
    lws_tpu/models/llama.py:877."""
    cfg = params.cfg
    bs = cache.block_size
    rope_cs = rope_tables(pos_b[:, None], cfg.head_dim, cfg.rope_theta)
    x = embed_lookup(params.embed.weight, tokens[:, None], cfg.dtype)
    # pos < max_len keeps pos//bs inside the table; the clamp only keeps a
    # bad caller from reading past it.
    blk_idx = torch.clamp(pos_b.long() // bs, max=block_table.shape[1] - 1)
    write_blk = block_table.long().gather(1, blk_idx[:, None])[:, 0]
    write_off = pos_b.long() % bs
    if cache.k_scale is None:
        attn_op = paged_decode_attention_reference if plain else paged_decode_attention
    else:
        attn_op = paged_decode_attention_int8_reference if plain else paged_decode_attention_int8
    for layer_idx, block in enumerate(params.layers):

        def attn_fn(q, k, v, layer_idx=layer_idx):
            _write_kv(cache, layer_idx, (write_blk, write_off), k[:, 0], v[:, 0])
            if cache.k_scale is None:
                return attn_op(q, cache.k, cache.v, block_table, pos_b, layer_idx)
            return attn_op(q, cache.k, cache.k_scale, cache.v, cache.v_scale, block_table,
                           pos_b, layer_idx)

        x = block(x, rope_cs, attn_fn, plain)
    return params.logits(x[:, -1], plain), cache
