"""Sampling for the port's engines (lws_tpu/serving/engine.py:72-143) and the
dense `Engine` core (:162-320, :443-455, :821-886).

JAX's threefry keys become `torch.Generator`s: one per request stream (one
per Engine). The two frameworks draw different numbers from the same seed,
so a sampled stream is reproducible inside the port but never equal to
JAX's; greedy (temperature <= 0) is argmax in both and exact.

The Engine serves one batch of equal-length prompts at a time over a dense
KV cache [L, B, max_len, Hkv, hd] (int8 with scales when cfg.kv_quant),
updated in place: prefill through forward_prefill, decode steps through
forward_with_cache (on CUDA with an int8 cache, the int8 decode kernel; with
quantized weights, the int8_matmul kernel). Left out of this slice: mesh/TP,
chunked and streamed prefill, speculative decoding, telemetry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.models.llama import (
    KVCache,
    Llama,
    LlamaConfig,
    forward_prefill,
    forward_with_cache,
    init_cache,
)
from lws_tpu_torch.serving.pipeline import DecodePipeline


@dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 is greedy; top_k/top_p restrict the candidate set."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  params: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32, one batch-wide parameter set."""
    B = logits.shape[0]
    dev = logits.device
    return sample_logits_per_slot(
        logits, [generator] * B,
        torch.full((B,), params.temperature, dtype=torch.float32, device=dev),
        torch.full((B,), params.top_k, dtype=torch.int32, device=dev),
        torch.full((B,), params.top_p, dtype=torch.float32, device=dev),
    )


def mask_logits_per_slot(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits [B, V] with each slot's top-k mask, then its
    top-p mask on the masked distribution, applied as -inf (the order of
    lws_tpu/serving/engine.py:116-134). top_k 0 (or >= V) and top_p 1.0
    disable their masks; the top-p prefix always keeps at least one token."""
    V = logits.shape[-1]
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype, device=logits.device)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.long() - 1, 0, V - 1)
    kth = sorted_desc.gather(1, k_idx[:, None])
    use_k = (top_k > 0) & (top_k < V)
    scaled = torch.where(use_k[:, None] & (scaled < kth), neg_inf, scaled)

    sorted_masked = torch.sort(scaled, dim=-1, descending=True).values
    cumulative = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    cutoff_idx = torch.clamp((cumulative < top_p[:, None]).sum(dim=-1), 0, V - 1)
    cutoff = sorted_masked.gather(1, cutoff_idx[:, None])
    use_p = top_p < 1.0
    return torch.where(use_p[:, None] & (scaled < cutoff), neg_inf, scaled)


def sample_logits_per_slot(
    logits: torch.Tensor,                   # [B, V]
    generators: Sequence[torch.Generator],  # one stream per slot
    temperature: torch.Tensor,              # [B] f32; <= 0 means greedy for that slot
    top_k: torch.Tensor,                    # [B] int; 0 disables
    top_p: torch.Tensor,                    # [B] f32; 1.0 disables
) -> torch.Tensor:
    """Per-slot sampling for continuous batching: every slot samples with
    its own request's parameters from its own generator; greedy slots take
    the argmax. Every slot's generator advances by one draw per call, greedy
    or not, as every JAX slot key splits per step."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(mask_logits_per_slot(logits, temperature, top_k, top_p).float(), dim=-1)
    sampled = torch.stack([
        torch.multinomial(probs[i], 1, generator=g)[0] for i, g in enumerate(generators)
    ]).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


def host_sync(x: torch.Tensor) -> None:
    """Wait for `x` by copying it to the host (a named fence)."""
    x.cpu()


@dataclass
class GenerationResult:
    tokens: np.ndarray  # [B, steps + 1] on the host: the first token, then each decode step's
    ttft_s: float
    decode_s: float
    decode_steps: int
    decode_tokens_per_s: float


class Engine:
    """Dense-cache batch generation (lws_tpu/serving/engine.py:Engine)."""

    # generate() runs decode_n in chunks of this many steps (and single steps
    # for the remainder), as the JAX engine does.
    DECODE_CHUNK = 32

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Llama,
        batch_size: int = 1,
        max_len: int = 2048,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        pipeline_depth: Optional[int] = None,
        device: DeviceLike = None,
    ):
        """`device` defaults to CUDA (raising without a GPU); `params` must
        already live there. `pipeline_depth` bounds the decode chunks in
        flight in generate(): 2 on CUDA, 0 (synchronous) on the CPU by
        default. One generator seeded from `seed` draws every sample."""
        self.device = resolve_device(device)
        if params.device.type != self.device.type or (
            self.device.index is not None and params.device != self.device
        ):
            raise ValueError(f"params live on {params.device}, the engine on {self.device}")
        if params.cfg != cfg:
            raise ValueError("params were built for another LlamaConfig")
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.sampling = sampling
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if pipeline_depth is None:
            pipeline_depth = 2 if self.device.type == "cuda" else 0
        self.pipeline_depth = pipeline_depth

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.sampling.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_logits(logits, self._gen, self.sampling)

    def new_cache(self) -> KVCache:
        return init_cache(self.cfg, self.batch_size, self.max_len, self.device)

    @torch.no_grad()
    def prefill(self, tokens) -> tuple[torch.Tensor, KVCache]:
        """tokens [B, S] -> (first generated token [B] int32, cache at pos S)."""
        tokens = torch.as_tensor(tokens).to(self.device).long()
        if tokens.shape[1] > self.max_len:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens exceeds max_len {self.max_len}")
        logits, cache = forward_prefill(self.params, tokens, self.new_cache())
        return self._sample(logits), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
        """tokens [B] -> (next token [B], cache), the cache written in place."""
        if cache.pos >= cache.max_len:
            raise ValueError(f"cache full at {cache.pos} tokens")
        logits, cache = forward_with_cache(self.params, tokens[:, None], cache)
        return self._sample(logits), cache

    @torch.no_grad()
    def decode_n(self, tokens: torch.Tensor, cache: KVCache, n: int
                 ) -> tuple[torch.Tensor, KVCache, torch.Tensor]:
        """n chained decode steps launched back to back, with no host sync;
        returns (last token [B], cache, all tokens [B, n])."""
        toks = []
        for _ in range(n):
            tokens, cache = self.decode(tokens, cache)
            toks.append(tokens)
        return tokens, cache, torch.stack(toks, dim=1)

    def generate(self, prompt, max_new_tokens: int) -> GenerationResult:
        """Generation under the engine's SamplingParams (greedy by default):
        prefill (timed to the first token on the host: TTFT), then
        max_new_tokens - 1 decode steps in DECODE_CHUNK-step decode_n chunks
        and single steps, behind the in-flight ring (timed: decode)."""
        steps = max(0, max_new_tokens - 1)
        n_full, rem = divmod(steps, self.DECODE_CHUNK)
        t0 = time.perf_counter()
        token, cache = self.prefill(prompt)
        host_chunks = [token.cpu().numpy()[:, None]]  # the first token's fence: TTFT
        ttft = time.perf_counter() - t0

        t1 = time.perf_counter()
        pipe = DecodePipeline(depth=self.pipeline_depth)
        for _ in range(n_full):
            with pipe.host_section():
                token, cache, toks = self.decode_n(token, cache, self.DECODE_CHUNK)
            pipe.push(self.DECODE_CHUNK, toks, host_chunks.append)
        for _ in range(rem):
            with pipe.host_section():
                token, cache = self.decode(token, cache)
            pipe.push(1, token[:, None], host_chunks.append)
        pipe.flush()
        dt = time.perf_counter() - t1
        return GenerationResult(
            tokens=np.concatenate(host_chunks, axis=1),
            ttft_s=ttft,
            decode_s=dt,
            decode_steps=steps,
            decode_tokens_per_s=(steps * self.batch_size) / dt if steps else 0.0,
        )
