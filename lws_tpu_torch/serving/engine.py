"""Sampling for the port's engines (lws_tpu/serving/engine.py:72-143).

JAX's threefry keys become `torch.Generator`s: one per request stream. The
two frameworks draw different numbers from the same seed, so a sampled
stream is reproducible inside the port but never equal to JAX's; greedy
(temperature <= 0) is argmax in both and exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


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
