"""Composable workload mixes: the port's copy of lws_tpu/loadgen/workload.py,
whole. WHAT arrives, once arrivals.py decided when.

A scenario's traffic is a weighted mix of workload CLASSES (tenant tiers,
chat vs long-context, interactive vs batch), each with its own prompt- and
output-length distributions, its own SLO targets (core/slo.py threads the
class label through every engine's series), and a shared-prefix ratio that
exercises the paged engine's prefix cache the way fleet traffic with a
common system prompt does.

Same determinism contract as arrivals.py: every draw comes from the one
`random.Random` stream the schedule builder owns, in a FIXED order
(class pick, prompt length, output length, prefix pick, prompt tokens per
request) — so a seed reproduces the whole schedule byte for byte.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from lws_tpu_torch.core.slo import SLOTargets


@dataclass(frozen=True)
class LengthDist:
    """A token-length distribution: `fixed` (always `value`), `uniform`
    (inclusive lo..hi), or `choice` (pick from `choices` — the simplest way
    to model a bimodal chat-length vs long-context split inside one
    class)."""

    kind: str = "fixed"
    value: int = 8
    lo: int = 1
    hi: int = 8
    choices: tuple = ()

    @classmethod
    def from_spec(cls, spec) -> "LengthDist":
        if isinstance(spec, int):
            return cls(kind="fixed", value=spec)
        kind = spec.get("kind", "fixed")
        if kind == "fixed":
            return cls(kind="fixed", value=int(spec["value"]))
        if kind == "uniform":
            return cls(kind="uniform", lo=int(spec["lo"]), hi=int(spec["hi"]))
        if kind == "choice":
            return cls(kind="choice", choices=tuple(int(c) for c in spec["choices"]))
        raise ValueError(f"unknown length distribution {kind!r}")

    def sample(self, rng: random.Random) -> int:
        if self.kind == "fixed":
            return self.value
        if self.kind == "uniform":
            # Derived from the raw stream (not randint) so the draw count
            # per request is exactly one — part of the byte-reproducibility
            # contract.
            return self.lo + int(rng.random() * (self.hi - self.lo + 1))
        return self.choices[int(rng.random() * len(self.choices))]

    def max(self) -> int:
        if self.kind == "fixed":
            return self.value
        if self.kind == "uniform":
            return self.hi
        return max(self.choices)


@dataclass(frozen=True)
class WorkloadClass:
    """One traffic class in the mix. `weight` is its share of arrivals;
    `shared_prefix_ratio` the fraction of its prompts that begin with one
    of the scenario's pooled prefixes (prefix-cache exercise); `targets`
    its SLO override (None = the engine-wide targets)."""

    name: str
    weight: float = 1.0
    prompt_len: LengthDist = field(default_factory=LengthDist)
    output_len: LengthDist = field(default_factory=lambda: LengthDist(value=4))
    shared_prefix_ratio: float = 0.0
    targets: Optional[SLOTargets] = None

    @classmethod
    def from_spec(cls, spec: dict, base_targets: SLOTargets) -> "WorkloadClass":
        targets = None
        if spec.get("targets"):
            targets = base_targets.overridden(dict(spec["targets"]))
        return cls(
            name=str(spec["name"]),
            weight=float(spec.get("weight", 1.0)),
            prompt_len=LengthDist.from_spec(spec.get("prompt_len", 8)),
            output_len=LengthDist.from_spec(spec.get("output_len", 4)),
            shared_prefix_ratio=float(spec.get("shared_prefix_ratio", 0.0)),
            targets=targets,
        )


@dataclass(frozen=True)
class ScheduledRequest:
    """One fully-materialized request of a scenario schedule: everything a
    target needs, decided up front so the schedule is committable and
    byte-reproducible. `arrival_s` is in scenario time."""

    index: int
    arrival_s: float
    klass: str
    prompt: np.ndarray  # int32 token ids
    max_new_tokens: int
    shared_prefix: bool = False


def pick_class(classes: list[WorkloadClass], rng: random.Random) -> WorkloadClass:
    """Weighted class assignment from one `rng.random()` draw."""
    total = sum(c.weight for c in classes)
    u = rng.random() * total
    acc = 0.0
    for c in classes:
        acc += c.weight
        if u < acc:
            return c
    return classes[-1]


def build_prefix_pool(rng: random.Random, pool_size: int, prefix_len: int,
                      vocab: int) -> list[np.ndarray]:
    """The scenario's shared prefixes (system prompts), drawn ONCE before
    any request so the pool is stable across the schedule."""
    return [
        np.array([1 + int(rng.random() * (vocab - 1)) for _ in range(prefix_len)],
                 dtype=np.int32)
        for _ in range(pool_size)
    ]


def build_prompt(rng: random.Random, length: int, vocab: int,
                 prefix: Optional[np.ndarray] = None) -> np.ndarray:
    """`length` tokens in [1, vocab), optionally starting with `prefix`
    (truncated if the prompt is shorter — the suffix then still diverges,
    so a prefix hit never collapses two requests into one)."""
    if prefix is not None and len(prefix) > 0:
        head = prefix[: max(0, length - 1)]  # >= 1 fresh suffix token
        tail_n = length - len(head)
        tail = [1 + int(rng.random() * (vocab - 1)) for _ in range(tail_n)]
        return np.concatenate([head, np.asarray(tail, np.int32)])
    return np.array([1 + int(rng.random() * (vocab - 1)) for _ in range(length)],
                    dtype=np.int32)
