"""The one general generator of the benchmark's closed-loop traffic.

A traffic mix file gives parameters only: the prompt and output length
distributions, log-normal and clipped. There is one closed-loop client per
slot of the engine. From the mix this module deals a fixed DECK of
requests' sizes: the lengths at evenly spaced quantiles of each
distribution, with the outputs paired to the prompts by a permutation that
does not depend on the seed; and deals it in an order that does not either
(a fixed permutation, rotated by 97 places at each pass through the deck).
The seed draws every token id. So every seed serves the same sizes in the
same order, and the work of a window does not change with the seed; only
its values do.

Client c's j-th request is entry (j * clients + c) of the stream, so a
client's requests never depend on another client's timing.

The log-normal lengths and the token draws follow the port's load
generator (lws_tpu_torch/loadgen/workload.py: `build_prompt` draws ids in
[1, vocab)), drawn here with numpy from the seed instead of one Python
stream.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

import numpy as np

DECK = 256               # sizes dealt per pass
_PAIRING_SEED = 0x5EED  # fixed: the deck's pairing and order never depend on --seed
_PASS_ROTATION = 97
_NORMAL = statistics.NormalDist()


def seed_entropy(seed: int) -> int:
    """A non-negative entropy word for numpy from any whole-number seed."""
    return int(seed) % (1 << 64)


def length_at(dist: dict, u: float) -> int:
    """The length at quantile u in (0, 1) of a clipped log-normal length
    distribution {"dist": "lognormal", "median", "sigma", "min", "max"}."""
    if dist.get("dist") != "lognormal":
        raise ValueError(f"unknown length distribution {dist.get('dist')!r}")
    x = float(dist["median"]) * np.exp(float(dist["sigma"]) * _NORMAL.inv_cdf(u))
    return int(min(int(dist["max"]), max(int(dist["min"]), round(x))))


@dataclass(frozen=True)
class Request:
    index: int            # position in the stream
    client: int
    prompt: np.ndarray    # int32 token ids
    max_new: int


class Traffic:
    """The seeded request streams of one mix for an engine of `slots` slots
    and a model of `vocab` tokens."""

    def __init__(self, mix: dict, vocab: int, slots: int, seed: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.seed = seed_entropy(seed)
        self.clients = int(slots)
        K = DECK
        fixed = np.random.default_rng(_PAIRING_SEED)
        u = (np.arange(K) + 0.5) / K
        lens = [length_at(mix["prompt"], float(x)) for x in u]
        outs = [length_at(mix["output"], float(x)) for x in u]
        outs = [outs[i] for i in fixed.permutation(K)]
        self.deck = list(zip(lens, outs))
        self._base = fixed.permutation(K)

    def _order(self, n: int) -> np.ndarray:
        """The deck's order in pass n."""
        return np.roll(self._base, -_PASS_ROTATION * n)

    def request(self, client: int, j: int) -> Request:
        g = j * self.clients + client
        K = len(self.deck)
        n, s_out = self.deck[int(self._order(g // K)[g % K])]
        ids = np.random.default_rng([self.seed, 0, g]).integers(
            1, self.vocab, n, dtype=np.int64).astype(np.int32)
        return Request(g, client, ids, s_out)

    def warm_prompts(self, lengths_for) -> list[tuple[np.ndarray, int]]:
        """Prompts that reach every prefill shape the mix can reach, once
        each, with 2 new tokens: `lengths_for(lengths)` gives one prompt
        length per shape (reckon.warm_lengths)."""
        rng = np.random.default_rng([self.seed, 3])
        lens = sorted({n for n, _ in self.deck})
        return [(rng.integers(1, self.vocab, n, dtype=np.int64).astype(np.int32), 2)
                for n in lengths_for(lens)]
