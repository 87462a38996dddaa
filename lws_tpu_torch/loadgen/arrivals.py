"""Seeded OPEN-LOOP arrival processes: the port's copy of
lws_tpu/loadgen/arrivals.py, whole (a named scenario and a seed give the
port the schedule they give the JAX package). When requests arrive,
decided before any of them is served.

Serving-systems evaluation (DistServe, Sarathi-Serve, the Orca line in
PAPERS.md) is open-loop: arrivals come from a timer, never from completions,
so a system that falls behind accumulates queue — queueing collapse is
OBSERVABLE instead of being absorbed by a closed loop that politely waits.
These processes produce the timer's schedule.

Determinism contract (pinned by tests/test_loadgen.py, and the port's copy
to the JAX package's by tests/test_torch_telemetry_core.py): every process draws
exclusively from `random.Random.random()` (the Mersenne-Twister stream,
bit-identical across CPython versions) through `_exp` — no library
distribution helpers whose algorithms could drift between Python releases.
Same seed -> byte-identical arrival times; distinct seeds diverge.

All processes expose `times(horizon_s, rng) -> list[float]` (seconds from
scenario start, sorted). Rates are requests/second in SCENARIO time — the
runner maps scenario seconds onto wall seconds via its time_scale knob.
"""

from __future__ import annotations

import math
import random
from typing import Optional


def _exp(rng: random.Random, rate: float) -> float:
    """One exponential inter-arrival draw at `rate` from the raw MT stream
    (1 - random() is in (0, 1], so log never sees 0)."""
    return -math.log(1.0 - rng.random()) / rate


def piecewise_poisson(
    segments: list[tuple[float, float, float]], rng: random.Random
) -> list[float]:
    """Poisson arrivals over piecewise-constant rates: `segments` is
    [(start_s, end_s, rate_rps)]. The building block every process below
    reduces to (a flash crowd is a 3-segment schedule, a diurnal trace an
    N-segment one). Each segment restarts its own exponential chain — the
    boundary error is at most one inter-arrival and keeps the draw order
    trivially reproducible."""
    out: list[float] = []
    for start, end, rate in segments:
        if rate <= 0 or end <= start:
            continue
        t = start + _exp(rng, rate)
        while t < end:
            out.append(t)
            t += _exp(rng, rate)
    return out


class PoissonProcess:
    """Memoryless steady load at `rate_rps` — the canonical open-loop
    baseline (exponential inter-arrivals, CV = 1)."""

    def __init__(self, rate_rps: float) -> None:
        if rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        self.rate_rps = rate_rps

    def times(self, horizon_s: float, rng: random.Random) -> list[float]:
        return piecewise_poisson([(0.0, horizon_s, self.rate_rps)], rng)


class GammaProcess:
    """Erlang-k (gamma with integer shape) inter-arrivals at mean rate
    `rate_rps`: each gap is the sum of `shape` exponentials at
    shape x rate, so CV = 1/sqrt(shape) — smoother-than-Poisson traffic
    (a rate-limited upstream). shape=1 degenerates to Poisson."""

    def __init__(self, rate_rps: float, shape: int = 2) -> None:
        if rate_rps <= 0 or shape < 1:
            raise ValueError("rate_rps must be > 0 and shape >= 1")
        self.rate_rps = rate_rps
        self.shape = int(shape)

    def times(self, horizon_s: float, rng: random.Random) -> list[float]:
        out: list[float] = []
        sub_rate = self.rate_rps * self.shape
        t = sum(_exp(rng, sub_rate) for _ in range(self.shape))
        while t < horizon_s:
            out.append(t)
            t += sum(_exp(rng, sub_rate) for _ in range(self.shape))
        return out


class BurstProcess:
    """Bursty traffic (CV > 1) as an ON/OFF modulated Poisson: `duty` of
    every `period_s` runs at `burst_rps`, the rest at `base_rps`. The
    mix that makes continuous-batching queues oscillate — steady-state
    attainment can be perfect while every burst blows the TTFT tail."""

    def __init__(self, base_rps: float, burst_rps: float,
                 period_s: float = 1.0, duty: float = 0.25) -> None:
        if period_s <= 0 or not (0.0 < duty < 1.0):
            raise ValueError("period_s must be > 0 and duty in (0, 1)")
        self.base_rps = base_rps
        self.burst_rps = burst_rps
        self.period_s = period_s
        self.duty = duty

    def times(self, horizon_s: float, rng: random.Random) -> list[float]:
        segments: list[tuple[float, float, float]] = []
        t = 0.0
        while t < horizon_s:
            on_end = min(t + self.duty * self.period_s, horizon_s)
            segments.append((t, on_end, self.burst_rps))
            off_end = min(t + self.period_s, horizon_s)
            segments.append((on_end, off_end, self.base_rps))
            t += self.period_s
        return piecewise_poisson(segments, rng)


class FlashCrowdProcess:
    """A step spike: `base_rps` until `spike_at_s`, then `spike_rps` for
    `spike_len_s`, then base again — the retweeted-link shape. The spike is
    where admission backpressure and goodput (not raw throughput) earn
    their keep."""

    def __init__(self, base_rps: float, spike_rps: float,
                 spike_at_s: float, spike_len_s: float) -> None:
        self.base_rps = base_rps
        self.spike_rps = spike_rps
        self.spike_at_s = spike_at_s
        self.spike_len_s = spike_len_s

    def times(self, horizon_s: float, rng: random.Random) -> list[float]:
        lo = min(self.spike_at_s, horizon_s)
        hi = min(self.spike_at_s + self.spike_len_s, horizon_s)
        return piecewise_poisson(
            [(0.0, lo, self.base_rps),
             (lo, hi, self.spike_rps),
             (hi, horizon_s, self.base_rps)],
            rng,
        )


class TraceReplayProcess:
    """Replay a committed rate trace (diurnal curves, recorded traffic):
    `points` is [{"t_s": start, "rate_rps": r}, ...] sorted by t_s; each
    point's rate holds until the next point (or the horizon). The same
    seed replays the trace into the exact same arrival schedule — the
    property that makes a committed scenario a regression gate."""

    def __init__(self, points: list[dict]) -> None:
        if not points:
            raise ValueError("trace needs at least one point")
        self.points = sorted(
            ({"t_s": float(p["t_s"]), "rate_rps": float(p["rate_rps"])}
             for p in points),
            key=lambda p: p["t_s"],
        )

    def times(self, horizon_s: float, rng: random.Random) -> list[float]:
        segments = []
        for i, p in enumerate(self.points):
            end = (self.points[i + 1]["t_s"] if i + 1 < len(self.points)
                   else horizon_s)
            segments.append((p["t_s"], min(end, horizon_s), p["rate_rps"]))
        return piecewise_poisson(segments, rng)


def make_process(spec: dict):
    """Arrival-process factory from a scenario spec's `arrivals` stanza:
    {"process": "poisson" | "gamma" | "burst" | "flash_crowd" | "trace",
    ...kind-specific knobs}. Unknown kinds raise — a typo must not quietly
    become a different traffic shape."""
    kind = spec.get("process", "poisson")
    if kind == "poisson":
        return PoissonProcess(float(spec["rate_rps"]))
    if kind == "gamma":
        return GammaProcess(float(spec["rate_rps"]), int(spec.get("shape", 2)))
    if kind == "burst":
        return BurstProcess(
            float(spec.get("base_rps", 1.0)), float(spec["burst_rps"]),
            float(spec.get("period_s", 1.0)), float(spec.get("duty", 0.25)),
        )
    if kind == "flash_crowd":
        return FlashCrowdProcess(
            float(spec.get("base_rps", 1.0)), float(spec["spike_rps"]),
            float(spec["spike_at_s"]), float(spec["spike_len_s"]),
        )
    if kind == "trace":
        return TraceReplayProcess(list(spec["points"]))
    raise ValueError(f"unknown arrival process {kind!r}")


def arrival_times(spec: dict, horizon_s: float,
                  rng: Optional[random.Random] = None,
                  seed: Optional[int] = None) -> list[float]:
    """Convenience: spec + horizon (+ seed or an existing rng) -> times."""
    if rng is None:
        rng = random.Random(seed)
    return make_process(spec).times(horizon_s, rng)
