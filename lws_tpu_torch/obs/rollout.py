"""Rollout intelligence: the port's copy of lws_tpu/obs/rollout.py, its
judging half (the guards, the revision folds, `CanaryAnalyzer`).

  * **revision folds** — pure `signals.py`-style functions over the
    `HistoryRing`: a fleet exposition labels every series with `revision`
    (workers thread LWS_TPU_REVISION onto their local series), so
    per-(engine, revision) burn, attainment, TTFT/ITL quantiles, and
    GOOD%/SPEC%/PFX% are one `ring.series(family, {"revision": r})` away.
  * **CanaryAnalyzer** — promote/hold/rollback verdicts
    (`lws_rollout_canary_verdict{lws,revision}`: +1/0/-1) from
    baseline-vs-canary burn deltas, with minimum-sample and
    minimum-duration guards: NO DATA IS NOT PROMOTE — a revision that
    hasn't served enough tokens for long enough holds, it never promotes.
    While a revision's regression fires, the analyzer holds a
    `canary:{lws}/{revision}` heartbeat at depth 1 (the `circuit_open`
    convention) so the stock Watchdog `canary_regression` rule produces
    ONE alert + diagnostics dump per episode — and the firing-edge ring
    event embeds the offending revision's error-series window.

The port runs it where `lws-tpu loadgen --server` does: `loadgen.fold_canary`
replays a throwaway analyzer over the ring a run sampled. Left out, as the
control plane's side: the `RolloutLedger` timeline fed by the store,
`install`, `default_canary_analyzer` and `RolloutActuationAdapter`, which
read or write the store. With no ledger, `CanaryAnalyzer` takes no
`ledger=`: it records no verdict change, and its firing-edge event's
`ledger_window` is `[]`, as JAX's analyzer built without a ledger gives.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from lws_tpu_torch.core import flightrecorder, metrics
from lws_tpu_torch.obs import signals
from lws_tpu_torch.obs.history import HistoryRing
from lws_tpu_torch.utils.common import env_float as _env_float

# Tokens a revision must have delivered before it is judgeable at all.
MIN_SAMPLES_ENV = "LWS_TPU_CANARY_MIN_SAMPLES"
DEFAULT_MIN_SAMPLES = 50.0
# Seconds of retained series a revision must span before it is judgeable.
MIN_DURATION_ENV = "LWS_TPU_CANARY_MIN_DURATION_S"
DEFAULT_MIN_DURATION_S = 60.0
# How many burn multiples HOTTER than the best other revision the fast
# short-window burn must run before a firing revision is attributed (and
# rolled back) rather than held as a fleet-wide problem.
DELTA_ENV = "LWS_TPU_CANARY_DELTA"
DEFAULT_DELTA = 2.0

# Verdict gauge encoding: promote / hold / rollback.
VERDICT_VALUES = {"promote": 1.0, "hold": 0.0, "rollback": -1.0}

# Points embedded in the firing-edge ring event: enough to read the
# episode, bounded so a dump stays a dump.
EVENT_WINDOW_POINTS = 64


# ---------------------------------------------------------------------------
# Revision-dimension folds: pure functions over a ring, signals.py style.


def _subset(revision: str, engine: Optional[str] = None) -> dict:
    sub = {"revision": revision}
    if engine:
        sub["engine"] = engine
    return sub


def revision_values(ring: HistoryRing) -> list:
    """Sorted revisions present on the token ledger — the judgeable set."""
    revs = {
        labels["revision"]
        for _, labels, _, _, _ in ring.series("serving_tokens_total")
        if labels.get("revision")
    }
    return sorted(revs)


def revision_goodput_pairs(ring: HistoryRing, revision: str,
                           engine: Optional[str] = None) -> list:
    """[(labels, good points, total points)] for one revision's token
    ledger, matched by exact label set — same contract as the recommender's
    `_goodput_pairs`: a total series WITHOUT a goodput twin is a 100% error
    series (core/slo.py only mints the goodput counter on the first
    on-time token), not a missing signal."""
    sub = _subset(revision, engine)
    goods = {
        tuple(sorted(labels.items())): pts
        for _, labels, _, pts, _ in ring.series(
            "serving_goodput_tokens_total", sub)
    }
    return [
        (labels, goods.get(tuple(sorted(labels.items())), []), pts)
        for _, labels, _, pts, _ in ring.series("serving_tokens_total", sub)
    ]


def revision_burn(ring: HistoryRing, revision: str, target: float,
                  windows: Optional[tuple] = None,
                  now: Optional[float] = None,
                  engine: Optional[str] = None) -> list:
    """[BurnVerdict per tier] for one revision: the WORST instance's burn
    per tier (worst short-window burn wins; a calm worker must never mask
    a burning one — same rule as the fleet burn gauge)."""
    tiers = windows if windows is not None else signals.burn_windows()
    worst: list = [None] * len(tiers)
    for _, good, total in revision_goodput_pairs(ring, revision, engine):
        for i, v in enumerate(signals.multiwindow_burn(
                good, total, target, tiers, now)):
            cur = worst[i]
            if cur is None or (v.short_burn or -1.0) > (cur.short_burn or -1.0):
                worst[i] = v
    return [
        v if v is not None else signals.BurnVerdict(
            window=w.name, short_burn=None, long_burn=None,
            threshold=w.threshold)
        for v, w in zip(worst, tiers)
    ]


def revision_samples(ring: HistoryRing, revision: str,
                     now: Optional[float] = None,
                     engine: Optional[str] = None) -> tuple:
    """(tokens delivered, seconds of series span) for one revision over the
    full retained window — the minimum-sample / minimum-duration guard
    inputs. (0.0, 0.0) for an unseen revision."""
    tokens = 0.0
    span = 0.0
    for _, _, total in revision_goodput_pairs(ring, revision, engine):
        tokens += signals.increase(total) or 0.0
        if len(total) >= 2:
            span = max(span, total[-1][0] - total[0][0])
    return tokens, span


def revision_attainment(ring: HistoryRing, revision: str,
                        window_s: Optional[float] = None,
                        now: Optional[float] = None,
                        engine: Optional[str] = None) -> Optional[float]:
    """Worst (minimum) time-weighted attainment across one revision's
    `serving_slo_attainment` gauges — per-(engine, revision) attainment
    with the same worst-instance pessimism as the burn fold."""
    vals = [
        signals.mean(pts, window_s, now)
        for _, _, _, pts, _ in ring.series("serving_slo_attainment",
                                           _subset(revision, engine))
    ]
    vals = [v for v in vals if v is not None]
    return min(vals) if vals else None


def revision_quantile(ring: HistoryRing, family: str, q: float,
                      revision: str, window_s: Optional[float] = None,
                      now: Optional[float] = None,
                      engine: Optional[str] = None) -> Optional[float]:
    """Worst per-instance windowed quantile of one revision's histogram
    family (e.g. `serving_ttft_seconds_bucket`): per bucket-group
    `quantile_over_window`, max across groups."""
    groups: dict = {}
    for _, labels, _, pts, _ in ring.series(family, _subset(revision, engine)):
        le = labels.get("le")
        if le is None:
            continue
        rest = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        groups.setdefault(rest, {})[le] = pts
    vals = [
        signals.quantile_over_window(buckets, q, window_s, now)
        for buckets in groups.values()
    ]
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else None


def _family_increase(ring: HistoryRing, family: str, sub: dict,
                     window_s: Optional[float],
                     now: Optional[float]) -> Optional[float]:
    total = None
    for _, _, _, pts, _ in ring.series(family, sub):
        inc = signals.increase(pts, window_s, now)
        if inc is not None:
            total = (total or 0.0) + inc
    return total


def revision_good_fraction(ring: HistoryRing, revision: str,
                           window_s: Optional[float] = None,
                           now: Optional[float] = None,
                           engine: Optional[str] = None) -> Optional[float]:
    """GOOD% for one revision: goodput tokens / tokens over the window."""
    sub = _subset(revision, engine)
    tokens = _family_increase(ring, "serving_tokens_total", sub, window_s, now)
    if not tokens:
        return None
    good = _family_increase(ring, "serving_goodput_tokens_total", sub,
                            window_s, now) or 0.0
    return max(0.0, min(1.0, good / tokens))


def revision_spec_fraction(ring: HistoryRing, revision: str,
                           window_s: Optional[float] = None,
                           now: Optional[float] = None,
                           engine: Optional[str] = None) -> Optional[float]:
    """SPEC% for one revision: accepted / drafted speculative tokens."""
    sub = _subset(revision, engine)
    drafted = _family_increase(ring, "serving_spec_tokens_total",
                               {**sub, "kind": "drafted"}, window_s, now)
    if not drafted:
        return None
    accepted = _family_increase(ring, "serving_spec_tokens_total",
                                {**sub, "kind": "accepted"}, window_s,
                                now) or 0.0
    return max(0.0, min(1.0, accepted / drafted))


def revision_prefix_fraction(ring: HistoryRing, revision: str,
                             window_s: Optional[float] = None,
                             now: Optional[float] = None,
                             engine: Optional[str] = None) -> Optional[float]:
    """PFX% for one revision: prefix-cache hits / (hits + misses)."""
    sub = _subset(revision, engine)
    hits = _family_increase(ring, "serving_prefix_cache_hits_total", sub,
                            window_s, now)
    misses = _family_increase(ring, "serving_prefix_cache_misses_total", sub,
                              window_s, now)
    if hits is None and misses is None:
        return None
    lookups = (hits or 0.0) + (misses or 0.0)
    if lookups <= 0:
        return None
    return (hits or 0.0) / lookups


# ---------------------------------------------------------------------------
# The canary analyzer


@dataclass
class RevisionVerdict:
    """One revision's judgement — JSON-shaped for reports."""

    revision: str
    verdict: str                       # promote | hold | rollback
    reason: str
    samples: float = 0.0
    duration_s: float = 0.0
    short_burn: Optional[float] = None
    long_burn: Optional[float] = None
    baseline_burn: Optional[float] = None
    firing: bool = False

    @property
    def value(self) -> float:
        return VERDICT_VALUES[self.verdict]

    def to_dict(self) -> dict:
        return {
            "revision": self.revision, "verdict": self.verdict,
            "value": self.value, "reason": self.reason,
            "samples": round(self.samples, 3),
            "duration_s": round(self.duration_s, 3),
            "short_burn": self.short_burn, "long_burn": self.long_burn,
            "baseline_burn": self.baseline_burn, "firing": self.firing,
        }


@dataclass
class CanaryReport:
    """One evaluation across every judgeable revision."""

    at: float
    lws: str
    baseline: str = ""
    verdicts: dict = field(default_factory=dict)  # revision -> RevisionVerdict

    def to_dict(self) -> dict:
        return {
            "at": self.at, "lws": self.lws, "baseline": self.baseline,
            "verdicts": {r: v.to_dict() for r, v in self.verdicts.items()},
        }


class CanaryAnalyzer:
    def __init__(
        self,
        ring: HistoryRing,
        lws: str = "-",
        attainment_target: Optional[float] = None,
        windows: Optional[tuple] = None,
        min_samples: Optional[float] = None,
        min_duration_s: Optional[float] = None,
        delta: Optional[float] = None,
        registry=None,
        recorder: Optional[flightrecorder.FlightRecorder] = None,
    ) -> None:
        """`lws` labels the verdict gauge (the deployment under analysis).
        Guards default from env (`LWS_TPU_CANARY_MIN_SAMPLES` / `_MIN_DURATION_S` /
        `_DELTA`); `windows` the burn tiers (default
        `signals.burn_windows()`, env-scalable); `registry`/`recorder`
        default to the process ones, injectable for deterministic tests."""
        from lws_tpu_torch.obs.recommend import (
            ATTAINMENT_TARGET_ENV,
            DEFAULT_ATTAINMENT_TARGET,
        )

        self.ring = ring
        self.lws = lws
        self.attainment_target = (
            attainment_target if attainment_target is not None
            else _env_float(ATTAINMENT_TARGET_ENV, DEFAULT_ATTAINMENT_TARGET)
        )
        self.windows = windows if windows is not None else signals.burn_windows()
        self.min_samples = (
            min_samples if min_samples is not None
            else _env_float(MIN_SAMPLES_ENV, DEFAULT_MIN_SAMPLES)
        )
        self.min_duration_s = (
            min_duration_s if min_duration_s is not None
            else _env_float(MIN_DURATION_ENV, DEFAULT_MIN_DURATION_S)
        )
        self.delta = delta if delta is not None else _env_float(
            DELTA_ENV, DEFAULT_DELTA)
        self._registry = registry
        self._recorder = (recorder if recorder is not None
                          else flightrecorder.RECORDER)
        self._lock = threading.Lock()
        self._firing: set = set()             # guarded-by: _lock
        self._published_verdicts: set = set()  # guarded-by: _lock
        self._published_burns: set = set()     # guarded-by: _lock

    def _reg(self):
        return self._registry if self._registry is not None else metrics.REGISTRY

    # ---- the evaluation --------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> CanaryReport:
        """One evaluation pass (pure — the RolloutActuator acts on the
        result): burn every revision, apply the guards, judge
        baseline-vs-canary deltas, publish the verdict + revision-burn
        gauges, and drive the edge-triggered `canary:*` alert feed.
        Deterministic under an injected `now`."""
        if now is None:
            now = time.monotonic()
        report = CanaryReport(at=now, lws=self.lws)
        reg = self._reg()
        fast = self.windows[0]

        stats: dict = {}
        burn_gauges: dict = {}  # label tuple -> worst short burn
        for rev in revision_values(self.ring):
            samples, duration = revision_samples(self.ring, rev, now)
            verdicts = revision_burn(self.ring, rev, self.attainment_target,
                                     self.windows, now)
            fast_v = verdicts[0]
            stats[rev] = {
                "samples": samples, "duration": duration, "fast": fast_v,
                "judgeable": (samples >= self.min_samples
                              and duration >= self.min_duration_s),
            }
            # The revision-scoped burn twin, per (engine, revision, window):
            # worst instance wins, same as serving_slo_burn_rate.
            for labels, good, total in revision_goodput_pairs(self.ring, rev):
                for v in signals.multiwindow_burn(
                        good, total, self.attainment_target, self.windows,
                        now):
                    if v.short_burn is None:
                        continue
                    gauge_labels = tuple(sorted({
                        "engine": labels.get("engine", ""),
                        "revision": rev, "window": v.window,
                    }.items()))
                    if v.short_burn > burn_gauges.get(gauge_labels, -1.0):
                        burn_gauges[gauge_labels] = v.short_burn

        firing_now: set = set()
        for rev, st in stats.items():
            fast_v = st["fast"]
            others = [
                s["fast"].short_burn for r, s in stats.items()
                if r != rev and s["judgeable"]
                and s["fast"].short_burn is not None
            ]
            baseline_burn = min(others) if others else None
            if not st["judgeable"]:
                rv = RevisionVerdict(
                    rev, "hold",
                    f"insufficient data ({st['samples']:.0f} tokens over "
                    f"{st['duration']:.1f}s; need >= {self.min_samples:g} "
                    f"over {self.min_duration_s:g}s)",
                )
            elif fast_v.firing and baseline_burn is not None and \
                    (fast_v.short_burn or 0.0) - baseline_burn >= self.delta:
                rv = RevisionVerdict(
                    rev, "rollback",
                    f"fast burn {fast_v.short_burn:.1f}x vs baseline "
                    f"{baseline_burn:.1f}x (delta >= {self.delta:g})",
                    firing=True,
                )
            elif fast_v.firing:
                rv = RevisionVerdict(
                    rev, "hold",
                    "burning but not revision-attributable (no healthy "
                    "baseline to compare against)",
                    firing=True,
                )
            else:
                rv = RevisionVerdict(
                    rev, "promote",
                    f"within budget (fast burn "
                    f"{fast_v.short_burn if fast_v.short_burn is not None else 0:.2f}x)",
                )
            rv.samples = st["samples"]
            rv.duration_s = st["duration"]
            rv.short_burn = fast_v.short_burn
            rv.long_burn = fast_v.long_burn
            rv.baseline_burn = baseline_burn
            report.verdicts[rev] = rv
            if rv.verdict == "rollback":
                firing_now.add(rev)
                self._hold_alert(rev, rv, now)

        # Deterministic baseline: the judgeable revision with the most
        # delivered tokens (ties break lexicographically) — the incumbent.
        judgeable = [r for r, s in stats.items() if s["judgeable"]]
        if judgeable:
            report.baseline = min(
                judgeable, key=lambda r: (-stats[r]["samples"], r))

        verdict_gauges = {
            tuple(sorted({"lws": self.lws, "revision": r}.items())): v.value
            for r, v in report.verdicts.items()
        }
        for labels_t, value in verdict_gauges.items():
            reg.set("lws_rollout_canary_verdict", value, dict(labels_t))
        for labels_t, burn in burn_gauges.items():
            reg.set("serving_slo_burn_rate_by_revision", burn, dict(labels_t))
        self._clear_alerts(firing_now, now)
        # Retire gauges whose revision left the ring (aged-out canary, torn
        # down fleet) — a frozen rollback verdict is a phantom incident.
        with self._lock:
            stale_verdicts = self._published_verdicts - set(verdict_gauges)
            self._published_verdicts = set(verdict_gauges)
            stale_burns = self._published_burns - set(burn_gauges)
            self._published_burns = set(burn_gauges)
        for labels_t in stale_verdicts:
            reg.clear_gauge("lws_rollout_canary_verdict", dict(labels_t),
                            exact=True)
        for labels_t in stale_burns:
            reg.clear_gauge("serving_slo_burn_rate_by_revision",
                            dict(labels_t), exact=True)
        return report

    # ---- edge-triggered alert feed ---------------------------------------
    def _hold_alert(self, rev: str, rv: RevisionVerdict, now: float) -> None:
        """While a revision's regression verdict holds, pin its
        `canary:{lws}/{revision}` heartbeat at depth 1 (the `circuit_open`
        convention: the Watchdog's `canary_regression` rule fires once per
        episode). The NEW-episode edge records a ring event embedding the
        offending revision's error-series window — the next watchdog dump
        ships the evidence."""
        key = f"{self.lws}/{rev}"
        with self._lock:
            new_edge = key not in self._firing
            self._firing.add(key)
        self._recorder.beat(f"canary:{key}", progress=0.0, depth=1.0, now=now)
        if new_edge:
            window: list = []
            for _, good, total in revision_goodput_pairs(self.ring, rev):
                series = signals.error_series(good, total)
                if len(series) > len(window):
                    window = series
            self._recorder.record(
                "canary_regression_fired",
                lws=self.lws,
                revision=rev,
                baseline_burn=rv.baseline_burn,
                short_burn=rv.short_burn,
                long_burn=rv.long_burn,
                threshold=self.windows[0].threshold,
                error_window=[[t, v] for t, v
                              in window[-EVENT_WINDOW_POINTS:]],
                ledger_window=[],
            )

    def _clear_alerts(self, firing_now: set, now: float) -> None:
        with self._lock:
            cleared = self._firing - {f"{self.lws}/{r}" for r in firing_now}
            self._firing = {f"{self.lws}/{r}" for r in firing_now}
        for key in cleared:
            self._recorder.beat(f"canary:{key}", progress=1.0, depth=0.0,
                                now=now)
