"""Pure derived signals over retained series: the port's copy of
lws_tpu/obs/signals.py, whole. The math between sensor and actuator.

Every function here is a pure fold over `[(t, value), ...]` point lists
(the `HistoryRing`'s window shape) with an explicit `now` — no clocks, no
I/O, no registries — so the recommender's decisions and the monitor's
columns are unit-testable from canned points. Counter-shaped inputs are
assumed RESET-ADJUSTED (the ring guarantees it), which is why `rate` and
`increase` clamp at zero instead of guessing at resets themselves.

The burn-rate functions implement SRE-workbook multi-window multi-burn-rate
alerting over the serving SLO series: an error budget of `1 - target`
burning at rate B exhausts in `window/B`; paging fires only when BOTH a
fast window (default 5m, threshold 14.4x) and its long confirmation window
(1h) burn hot — a blip trips neither, a real incident trips both within
minutes. The canonical windows are wall-scale; `LWS_TPU_BURN_WINDOW_SCALE`
(or an explicit `scale=`) shrinks them proportionally to the ring's
resolution — CPU tests and second-scale scenario runs use the same math at
1/100th the wall clock.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional

Points = list  # [(t_seconds, value)] — the HistoryRing window shape


def clip(points: Points, window_s: Optional[float],
         now: Optional[float]) -> Points:
    """The trailing `window_s` of `points` (all of them when unbounded)."""
    if window_s is None or now is None:
        return list(points)
    cutoff = now - window_s
    return [p for p in points if p[0] >= cutoff]


def last(points: Points) -> Optional[float]:
    return points[-1][1] if points else None


def increase(points: Points, window_s: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
    """Total growth of a (reset-adjusted) cumulative series over the
    window: last - first, clamped at zero. None below two points — one
    sample carries no delta, and fabricating 0.0 would render a fake calm
    column (the `lws-tpu top` first-frame bug this plane cures)."""
    pts = clip(points, window_s, now)
    if len(pts) < 2:
        return None
    return max(0.0, pts[-1][1] - pts[0][1])


def rate(points: Points, window_s: Optional[float] = None,
         now: Optional[float] = None) -> Optional[float]:
    """Per-second growth over the window (increase / observed span). The
    denominator is the span actually covered by samples, so a skipped
    scrape widens the window instead of corrupting the rate."""
    pts = clip(points, window_s, now)
    if len(pts) < 2:
        return None
    span = pts[-1][0] - pts[0][0]
    if span <= 0:
        return None
    return max(0.0, pts[-1][1] - pts[0][1]) / span


def mean(points: Points, window_s: Optional[float] = None,
         now: Optional[float] = None) -> Optional[float]:
    """Time-weighted mean of a gauge over the window (each value holds
    until the next sample; simple mean would over-weight scrape bursts)."""
    pts = clip(points, window_s, now)
    if not pts:
        return None
    if len(pts) == 1:
        return pts[0][1]
    acc = 0.0
    for (t0, v0), (t1, _) in zip(pts, pts[1:]):
        acc += v0 * (t1 - t0)
    span = pts[-1][0] - pts[0][0]
    if span <= 0:
        return pts[-1][1]
    return acc / span


def ewma(points: Points, tau_s: float, window_s: Optional[float] = None,
         now: Optional[float] = None) -> Optional[float]:
    """Exponentially-weighted moving average with time constant `tau_s`
    (irregular sampling handled per-gap: alpha = 1 - exp(-dt/tau)) — the
    smoothing the monitor's trend columns use so one noisy scrape doesn't
    flip a recommendation."""
    import math

    pts = clip(points, window_s, now)
    if not pts:
        return None
    acc = pts[0][1]
    for (t0, _), (t1, v1) in zip(pts, pts[1:]):
        alpha = 1.0 - math.exp(-max(0.0, t1 - t0) / tau_s) if tau_s > 0 else 1.0
        acc += alpha * (v1 - acc)
    return acc


def slope(points: Points, window_s: Optional[float] = None,
          now: Optional[float] = None) -> Optional[float]:
    """Least-squares trend of a gauge in value/second — the KV-occupancy
    "filling vs draining" signal the decode recommendation consumes."""
    pts = clip(points, window_s, now)
    if len(pts) < 2:
        return None
    n = len(pts)
    mt = sum(t for t, _ in pts) / n
    mv = sum(v for _, v in pts) / n
    denom = sum((t - mt) ** 2 for t, _ in pts)
    if denom <= 0:
        return None
    return sum((t - mt) * (v - mv) for t, v in pts) / denom


def error_series(good: Points, total: Points) -> Points:
    """Pointwise error-fraction series from two cumulative counters: at
    each successive TOTAL sample pair, 1 - dgood/dtotal (skipping gaps
    where nothing was delivered). The good series is carried forward
    between its samples and defaults to zero when absent entirely — an
    all-late workload never creates the goodput counter at all, and that
    is a 100% error series, not a missing one. This is the series a burn
    alert embeds in its flight-recorder dump — the offending window,
    legible."""
    goods = sorted(good)
    out: Points = []
    prev: Optional[tuple] = None
    gi = 0
    g = 0.0
    for t, tot in sorted(total):
        while gi < len(goods) and goods[gi][0] <= t:
            g = goods[gi][1]
            gi += 1
        if prev is not None:
            dg, dt = g - prev[1], tot - prev[2]
            if dt > 0:
                out.append((t, max(0.0, min(1.0, 1.0 - dg / dt))))
        prev = (t, g, tot)
    return out


# ---------------------------------------------------------------------------
# Histogram folds


def histogram_quantile(buckets: list, q: float) -> Optional[float]:
    """Estimate a quantile from cumulative `(le, count)` pairs — the PromQL
    histogram_quantile shape, linear within the winning bucket. (`lws-tpu
    top` renders its p95 columns through this same function.)"""
    if not buckets:
        return None
    buckets = sorted(buckets, key=lambda b: b[0])
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in buckets:
        if cum >= rank:
            if le == float("inf"):
                return prev_le  # open-ended bucket: report its lower bound
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span > 0 else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return buckets[-1][0]


def quantile_over_window(bucket_points: dict, q: float,
                         window_s: Optional[float] = None,
                         now: Optional[float] = None) -> Optional[float]:
    """Quantile of the observations that arrived WITHIN the window:
    `bucket_points` maps the `le` label (str) to that bucket's retained
    cumulative-count points; per-bucket `increase` over the window rebuilds
    the window's own cumulative histogram. A lifetime quantile can't sag
    back down after one bad hour — this one can."""
    buckets = []
    for le, pts in bucket_points.items():
        inc = increase(pts, window_s, now)
        if inc is None:
            continue
        le_f = float("inf") if le in ("+Inf", "inf") else float(le)
        buckets.append((le_f, inc))
    return histogram_quantile(buckets, q)


def breach_fraction(bucket_points: dict, target: float,
                    window_s: Optional[float] = None,
                    now: Optional[float] = None) -> Optional[float]:
    """Fraction of the window's observations that EXCEEDED `target`,
    from bucket increases: 1 - (count in the smallest bucket covering the
    target) / (total count). The per-phase error rate (TTFT over target,
    queue wait over target) the role recommendations burn against;
    conservative when the target falls between bucket bounds (the covering
    bucket may admit some over-target samples)."""
    total = None
    covering: Optional[tuple] = None
    widest: Optional[tuple] = None
    for le, pts in bucket_points.items():
        inc = increase(pts, window_s, now)
        if inc is None:
            continue
        le_f = float("inf") if le in ("+Inf", "inf") else float(le)
        if le_f == float("inf"):
            total = inc
            continue
        if le_f >= target and (covering is None or le_f < covering[0]):
            covering = (le_f, inc)
        if widest is None or le_f > widest[0]:
            widest = (le_f, inc)
    if total is None or total <= 0:
        return None
    if covering is None:
        # Target past every finite bucket: everything the widest bucket
        # counted is certainly within target; only the open-ended tail
        # MIGHT breach — still counted, staying conservative.
        covering = widest
    good = covering[1] if covering is not None else 0.0
    return max(0.0, min(1.0, 1.0 - good / total))


# ---------------------------------------------------------------------------
# Multi-window multi-burn-rate (SRE-workbook shape)


BURN_WINDOW_SCALE_ENV = "LWS_TPU_BURN_WINDOW_SCALE"


@dataclass(frozen=True)
class BurnWindow:
    """One page/ticket tier: a short window that reacts and a long window
    that confirms; both must burn past `threshold` to fire."""

    name: str
    short_s: float
    long_s: float
    threshold: float

    def scaled(self, scale: float) -> "BurnWindow":
        return replace(self, short_s=self.short_s * scale,
                       long_s=self.long_s * scale)


# The SRE-workbook page tier (5m/1h at 14.4x: 2% of a 30-day budget in an
# hour) and ticket tier (1h/6h at 6x), wall-scale.
DEFAULT_BURN_WINDOWS = (
    BurnWindow("fast", 300.0, 3600.0, 14.4),
    BurnWindow("slow", 3600.0, 21600.0, 6.0),
)


def burn_windows(scale: Optional[float] = None) -> tuple:
    """The default tiers scaled to the deployment's ring resolution:
    `scale` (or LWS_TPU_BURN_WINDOW_SCALE) multiplies both windows of each
    tier; thresholds are scale-free (a burn RATE is already normalized by
    its window)."""
    if scale is None:
        try:
            scale = float(os.environ.get(BURN_WINDOW_SCALE_ENV, 1.0))
        except ValueError:
            scale = 1.0
    if scale == 1.0:
        return DEFAULT_BURN_WINDOWS
    return tuple(w.scaled(scale) for w in DEFAULT_BURN_WINDOWS)


def burn_rate_from_counters(good: Points, total: Points, target: float,
                            window_s: float,
                            now: Optional[float] = None) -> Optional[float]:
    """Error-budget burn over one window from the goodput ledger pair:
    (error fraction of the window's tokens) / (1 - target). Burn 1.0 means
    the budget exhausts exactly at the SLO horizon; 14.4 means 2% of a
    30-day budget per hour — page territory."""
    budget = 1.0 - target
    if budget <= 0:
        return None
    dtotal = increase(total, window_s, now)
    if not dtotal:
        return None
    dgood = increase(good, window_s, now) or 0.0
    err = max(0.0, min(1.0, 1.0 - dgood / dtotal))
    return err / budget


def burn_rate_from_gauge(err_points: Points, target: float, window_s: float,
                         now: Optional[float] = None) -> Optional[float]:
    """Burn over one window from an error-fraction gauge series (e.g.
    `1 - serving_slo_attainment` samples): mean error over the window /
    budget. The attainment-series twin of `burn_rate_from_counters`."""
    budget = 1.0 - target
    if budget <= 0:
        return None
    err = mean(err_points, window_s, now)
    if err is None:
        return None
    return max(0.0, err) / budget


@dataclass(frozen=True)
class BurnVerdict:
    window: str
    short_burn: Optional[float]
    long_burn: Optional[float]
    threshold: float

    @property
    def firing(self) -> bool:
        """Both windows must burn past the threshold — the blip-proof AND
        of the multi-window rule. An unevaluable window (too few points)
        never fires: alerting on absence of data is the watchdog rules'
        job, not the burn math's."""
        return (
            self.short_burn is not None and self.long_burn is not None
            and self.short_burn >= self.threshold
            and self.long_burn >= self.threshold
        )


def multiwindow_burn(good: Points, total: Points, target: float,
                     windows: Optional[tuple] = None,
                     now: Optional[float] = None) -> list:
    """[BurnVerdict per tier] over a goodput counter pair: the full
    page/ticket evaluation one (engine, klass) series feeds. Callers fold
    `any(v.firing for v in ...)` into alerts and recommendations."""
    out = []
    for w in (windows if windows is not None else burn_windows()):
        out.append(BurnVerdict(
            window=w.name,
            short_burn=burn_rate_from_counters(good, total, target, w.short_s, now),
            long_burn=burn_rate_from_counters(good, total, target, w.long_s, now),
            threshold=w.threshold,
        ))
    return out
