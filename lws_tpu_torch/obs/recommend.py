"""Autoscaling recommender: ROADMAP item 4's decision plane.

Consumes the history plane exactly as the roadmap prescribes — prefill
desired-replicas from TTFT/queue-wait burn, decode from ITL burn and
KV-occupancy trend — and publishes DECISIONS, not actions:

  * `serving_scale_recommendation{role}` — the desired replica count per
    DS role, a gauge on the normal metrics surface (rides /metrics/fleet,
    rendered by `lws-tpu monitor`);
  * `serving_slo_burn_rate{engine,klass,window}` — the short-window burn of
    each tier per SLO series, the raw paging signal;
  * edge-triggered `burn_rate` Watchdog alerts: while a series' fast tier
    fires, the recommender holds a `burn_rate:{engine}[/{klass}]` heartbeat
    at depth 1 (the `circuit_open` convention) so the stock Watchdog rule
    produces ONE alert + diagnostics dump per burn episode — and the ring
    event recorded on the firing edge embeds the offending error-series
    window, so the dump carries the evidence, not just the verdict.

The `AnnotationAdapter` is the actuation seam: it writes the
recommendation into the existing `METRIC_ANNOTATION_PREFIX` pod-annotation
contract (`metrics.lws.tpu/<metric>` on ready leader pods — normalized so
the HPA math reproduces the recommendation exactly), which the stock
`AutoscalerReconciler` already consumes. Since the decision-provenance PR
the loop is CLOSED by default for DisaggregatedSet roles: the
`ScaleActuator` (obs/decisions.py) drives this adapter per evaluation,
records the full provenance chain in the `DecisionLedger`, and honors the
`LWS_TPU_ACTUATION_DISABLE=scale` kill switch — with the switch set, the
evaluation below is once again a pure recommendation.

The port's copy of lws_tpu/obs/recommend.py, whole: the evaluation half
and the store half (`role_replicas_from_store`, `default_recommender`,
`AnnotationAdapter`). Its process-global `RECOMMENDER` is the port's own
object, not the JAX package's.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from lws_tpu_torch.core import flightrecorder, metrics
from lws_tpu_torch.core.slo import SLOTargets
from lws_tpu_torch.obs import signals
from lws_tpu_torch.obs.history import HistoryRing
from lws_tpu_torch.utils.common import env_float as _env_float

ATTAINMENT_TARGET_ENV = "LWS_TPU_SLO_BURN_TARGET"
DEFAULT_ATTAINMENT_TARGET = 0.99

# Per-role phase signals: the roadmap's sensor assignment. Prefill owns the
# arrival side (TTFT, queue wait); decode owns the steady-state side (ITL).
ROLE_PHASES = {
    "prefill": (
        ("serving_ttft_seconds_bucket", "ttft_s"),
        ("serving_queue_wait_seconds_bucket", "queue_wait_s"),
    ),
    "decode": (
        ("serving_itl_seconds_bucket", "itl_s"),
    ),
}

# KV-pool occupancy bands for the decode recommendation: above `high` the
# pool itself is the bottleneck (scale out even before latency burns);
# below `low` the pool is idle enough to consider scaling in.
KV_OCCUPANCY_HIGH = 0.85
KV_OCCUPANCY_LOW = 0.50

# Scale-up severity is bounded: one evaluation never recommends more than
# this factor over current (the HPA controller's own clamps still apply).
MAX_SCALE_FACTOR = 4.0

# Points embedded in the firing-edge ring event: enough to read the
# episode, bounded so a dump stays a dump.
EVENT_WINDOW_POINTS = 64


@dataclass
class Recommendation:
    """One evaluation's full verdict — JSON-shaped for reports/traces."""

    at: float
    desired: dict = field(default_factory=dict)      # role -> replicas
    current: dict = field(default_factory=dict)      # role -> replicas
    reasons: dict = field(default_factory=dict)      # role -> short text
    burns: list = field(default_factory=list)        # per-series tier dicts
    firing: list = field(default_factory=list)       # "engine[/klass]" keys

    def to_dict(self) -> dict:
        return {
            "at": self.at,
            "desired": dict(self.desired),
            "current": dict(self.current),
            "reasons": dict(self.reasons),
            "burns": list(self.burns),
            "firing": list(self.firing),
        }


def _burn_key(labels: dict) -> str:
    engine = labels.get("engine", "-")
    klass = labels.get("klass", "")
    return f"{engine}/{klass}" if klass else engine


class ScaleRecommender:
    def __init__(
        self,
        ring: HistoryRing,
        targets: Optional[SLOTargets] = None,
        class_targets: Optional[dict] = None,
        attainment_target: Optional[float] = None,
        windows: Optional[tuple] = None,
        current: Optional[dict] = None,
        min_replicas: int = 1,
        max_replicas: int = 8,
        registry=None,
        recorder: Optional[flightrecorder.FlightRecorder] = None,
    ) -> None:
        """`targets`/`class_targets` grade the phase histograms (defaults:
        env, like core/slo.py). `attainment_target` sets the error budget
        (`LWS_TPU_SLO_BURN_TARGET`, default 0.99); `windows` the burn tiers
        (default `signals.burn_windows()`, env-scalable to the ring's
        resolution). `current` maps role -> current replicas (the
        baseline the recommendation scales from; default 1 each).
        `registry` receives the recommendation/burn gauges (default the
        process registry); `recorder` the flight recorder whose heartbeat
        table the Watchdog's `burn_rate` rule reads (default the process
        one)."""
        self.ring = ring
        self.targets = targets if targets is not None else SLOTargets.from_env()
        self.class_targets = dict(class_targets or {})
        self.attainment_target = (
            attainment_target if attainment_target is not None
            else _env_float(ATTAINMENT_TARGET_ENV, DEFAULT_ATTAINMENT_TARGET)
        )
        self.windows = windows if windows is not None else signals.burn_windows()
        self.current = dict(current or {"prefill": 1, "decode": 1})
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self._registry = registry
        self._recorder = recorder if recorder is not None else flightrecorder.RECORDER
        self._lock = threading.Lock()
        self._firing: set = set()  # guarded-by: _lock
        # Burn-gauge label sets published on the previous evaluation: a
        # series whose goodput pair left the ring (retired worker, aged-out
        # class) must RETIRE its gauge, not freeze at the last burn — the
        # same staleness contract core/slo.py applies to attainment.
        self._published_burns: set = set()  # guarded-by: _lock

    # ---- plumbing --------------------------------------------------------
    def _reg(self):
        return self._registry if self._registry is not None else metrics.REGISTRY

    def _targets_for(self, klass: str) -> SLOTargets:
        if klass and klass in self.class_targets:
            return self.class_targets[klass]
        return self.targets

    def _fast(self) -> signals.BurnWindow:
        return self.windows[0]

    def _goodput_pairs(self) -> list:
        """[(labels, good points, total points)] for every token-ledger
        series, matched by exact label set. A total series WITHOUT a
        goodput twin means zero tokens ever landed on time (core/slo.py
        only creates the goodput counter on the first on-time token) —
        that's the worst burn there is, not a missing signal."""
        goods = {
            tuple(sorted(labels.items())): pts
            for _, labels, _, pts, _ in self.ring.series(
                "serving_goodput_tokens_total")
        }
        return [
            (labels, goods.get(tuple(sorted(labels.items())), []), pts)
            for _, labels, _, pts, _ in self.ring.series("serving_tokens_total")
        ]

    def _bucket_groups(self, family: str) -> dict:
        """{labels-minus-le tuple: {le: points}} for one histogram family's
        retained bucket series."""
        groups: dict = {}
        for _, labels, _, pts, _ in self.ring.series(family):
            le = labels.get("le")
            if le is None:
                continue
            rest = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"
            ))
            groups.setdefault(rest, {})[le] = pts
        return groups

    def occupancy_points(self, labels_subset: Optional[dict] = None) -> list:
        """Pointwise KV-pool occupancy series live/(free+live+parked) from
        the state-labelled block gauge, aligned on sample times (summed
        across matching engines/instances per timestamp)."""
        states: dict = {}
        for _, labels, _, pts, _ in self.ring.series(
                "serving_kv_pool_blocks", labels_subset):
            state = labels.get("state")
            if state not in ("free", "live", "parked"):
                continue
            for t, v in pts:
                slot = states.setdefault(t, {})
                slot[state] = slot.get(state, 0.0) + v
        out = []
        for t in sorted(states):
            slot = states[t]
            pool = sum(slot.values())
            if pool > 0 and "live" in slot:
                out.append((t, slot["live"] / pool))
        return out

    # ---- the evaluation --------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Recommendation:
        """One evaluation pass (pure — the ScaleActuator acts on the result):
        burn every SLO series, derive per-role desired replicas, publish
        the gauges, and drive the edge-triggered alert feed. Deterministic under an injected `now`."""
        if now is None:
            now = time.monotonic()
        rec = Recommendation(at=now, current=dict(self.current))
        reg = self._reg()
        fast = self._fast()

        # 1. Error-budget burn per goodput series (the canonical
        #    `serving_slo_burn_rate` surface + the alert feed). On a
        #    fleet-fed ring the same (engine, klass) exists once PER
        #    INSTANCE; the gauge publishes the WORST instance's burn —
        #    last-write-wins would let a calm worker mask a burning one.
        firing_now: set = set()
        worst: dict = {}  # gauge label tuple -> max short burn
        for labels, good, total in self._goodput_pairs():
            target = self.attainment_target
            verdicts = signals.multiwindow_burn(
                good, total, target, self.windows, now
            )
            key = _burn_key(labels)
            burn_labels = {
                k: v for k, v in labels.items() if k in ("engine", "klass")
            }
            for v in verdicts:
                if v.short_burn is not None:
                    gauge_labels = tuple(sorted(
                        {**burn_labels, "window": v.window}.items()
                    ))
                    if v.short_burn > worst.get(gauge_labels, -1.0):
                        worst[gauge_labels] = v.short_burn
                rec.burns.append({
                    "series": key, "instance": labels.get("instance", ""),
                    "window": v.window,
                    "short_burn": v.short_burn, "long_burn": v.long_burn,
                    "threshold": v.threshold, "firing": v.firing,
                })
            if verdicts and verdicts[0].firing:  # the fast (page) tier
                firing_now.add(key)
                if key not in rec.firing:
                    rec.firing.append(key)
                self._hold_alert(labels, good, total, verdicts[0], now)
        for gauge_labels, burn in worst.items():
            reg.set("serving_slo_burn_rate", burn, dict(gauge_labels))
        self._clear_alerts(firing_now, now)
        # Retire burn gauges whose feeding series left the ring or stopped
        # being evaluable — a frozen 20x burn is a phantom incident.
        with self._lock:
            stale_burns = self._published_burns - set(worst)
            self._published_burns = set(worst)
        for labels_t in stale_burns:
            reg.clear_gauge("serving_slo_burn_rate", dict(labels_t),
                            exact=True)

        # 2. Per-role desired replicas from the phase burns + KV trend.
        for role, phases in ROLE_PHASES.items():
            cur = int(self.current.get(role, 1))
            burn_short = None
            burn_firing = False
            for family, target_field in phases:
                for rest, buckets in self._bucket_groups(family).items():
                    labels = dict(rest)
                    target = getattr(
                        self._targets_for(labels.get("klass", "")), target_field
                    )
                    budget = 1.0 - self.attainment_target
                    short = signals.breach_fraction(
                        buckets, target, fast.short_s, now)
                    long_ = signals.breach_fraction(
                        buckets, target, fast.long_s, now)
                    if short is None or budget <= 0:
                        continue
                    short /= budget
                    if burn_short is None or short > burn_short:
                        burn_short = short
                    if long_ is not None and short >= fast.threshold \
                            and long_ / budget >= fast.threshold:
                        burn_firing = True
            occ = occ_slope = None
            if role == "decode":
                occ_pts = self.occupancy_points()
                occ = signals.mean(occ_pts, fast.long_s, now)
                occ_slope = signals.slope(occ_pts, fast.short_s, now)
            desired, reason = self._desired(
                cur, burn_short, burn_firing, occ, occ_slope, fast
            )
            rec.desired[role] = desired
            rec.reasons[role] = reason
            reg.set("serving_scale_recommendation", float(desired),
                    {"role": role})
        return rec

    def _desired(self, cur: int, burn_short, burn_firing: bool,
                 occ, occ_slope, fast) -> tuple:
        """The policy, spelled out: scale up when the phase burn
        fires (severity-proportional, bounded), bump decode when the KV
        pool itself is the bottleneck, scale in one step only when every
        signal is both evaluable-or-absent and calm. No data ≠ calm."""
        if burn_firing and burn_short is not None:
            severity = min(MAX_SCALE_FACTOR, burn_short / fast.threshold)
            desired = max(cur + 1, math.ceil(cur * severity))
            return (min(self.max_replicas, desired),
                    f"burn {burn_short:.1f}x over threshold {fast.threshold:g}")
        if occ is not None and (
            occ >= KV_OCCUPANCY_HIGH
            or (occ_slope is not None and occ_slope > 0
                and occ + occ_slope * fast.short_s >= KV_OCCUPANCY_HIGH)
        ):
            return (min(self.max_replicas, cur + 1),
                    f"kv occupancy {occ:.0%} (slope {occ_slope or 0:+.3f}/s)")
        calm_burn = burn_short is not None and burn_short < 1.0
        calm_occ = occ is None or occ < KV_OCCUPANCY_LOW
        if calm_burn and calm_occ and cur > self.min_replicas:
            return (max(self.min_replicas, cur - 1),
                    f"calm: burn {burn_short:.2f}x, budget intact")
        return cur, ("steady" if burn_short is not None else "no signal")

    # ---- edge-triggered alert feed ---------------------------------------
    def _hold_alert(self, labels: dict, good, total, verdict, now: float) -> None:
        """While a series' fast tier fires, hold its `burn_rate:*` heartbeat
        at depth 1 with a pinned progress counter (the `circuit_open`
        convention: the Watchdog's sustained-depth rule fires once per
        episode). The NEW-episode edge also records a ring event embedding
        the offending error-series window — the next watchdog dump then
        ships the evidence inside its event ring."""
        key = _burn_key(labels)
        with self._lock:
            new_edge = key not in self._firing
            self._firing.add(key)
        self._recorder.beat(f"burn_rate:{key}", progress=0.0, depth=1.0,
                            now=now)
        if new_edge:
            window = signals.error_series(good, total)[-EVENT_WINDOW_POINTS:]
            self._recorder.record(
                "burn_rate_fired",
                series=key,
                engine=labels.get("engine", ""),
                klass=labels.get("klass", ""),
                window=verdict.window,
                short_burn=verdict.short_burn,
                long_burn=verdict.long_burn,
                threshold=verdict.threshold,
                error_window=[[t, v] for t, v in window],
            )

    def _clear_alerts(self, firing_now: set, now: float) -> None:
        with self._lock:
            cleared = self._firing - firing_now
            self._firing = set(firing_now)
        for key in cleared:
            # Advancing progress while dropping depth clears the sustained-
            # depth rule on the next watchdog pass (edge -> inactive).
            self._recorder.beat(f"burn_rate:{key}", progress=1.0, depth=0.0,
                                now=now)


def role_replicas_from_store(store) -> dict:
    """{role name: spec replicas} summed over every DisaggregatedSet in the
    store — the REAL per-role baseline the control plane's recommender
    scales from (a hardcoded baseline of 1 would both understate desired
    counts under burn and invite a calm 'scale to 1' against a wide
    fleet). Empty when no DS exists (single-LWS deployments have no
    prefill/decode roles to recommend for)."""
    out: dict = {}
    for ds in store.list("DisaggregatedSet"):
        for role in getattr(ds.spec, "roles", None) or []:
            name = getattr(role, "name", "")
            if name:
                out[name] = out.get(name, 0) + int(getattr(role, "replicas", 0) or 0)
    return out


# Process-default recommender over the process history ring: the control
# plane evaluates it per fleet-history ingest (runtime/server.py), syncing
# `current` from the store's DS roles first, so the recommendation/burn
# gauges and the `burn_rate` alert feed exist on every live deployment
# without any wiring. The same ingest step hands the verdict to the
# default ScaleActuator (obs/decisions.py), which actuates DS roles
# through the AnnotationAdapter below unless LWS_TPU_ACTUATION_DISABLE
# says otherwise.
RECOMMENDER: Optional[ScaleRecommender] = None
_RECOMMENDER_LOCK = threading.Lock()


def default_recommender(store=None) -> ScaleRecommender:
    """The process-default recommender; with `store`, its `current`
    baseline re-syncs to the store's actual per-role replica counts before
    the caller evaluates."""
    global RECOMMENDER
    with _RECOMMENDER_LOCK:
        if RECOMMENDER is None:
            from lws_tpu_torch.obs.history import HISTORY

            RECOMMENDER = ScaleRecommender(HISTORY)
        if store is not None:
            replicas = role_replicas_from_store(store)
            if replicas:
                RECOMMENDER.current = {**RECOMMENDER.current, **replicas}
        return RECOMMENDER


# ---------------------------------------------------------------------------
# The opt-in actuation seam


class AnnotationAdapter:
    """Write a recommendation into the existing pod-annotation metric
    contract (`metrics.lws.tpu/<metric>` on ready leader pods) that
    `controllers/autoscaler_controller.py` already consumes.

    The value is NORMALIZED so the HPA math reproduces the recommendation
    exactly: each of the `n` ready leaders reports `(desired - 0.5) / n`,
    and an `Autoscaler` with `spec.metric == adapter.metric` and
    `spec.target_value == 1.0` computes
    `ceil(n * avg / target) = ceil(desired - 0.5) = desired` — the half
    offset makes the ceil land on `desired` for EVERY (desired, n) pair
    (a bare `desired/n` share overshoots by one whenever the float
    round-trip lands epsilon above the integer, e.g. desired=25, n=11).
    The Autoscaler's own min/max clamps and scale-down stabilization stay
    the operator's guardrails. Driven per evaluation by the default
    `ScaleActuator` (obs/decisions.py) for DS roles; still usable directly
    for manual or out-of-tree wiring."""

    def __init__(self, store, namespace: str, target: str,
                 metric: str = "scale_recommendation") -> None:
        self.store = store
        self.namespace = namespace
        self.target = target
        self.metric = metric

    def leader_pods(self) -> list:
        from lws_tpu_torch.api import contract
        from lws_tpu_torch.utils.podutils import pod_running_and_ready

        return [
            p for p in self.store.list(
                "Pod", self.namespace,
                labels={
                    contract.SET_NAME_LABEL_KEY: self.target,
                    contract.WORKER_INDEX_LABEL_KEY: "0",
                },
            )
            if pod_running_and_ready(p)
        ]

    def publish(self, desired: int) -> int:
        """Annotate every ready leader with the normalized recommendation;
        returns the number of leaders annotated (0 = nothing to feed the
        controller yet — the caller retries on its own cadence)."""
        from lws_tpu_torch.api.autoscaler import METRIC_ANNOTATION_PREFIX
        from lws_tpu_torch.core.store import ConflictError

        leaders = self.leader_pods()
        if not leaders:
            return 0
        share = (float(desired) - 0.5) / len(leaders)
        annotated = 0
        for pod in leaders:
            for _ in range(3):  # optimistic-concurrency retries, like /report-metric
                try:
                    fresh = self.store.get("Pod", pod.meta.namespace, pod.meta.name)
                    fresh.meta.annotations[
                        METRIC_ANNOTATION_PREFIX + self.metric
                    ] = str(share)
                    self.store.update(fresh)
                    annotated += 1
                    break
                except ConflictError:
                    continue
        return annotated
