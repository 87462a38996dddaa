"""Rollout intelligence plane: the sensor-and-verdict half of canarying.

Three pieces turn a rolling update from a config mutation into an
observable, judgeable process:

  * **RolloutLedger** — a bounded, retention-aware timeline of control-plane
    state transitions (group revision flips, partition movement, DS
    lockstep steps, scale changes, drains, pod churn), fed by a store
    watcher plus a flight-recorder observer in the manager's reconcile
    path. Snapshotable at `GET /debug/rollout` and embedded in every
    watchdog dump, so a canary alert ships the rollout timeline that led
    to it.
  * **revision folds** — pure `signals.py`-style functions over the
    `HistoryRing`: the fleet exposition already labels every series with
    `revision` (and PR 15 threads the same label through worker-local
    series via LWS_TPU_REVISION), so per-(engine, revision) burn,
    attainment, TTFT/ITL quantiles, and GOOD%/SPEC%/PFX% are one
    `ring.series(family, {"revision": r})` away.
  * **CanaryAnalyzer** — promote/hold/rollback verdicts
    (`lws_rollout_canary_verdict{lws,revision}`: +1/0/-1) from
    baseline-vs-canary burn deltas, with minimum-sample and
    minimum-duration guards: NO DATA IS NOT PROMOTE — a revision that
    hasn't served enough tokens for long enough holds, it never promotes.
    While a revision's regression fires, the analyzer holds a
    `canary:{lws}/{revision}` heartbeat at depth 1 (the `circuit_open`
    convention) so the stock Watchdog `canary_regression` rule produces
    ONE alert + diagnostics dump per episode — and the firing-edge ring
    event embeds both the offending revision's error-series window and the
    ledger window, so the dump carries the evidence, not just the verdict.

`RolloutActuationAdapter` is the actuation seam: it can pause the stock
rollout controller (freeze the partition) or roll the template back to the
baseline revision via the existing ControllerRevision machinery. Since the
decision-provenance PR the edge-triggered `RolloutActuator`
(obs/decisions.py) drives it by default when a canary regression fires,
recording the full evidence chain in the decision ledger — behind the
`LWS_TPU_ACTUATION_DISABLE=rollout` kill switch, which restores the old
verdict-only behavior.

The port's copy of lws_tpu/obs/rollout.py, whole: the judging half (the
guards, the revision folds, `CanaryAnalyzer`) and the store half (the
`RolloutLedger`, `install`, `default_canary_analyzer`,
`RolloutActuationAdapter`). Its process-global `LEDGER` and `ANALYZER`
are the port's own objects, not the JAX package's.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

from lws_tpu_torch.core import flightrecorder, metrics
from lws_tpu_torch.obs import signals
from lws_tpu_torch.obs.history import HistoryRing
from lws_tpu_torch.utils.common import env_float as _env_float

# ---- guards (env-tunable per deployment; tests pass explicit values) -------
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

# Points/entries embedded in the firing-edge ring event: enough to read the
# episode, bounded so a dump stays a dump.
EVENT_WINDOW_POINTS = 64
EVENT_LEDGER_ENTRIES = 32

DEFAULT_LEDGER_CAPACITY = 512
DEFAULT_LEDGER_RETENTION_S = 3600.0

# Flight-recorder event kinds worth a rollout-timeline entry (drains,
# restarts, alerts, chaos, actuations); everything else in the ring is
# request-scale noise at rollout timescales.
LEDGER_EVENT_KINDS = frozenset((
    "drain_requested", "drain_ignored", "watchdog_alert",
    "fault_injected", "burn_rate_fired", "canary_regression_fired",
    "actuation", "actuation_flap", "autoscaler_scaled",
))


# ---------------------------------------------------------------------------
# The rollout ledger


class RolloutLedger:
    """Bounded, retention-aware timeline of control-plane transitions.

    Entries are plain dicts (`{"at", "unix", "kind", "object", "revision",
    "detail"}`) so snapshots serve straight from `GET /debug/rollout` and
    embed in watchdog dumps. Fed two ways: `observe_store_event` diffs
    tracked objects on every store watch event (the manager's reconcile
    path mutates the store, so every rollout decision lands here), and
    `observe_recorder_event` mirrors the flight-recorder kinds that matter
    at rollout timescale. `clock` is injectable for deterministic tests."""

    def __init__(self, capacity: int = DEFAULT_LEDGER_CAPACITY,
                 retention_s: float = DEFAULT_LEDGER_RETENTION_S,
                 clock=time.monotonic, registry=None,
                 capacity_per_kind: Optional[int] = None) -> None:
        """`capacity` bounds the whole timeline; `capacity_per_kind`
        (default capacity // 4, floor 64) bounds any ONE kind's share so
        fleet-scale pod churn cannot flush the partition moves and
        revision flips out of the window. Capacity evictions are counted
        (`lws_rollout_ledger_dropped_total{kind}`) — a silently shortened
        timeline reads as a quiet rollout."""
        self.retention_s = retention_s
        self.capacity = max(1, int(capacity))
        self.capacity_per_kind = (
            int(capacity_per_kind) if capacity_per_kind is not None
            else max(64, self.capacity // 4)
        )
        self._entries: deque = deque()  # guarded-by: _lock
        self._per_kind: dict = {}  # guarded-by: _lock — entry count by kind
        self._lock = threading.Lock()
        self._clock = clock
        self._registry = registry
        # Last-seen tracked fields per (kind, namespace, name): the diff
        # base observe_store_event derives transitions from. LRU-bounded —
        # a ledger must never grow with fleet size unbounded.
        self._state: OrderedDict = OrderedDict()  # guarded-by: _lock

    def _reg(self):
        return self._registry if self._registry is not None else metrics.REGISTRY

    # ---- feeds -----------------------------------------------------------
    def record(self, kind: str, obj: str = "", revision: str = "",
               now: Optional[float] = None, **detail) -> dict:
        if now is None:
            now = self._clock()
        entry = {
            "at": round(now, 6),
            "unix": round(time.time(), 6),
            "kind": kind,
            "object": obj,
            "revision": revision,
            "detail": {k: v for k, v in detail.items() if v is not None},
        }
        with self._lock:
            self._entries.append(entry)
            self._per_kind[kind] = self._per_kind.get(kind, 0) + 1
            dropped = self._evict_locked(kind)
        self._reg().inc("lws_rollout_ledger_events_total", {"kind": kind})
        for dkind, n in dropped.items():
            self._reg().inc("lws_rollout_ledger_dropped_total",
                            {"kind": dkind}, float(n))
        return entry

    def _evict_locked(self, kind: str) -> dict:  # holds-lock: _lock
        """Enforce the per-kind then the global capacity, oldest first;
        returns {kind: evicted count} for the caller to count OUTSIDE the
        lock (registry has its own lock — no nesting)."""
        dropped: dict = {}

        def _forget(victim: dict) -> None:
            vkind = victim["kind"]
            left = self._per_kind.get(vkind, 0) - 1
            if left > 0:
                self._per_kind[vkind] = left
            else:
                self._per_kind.pop(vkind, None)
            dropped[vkind] = dropped.get(vkind, 0) + 1

        if (self.capacity_per_kind > 0
                and self._per_kind.get(kind, 0) > self.capacity_per_kind):
            for victim in self._entries:
                if victim["kind"] == kind:
                    self._entries.remove(victim)
                    _forget(victim)
                    break
        while len(self._entries) > self.capacity:
            _forget(self._entries.popleft())
        return dropped

    def observe_store_event(self, ev) -> None:
        """Store watch feed: diff the tracked fields of rollout-relevant
        kinds and record the transitions. Never raises — a broken observer
        must never break the reconcile path it observes."""
        try:
            self._observe_store_event(ev)
        except Exception:  # vet: ignore[hazard-exception-swallow]: observer must never break the watched store's notify loop (BLE001 intended)
            pass

    def _observe_store_event(self, ev) -> None:
        obj = ev.obj
        kind = getattr(obj, "kind", "") or type(obj).__name__
        handler = {
            "LeaderWorkerSet": self._track_lws,
            "GroupSet": self._track_groupset,
            "DisaggregatedSet": self._track_ds,
            "Pod": self._track_pod,
            "Node": self._track_node,
        }.get(kind)
        if handler is None:
            return
        name = f"{obj.meta.namespace}/{obj.meta.name}"
        key = (kind, name)
        if ev.type == "DELETED":
            with self._lock:
                prev = self._state.pop(key, None)
            if kind == "Pod":
                self._record_pod_gone(obj, prev)
            elif prev is not None:
                self.record("deleted", obj=f"{kind} {name}",
                            revision=str(prev.get("revision", "")))
            return
        state = handler(obj, name, ev.type)
        with self._lock:
            self._state[key] = state
            self._state.move_to_end(key)
            while len(self._state) > 4096:
                self._state.popitem(last=False)

    def _prev(self, kind: str, name: str) -> Optional[dict]:
        with self._lock:
            return self._state.get((kind, name))

    def _track_lws(self, obj, name: str, ev_type: str) -> dict:
        ru = getattr(obj.spec.rollout_strategy, "rolling_update_configuration",
                     None)
        state = {
            "partition": int(getattr(ru, "partition", 0) or 0),
            "replicas": int(obj.spec.replicas),
            "updated": int(getattr(obj.status, "updated_replicas", 0) or 0),
            "ready": int(getattr(obj.status, "ready_replicas", 0) or 0),
        }
        prev = self._prev("LeaderWorkerSet", name)
        label = f"LeaderWorkerSet {name}"
        if prev is None:
            if ev_type == "ADDED":
                self.record("created", obj=label, replicas=state["replicas"])
            return state
        if state["partition"] != prev["partition"]:
            self.record("partition_move", obj=label,
                        from_partition=prev["partition"],
                        to_partition=state["partition"])
        if state["replicas"] != prev["replicas"]:
            self.record("scale", obj=label, from_replicas=prev["replicas"],
                        to_replicas=state["replicas"])
        if (state["updated"], state["ready"]) != (prev["updated"], prev["ready"]):
            self.record("rollout_progress", obj=label,
                        updated=state["updated"], ready=state["ready"],
                        replicas=state["replicas"])
        return state

    def _track_groupset(self, obj, name: str, ev_type: str) -> dict:
        from lws_tpu_torch.api import contract

        state = {
            "revision": obj.meta.labels.get(contract.REVISION_LABEL_KEY, ""),
            "partition": int(getattr(obj.spec.update_strategy, "partition", 0)
                             or 0),
        }
        prev = self._prev("GroupSet", name)
        label = f"GroupSet {name}"
        if prev is None:
            if ev_type == "ADDED" and state["revision"]:
                self.record("group_created", obj=label,
                            revision=state["revision"])
            return state
        if state["revision"] != prev["revision"]:
            self.record("revision_flip", obj=label,
                        revision=state["revision"],
                        from_revision=prev["revision"])
        if state["partition"] != prev["partition"]:
            self.record("partition_move", obj=label,
                        revision=state["revision"],
                        from_partition=prev["partition"],
                        to_partition=state["partition"])
        return state

    def _track_ds(self, obj, name: str, ev_type: str) -> dict:
        roles = tuple(
            (getattr(r, "name", ""), int(getattr(r, "replicas", 0) or 0))
            for r in (getattr(obj.spec, "roles", None) or [])
        )
        state = {
            "revision": getattr(obj.status, "current_revision", "") or "",
            "roles": roles,
        }
        prev = self._prev("DisaggregatedSet", name)
        label = f"DisaggregatedSet {name}"
        if prev is None:
            return state
        if state["revision"] != prev["revision"]:
            self.record("ds_revision_flip", obj=label,
                        revision=state["revision"],
                        from_revision=prev["revision"])
        if state["roles"] != prev["roles"]:
            self.record("ds_lockstep_step", obj=label,
                        revision=state["revision"],
                        from_roles=dict(prev["roles"]),
                        to_roles=dict(roles))
        return state

    def _pod_revision(self, obj) -> str:
        # Same precedence as the fleet scraper's labels (runtime/fleet.py):
        # the DS per-role revision first, the LWS template revision second.
        from lws_tpu_torch.api import contract, disagg

        return (obj.meta.labels.get(disagg.DS_REVISION_LABEL_KEY)
                or obj.meta.labels.get(contract.REVISION_LABEL_KEY) or "")

    def _track_pod(self, obj, name: str, ev_type: str) -> dict:
        phase = str(getattr(obj.status, "phase", "") or "")
        state = {"revision": self._pod_revision(obj), "phase": phase}
        prev = self._prev("Pod", name)
        label = f"Pod {name}"
        if prev is None:
            if ev_type == "ADDED":
                self.record("pod_created", obj=label,
                            revision=state["revision"])
            return state
        if phase != prev["phase"] and phase in ("Failed", "Succeeded"):
            self.record("pod_phase", obj=label, revision=state["revision"],
                        phase=phase)
        return state

    def _record_pod_gone(self, obj, prev: Optional[dict]) -> None:
        self.record("pod_deleted",
                    obj=f"Pod {obj.meta.namespace}/{obj.meta.name}",
                    revision=(prev or {}).get("revision",
                                              self._pod_revision(obj)))

    def _track_node(self, obj, name: str, ev_type: str) -> dict:
        state = {"unschedulable": bool(getattr(obj.spec, "unschedulable",
                                               False))}
        prev = self._prev("Node", name)
        if prev is not None and state["unschedulable"] != prev["unschedulable"]:
            self.record("cordon" if state["unschedulable"] else "uncordon",
                        obj=f"Node {obj.meta.name}")
        return state

    def observe_recorder_event(self, event: dict) -> None:
        """Flight-recorder feed: mirror the event kinds that matter at
        rollout timescale (drains, alerts, chaos) into the timeline."""
        try:
            kind = event.get("kind", "")
            if kind not in LEDGER_EVENT_KINDS:
                return
            detail = {
                k: v for k, v in event.items()
                if k not in ("kind", "ts", "trace", "revision",
                             "error_window", "ledger_window")
                and isinstance(v, (str, int, float, bool))
            }
            self.record(kind,
                        obj=str(event.get("series") or event.get("source")
                                or event.get("point") or ""),
                        revision=str(event.get("revision", "")), **detail)
        except Exception:  # vet: ignore[hazard-exception-swallow]: observer must never break event recording (BLE001 intended)
            pass

    # ---- views -----------------------------------------------------------
    def _sweep(self, now: float) -> None:
        cutoff = now - self.retention_s
        with self._lock:
            while self._entries and self._entries[0]["at"] < cutoff:
                aged = self._entries.popleft()
                left = self._per_kind.get(aged["kind"], 0) - 1
                if left > 0:
                    self._per_kind[aged["kind"]] = left
                else:
                    self._per_kind.pop(aged["kind"], None)

    def snapshot(self, limit: int = 256,
                 now: Optional[float] = None) -> list:
        """The newest `limit` retained entries, oldest first — the
        `GET /debug/rollout` body and the watchdog dump embed."""
        self._sweep(self._clock() if now is None else now)
        with self._lock:
            out = list(self._entries)
        return out[-limit:] if limit else []

    def window(self, since_s: float, now: Optional[float] = None) -> list:
        """Entries from the trailing `since_s` seconds — the slice a canary
        alert embeds next to the offending revision's error series."""
        if now is None:
            now = self._clock()
        self._sweep(now)
        cutoff = now - since_s
        with self._lock:
            return [e for e in self._entries if e["at"] >= cutoff]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._per_kind.clear()
            self._state.clear()


# Process-default ledger: the control plane wires its store watch + the
# process flight recorder into THIS instance (runtime/harness.py install()),
# and the watchdog dump / debug endpoint snapshot it.
LEDGER = RolloutLedger()

_INSTALL_LOCK = threading.Lock()
_RECORDER_OBSERVED = False


def _default_recorder_observer(event: dict) -> None:
    LEDGER.observe_recorder_event(event)


def install(store=None):
    """Wire the process-default ledger: subscribe it to the process flight
    recorder (once) and, with `store`, to that store's watch feed. Returns
    the store-watch unsubscribe callable (None without a store)."""
    global _RECORDER_OBSERVED
    with _INSTALL_LOCK:
        if not _RECORDER_OBSERVED:
            flightrecorder.RECORDER.add_observer(_default_recorder_observer)
            _RECORDER_OBSERVED = True
    if store is not None:
        return store.watch(LEDGER.observe_store_event)
    return None


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
        ledger: Optional[RolloutLedger] = None,
        registry=None,
        recorder: Optional[flightrecorder.FlightRecorder] = None,
    ) -> None:
        """`lws` labels the verdict gauge (the deployment under analysis;
        `default_canary_analyzer` syncs it from the store). Guards default
        from env (`LWS_TPU_CANARY_MIN_SAMPLES` / `_MIN_DURATION_S` /
        `_DELTA`); `windows` the burn tiers (default
        `signals.burn_windows()`, env-scalable); `ledger` contributes the
        timeline window a firing-edge event embeds; `registry`/`recorder`
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
        self.ledger = ledger
        self._registry = registry
        self._recorder = (recorder if recorder is not None
                          else flightrecorder.RECORDER)
        self._lock = threading.Lock()
        self._firing: set = set()             # guarded-by: _lock
        self._published_verdicts: set = set()  # guarded-by: _lock
        self._published_burns: set = set()     # guarded-by: _lock
        self._last_verdicts: dict = {}         # guarded-by: _lock

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
            changed = {
                r: v.verdict for r, v in report.verdicts.items()
                if self._last_verdicts.get(r) != v.verdict
            }
            self._last_verdicts = {
                r: v.verdict for r, v in report.verdicts.items()
            }
        for labels_t in stale_verdicts:
            reg.clear_gauge("lws_rollout_canary_verdict", dict(labels_t),
                            exact=True)
        for labels_t in stale_burns:
            reg.clear_gauge("serving_slo_burn_rate_by_revision",
                            dict(labels_t), exact=True)
        if self.ledger is not None:
            for rev, verdict in changed.items():
                self.ledger.record("canary_verdict", obj=self.lws,
                                   revision=rev, now=now, verdict=verdict,
                                   reason=report.verdicts[rev].reason)
        return report

    # ---- edge-triggered alert feed ---------------------------------------
    def _hold_alert(self, rev: str, rv: RevisionVerdict, now: float) -> None:
        """While a revision's regression verdict holds, pin its
        `canary:{lws}/{revision}` heartbeat at depth 1 (the `circuit_open`
        convention: the Watchdog's `canary_regression` rule fires once per
        episode). The NEW-episode edge records a ring event embedding the
        offending revision's error-series window AND the rollout-ledger
        window — the next watchdog dump ships the full evidence."""
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
            ledger_window = (
                self.ledger.snapshot(limit=EVENT_LEDGER_ENTRIES, now=now)
                if self.ledger is not None else []
            )
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
                ledger_window=ledger_window,
            )

    def _clear_alerts(self, firing_now: set, now: float) -> None:
        with self._lock:
            cleared = self._firing - {f"{self.lws}/{r}" for r in firing_now}
            self._firing = {f"{self.lws}/{r}" for r in firing_now}
        for key in cleared:
            self._recorder.beat(f"canary:{key}", progress=1.0, depth=0.0,
                                now=now)


# Process-default analyzer over the process history ring + ledger: the
# control plane evaluates it per fleet-history ingest (runtime/server.py),
# so the verdict/burn gauges and the `canary_regression` alert feed exist
# on every live deployment without wiring. The analyzer itself never
# mutates the store: acting on its reports is the RolloutActuator's job
# (obs/decisions.py — on by default, LWS_TPU_ACTUATION_DISABLE=rollout to
# record only).
ANALYZER: Optional[CanaryAnalyzer] = None
_ANALYZER_LOCK = threading.Lock()


def default_canary_analyzer(store=None) -> CanaryAnalyzer:
    """The process-default analyzer; with `store`, its `lws` target label
    re-syncs to the store's first LeaderWorkerSet before the caller
    evaluates."""
    global ANALYZER
    with _ANALYZER_LOCK:
        if ANALYZER is None:
            from lws_tpu_torch.obs.history import HISTORY

            ANALYZER = CanaryAnalyzer(HISTORY, ledger=LEDGER)
        if store is not None:
            names = sorted(
                f"{o.meta.namespace}/{o.meta.name}"
                for o in store.list("LeaderWorkerSet")
            )
            if names:
                ANALYZER.lws = names[0]
        return ANALYZER


# ---------------------------------------------------------------------------
# The opt-in actuation seam


class RolloutActuationAdapter:
    """Act on a rollback verdict through the stock rollout machinery:
    `pause()` freezes the rolling update by raising the partition to the
    replica count (groups below the partition are never updated — the
    existing canary/xPyD semantics), and `rollback(revision_key)` restores
    the template from the named ControllerRevision via the same
    `utils/revision.py` path the controller uses, so the rollout controller
    itself walks the fleet back. Driven by the edge-triggered
    `RolloutActuator` (obs/decisions.py) when a canary regression fires —
    behind the `LWS_TPU_ACTUATION_DISABLE=rollout` kill switch; still
    usable directly for manual rollbacks."""

    def __init__(self, store, namespace: str, target: str) -> None:
        self.store = store
        self.namespace = namespace
        self.target = target

    def _retry_update(self, mutate) -> bool:
        from lws_tpu_torch.core.store import ConflictError

        for _ in range(3):  # optimistic-concurrency retries
            lws = self.store.get("LeaderWorkerSet", self.namespace,
                                 self.target)
            if lws is None:
                return False
            if not mutate(lws):
                return False
            try:
                self.store.update(lws)
                return True
            except ConflictError:
                continue
        return False

    def pause(self) -> bool:
        """Freeze the rollout where it stands: partition = replicas means
        every group index is below the partition, so no further group is
        updated until an operator (or a rollback) moves it."""
        def mutate(lws) -> bool:
            ru = lws.spec.rollout_strategy.rolling_update_configuration
            ru.partition = int(lws.spec.replicas)
            return True

        return self._retry_update(mutate)

    def rollback(self, revision_key: str) -> bool:
        """Restore the LWS template from the named ControllerRevision and
        release the partition — the stock controller then rolls every
        group back to the restored (now-current) template."""
        from lws_tpu_torch.utils import revision as revisionutils

        def mutate(lws) -> bool:
            rev = revisionutils.get_revision(self.store, lws, revision_key)
            if rev is None:
                return False
            restored = revisionutils.apply_revision(lws, rev)
            lws.spec.leader_worker_template = \
                restored.spec.leader_worker_template
            lws.spec.network_config = restored.spec.network_config
            lws.spec.rollout_strategy.rolling_update_configuration.partition = 0
            return True

        return self._retry_update(mutate)

    def apply(self, report: CanaryReport) -> dict:
        """Act on a CanaryReport: when any non-baseline revision's verdict
        is `rollback` and a judged baseline exists, pause the rollout and
        restore the baseline revision. Returns what was done."""
        offenders = [
            r for r, v in report.verdicts.items()
            if v.verdict == "rollback" and r != report.baseline
        ]
        if not offenders or not report.baseline:
            return {"acted": False, "offenders": offenders}
        paused = self.pause()
        rolled_back = self.rollback(report.baseline)
        return {
            "acted": rolled_back, "paused": paused,
            "rolled_back_to": report.baseline, "offenders": offenders,
        }
