"""Decision provenance + closed-loop actuation: the flight-data recorder
for the self-driving fleet (ROADMAP item 4's last mile).

Four PRs of sensors end in two decision surfaces — `ScaleRecommender`
(obs/recommend.py) and `CanaryAnalyzer` (obs/rollout.py) — that until this
module only *published* verdicts. Closing the loop safely is itself an
observability problem: at TPU-pod serving scale an unexplainable or
oscillating autoscaler is worse than none. So the flip to actuation ships
inside its own audit trail:

  * `DecisionLedger` — a bounded ledger holding one provenance record per
    recommender/canary evaluation: the input burn windows and ring
    evidence, each guard's pass/fail, the verdict, and — once acted on —
    the actuation outcome with the target's store generation before/after
    plus convergence timing. Served at `GET /debug/decisions` on both
    servers, embedded in every watchdog dump, rendered by `lws-tpu why`.
  * `ScaleActuator` — closes the scale plane for DisaggregatedSet roles:
    the recommendation feeds the existing `AnnotationAdapter` →
    stock-`AutoscalerReconciler` contract (the HPA math reproduces the
    recommendation exactly), scale-in first drains the victim replica
    through PR-8's `DrainGate` (`POST /debug/drain`; in-flight work
    finishes, parked work queues for a successor), and a synchronous
    store watcher writes the autoscaler's moves back into
    `ds.spec.roles[*].replicas` (replicas are excluded from the revision
    hash, so scaling is never a rollout) — without the writeback the DS
    reconciler would fight every external scale.
  * `RolloutActuator` — closes the rollout plane: when the
    `canary_regression` signal fires (edge-triggered, once per episode,
    the same `rv.firing` edge that drives the watchdog rule), the stock
    `RolloutActuationAdapter` pauses the update and restores the baseline
    revision through the controller's own revision machinery.
  * The stability plane: `serving_actuations_total{plane,action,outcome}`,
    `serving_actuation_flaps_total{plane}` (direction reversal inside the
    flap window — the oscillation detector), and
    `serving_convergence_seconds{plane}` (decision → fleet settled).

Actuation is ON by default for DS roles and kill-switched exactly like
core/resilience.py: `LWS_TPU_ACTUATION_DISABLE=scale,rollout` turns the
named planes into record-only mode — verdicts and gauges still publish,
replicas and partitions provably never move.

The port's copy of lws_tpu/obs/decisions.py, whole: the ledger, both
actuators, the kill switch, `evaluate_and_actuate` and the DS writeback
(`install`), over the port's store, rollout and recommend planes. Its
process-global `DECISIONS` is the port's own object, not the JAX
package's: in a process that runs both, each side reads its own.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from lws_tpu_torch.core import flightrecorder, metrics

DISABLE_ENV = "LWS_TPU_ACTUATION_DISABLE"
PLANES = ("scale", "rollout")

# Two applied actuations on the same subject in OPPOSITE directions within
# this window count as a flap — the oscillation signal the stability plane
# exists for. Env-tunable; scaled down alongside the burn windows in tests.
FLAP_WINDOW_ENV = "LWS_TPU_FLAP_WINDOW_S"
DEFAULT_FLAP_WINDOW_S = 600.0

DEFAULT_LEDGER_CAPACITY = 512

# Verdict direction for flap detection: +1 grows/advances, -1 shrinks/
# retreats. Verdicts without a direction (hold/promote) never flap.
_DIRECTION = {"scale_out": +1, "scale_in": -1, "rollback": -1}


def disabled(plane: str) -> bool:
    """Read per call (not cached): the mutation-proof tests flip the env
    var between scenarios to prove each plane's switch is load-bearing —
    the core/resilience.py kill-switch contract, shared literally."""
    from lws_tpu_torch.core.resilience import csv_disabled

    return csv_disabled(DISABLE_ENV, plane)


def flap_window_s() -> float:
    try:
        return float(os.environ.get(FLAP_WINDOW_ENV, DEFAULT_FLAP_WINDOW_S))
    except ValueError:
        return DEFAULT_FLAP_WINDOW_S


# ---------------------------------------------------------------------------
# The provenance record


@dataclass
class DecisionRecord:
    """One evaluation's full evidence chain, JSON-shaped so it serves
    straight from `GET /debug/decisions` and renders via `lws-tpu why`:
    burn window → guards → verdict → actuation → convergence."""

    id: str
    plane: str                 # "scale" | "rollout"
    subject: str               # DS role name, or "ns/lws" for rollout
    at: float
    verdict: str               # scale_out|scale_in|hold / rollback|promote
    inputs: dict = field(default_factory=dict)   # burn/ring evidence
    guards: list = field(default_factory=list)   # [{name, passed, detail}]
    # Actuation outcome — empty until acted on. `outcome` is one of
    # applied | suppressed (kill switch) | skipped (guard) | failed.
    action: str = ""
    outcome: str = ""
    acted_at: Optional[float] = None
    generation_before: Optional[int] = None
    generation_after: Optional[int] = None
    detail: dict = field(default_factory=dict)
    # Convergence: when the fleet settled on the decided state.
    converged_at: Optional[float] = None
    convergence_s: Optional[float] = None
    # Identical repeat evaluations collapse onto one record (bounded
    # ledger ≠ bounded cadence): `repeats` counts them, `last_at` the most
    # recent — "every evaluation recorded" without a flood.
    repeats: int = 0
    last_at: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "id": self.id, "plane": self.plane, "subject": self.subject,
            "at": self.at, "verdict": self.verdict,
            "inputs": self.inputs, "guards": list(self.guards),
            "action": self.action, "outcome": self.outcome,
            "acted_at": self.acted_at,
            "generation_before": self.generation_before,
            "generation_after": self.generation_after,
            "detail": dict(self.detail),
            "converged_at": self.converged_at,
            "convergence_s": self.convergence_s,
            "repeats": self.repeats, "last_at": self.last_at,
        }


def _guard(name: str, passed: bool, detail: str = "") -> dict:
    return {"name": name, "passed": bool(passed), "detail": detail}


def _signature(plane: str, subject: str, verdict: str, guards: list) -> tuple:
    return (plane, subject, verdict,
            tuple((g["name"], g["passed"]) for g in guards))


# ---------------------------------------------------------------------------
# The ledger


# Every live ledger, weakly held: the writeback watcher scopes itself to
# PENDING APPLIED scale decisions, and those may live in a sweep- or
# test-private ledger rather than the process default — the closed-loop
# machinery must behave identically either way.
_LEDGERS: "weakref.WeakSet" = weakref.WeakSet()


class DecisionLedger:
    """Bounded, thread-safe provenance ledger. Records are appended by the
    actuators on every evaluation, annotated with the actuation outcome
    when a plane acts, and closed out with convergence timing when the
    fleet settles. `registry`/`recorder` are injectable (default the
    process globals) so tests and report folds stay hermetic."""

    def __init__(self, capacity: int = DEFAULT_LEDGER_CAPACITY,
                 registry=None, recorder=None) -> None:
        self.capacity = max(1, int(capacity))
        self._records: deque = deque()  # guarded-by: _lock
        self._by_id: dict = {}  # guarded-by: _lock
        self._seq: dict = {}  # guarded-by: _lock — per-plane id counter
        # Last applied direction per (plane, subject): the flap detector's
        # memory. (direction, at) pairs.
        self._last_direction: OrderedDict = OrderedDict()  # guarded-by: _lock
        # Last record id per (plane, subject, verdict, guard fingerprint):
        # identical repeats collapse onto it.
        self._last_sig: dict = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._registry = registry
        self._recorder = recorder
        _LEDGERS.add(self)

    def _reg(self):
        return self._registry if self._registry is not None else metrics.REGISTRY

    def _rec(self):
        return self._recorder if self._recorder is not None \
            else flightrecorder.RECORDER

    # ---- recording ---------------------------------------------------------
    def open(self, plane: str, subject: str, verdict: str, *,
             inputs: Optional[dict] = None, guards: Optional[list] = None,
             now: Optional[float] = None,
             collapse: bool = True) -> DecisionRecord:
        """Record one evaluation. When `collapse` and the previous record
        for this (plane, subject) carries the same verdict and guard
        outcomes AND was never acted on, the repeat folds onto it instead
        of appending — an idle fleet's steady "hold" stream must not flush
        the one scale-out that mattered out of a bounded window."""
        if now is None:
            now = time.time()
        guards = list(guards or [])
        sig = _signature(plane, subject, verdict, guards)
        with self._lock:
            if collapse:
                prev = self._by_id.get(self._last_sig.get((plane, subject)))
                if prev is not None and not prev.action \
                        and _signature(prev.plane, prev.subject, prev.verdict,
                                       prev.guards) == sig:
                    prev.repeats += 1
                    prev.last_at = now
                    return prev
            seq = self._seq.get(plane, 0) + 1
            self._seq[plane] = seq
            record = DecisionRecord(
                id=f"{plane}-{seq:06d}", plane=plane, subject=subject,
                at=now, verdict=verdict, inputs=dict(inputs or {}),
                guards=guards,
            )
            self._records.append(record)
            self._by_id[record.id] = record
            self._last_sig[(plane, subject)] = record.id
            while len(self._records) > self.capacity:
                victim = self._records.popleft()
                self._by_id.pop(victim.id, None)
        return record

    def actuate(self, decision_id: str, action: str, outcome: str, *,
                now: Optional[float] = None,
                generation_before: Optional[int] = None,
                generation_after: Optional[int] = None,
                **detail) -> Optional[DecisionRecord]:
        """Attach the actuation outcome to a decision, publish the
        stability metrics, and run the flap detector (applied actuations
        only — a suppressed plane cannot oscillate)."""
        if now is None:
            now = time.time()
        with self._lock:
            record = self._by_id.get(decision_id)
            if record is None:
                return None
            record.action = action
            record.outcome = outcome
            record.acted_at = now
            if generation_before is not None:
                record.generation_before = generation_before
            if generation_after is not None:
                record.generation_after = generation_after
            record.detail.update(detail)
            flapped = False
            direction = _DIRECTION.get(action)
            if outcome == "applied" and direction is not None:
                key = (record.plane, record.subject)
                prev = self._last_direction.get(key)
                if prev is not None and prev[0] == -direction \
                        and now - prev[1] <= flap_window_s():
                    flapped = True
                    record.detail["flap"] = True
                self._last_direction[key] = (direction, now)
                self._last_direction.move_to_end(key)
                while len(self._last_direction) > self.capacity:
                    self._last_direction.popitem(last=False)
        reg = self._reg()
        reg.inc("serving_actuations_total",
                {"plane": record.plane, "action": action, "outcome": outcome})
        self._rec().record(
            "actuation", plane=record.plane, subject=record.subject,
            decision=record.id, action=action, outcome=outcome,
        )
        if flapped:
            reg.inc("serving_actuation_flaps_total", {"plane": record.plane})
            self._rec().record(
                "actuation_flap", plane=record.plane,
                subject=record.subject, decision=record.id, action=action,
            )
        return record

    def refresh(self, decision_id: str, now: Optional[float] = None) -> None:
        """Count a repeat evaluation that re-drove an in-flight actuation
        (e.g. the second annotation publish a scale-down stabilization
        window requires) without minting a new decision."""
        with self._lock:
            record = self._by_id.get(decision_id)
            if record is not None:
                record.repeats += 1
                record.last_at = now if now is not None else time.time()

    def converge(self, decision_id: str, *, now: Optional[float] = None,
                 generation_after: Optional[int] = None
                 ) -> Optional[DecisionRecord]:
        if now is None:
            now = time.time()
        with self._lock:
            record = self._by_id.get(decision_id)
            if record is None or record.converged_at is not None:
                return record
            record.converged_at = now
            base = record.acted_at if record.acted_at is not None else record.at
            record.convergence_s = max(0.0, now - base)
            if generation_after is not None:
                record.generation_after = generation_after
        self._reg().observe("serving_convergence_seconds",
                            record.convergence_s, {"plane": record.plane})
        return record

    def supersede(self, decision_id: str, by_id: str) -> None:
        """A newer decision replaced a still-pending one (the desired state
        moved before the fleet reached the old one)."""
        with self._lock:
            record = self._by_id.get(decision_id)
            if record is not None and record.converged_at is None:
                record.detail["superseded_by"] = by_id
                record.converged_at = -1.0  # closed, but never "converged"

    # ---- reads -------------------------------------------------------------
    def get(self, decision_id: str) -> Optional[DecisionRecord]:
        with self._lock:
            return self._by_id.get(decision_id)

    def pending(self, plane: str) -> list:
        """Applied-but-not-yet-converged decisions, oldest first — what the
        actuators' convergence sweeps walk."""
        with self._lock:
            return [r for r in self._records
                    if r.plane == plane and r.outcome == "applied"
                    and r.converged_at is None]

    def last_actuation(self, plane: str) -> Optional[DecisionRecord]:
        """The most recent record with ANY actuation outcome on `plane` —
        the CLI's ACT column."""
        with self._lock:
            for r in reversed(self._records):
                if r.plane == plane and r.action:
                    return r
        return None

    def snapshot(self, limit: int = 256) -> list:
        """Newest-last dict window, JSON-ready (`GET /debug/decisions`,
        watchdog dumps)."""
        with self._lock:
            window = list(self._records)[-max(0, int(limit)):]
            return [r.to_dict() for r in window]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._by_id.clear()
            self._seq.clear()
            self._last_direction.clear()
            self._last_sig.clear()


DECISIONS = DecisionLedger()


# ---------------------------------------------------------------------------
# The scale plane actuator


class ScaleActuator:
    """Close the loop from a `Recommendation` to DS role replica counts —
    exclusively through the machinery that already exists: the
    `AnnotationAdapter` writes the recommendation into the pod-annotation
    metric contract, the stock `AutoscalerReconciler` moves the child LWS
    (its min/max clamps and scale-down stabilization stay the guardrails),
    and the `install()` writeback keeps `ds.spec.roles` in lockstep so the
    DS reconciler never fights the move. Scale-in first drains the victim
    replica (highest group index) through its worker telemetry server —
    `drain_fn` is injectable for hermetic tests; the default POSTs
    `/debug/drain` at the pod's published endpoint."""

    def __init__(self, store, ledger: Optional[DecisionLedger] = None,
                 min_replicas: int = 1, max_replicas: int = 8,
                 stabilization: int = 2,
                 drain_fn: Optional[Callable] = None) -> None:
        self.store = store
        self.ledger = ledger if ledger is not None else DECISIONS
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.stabilization = stabilization
        self._drain_fn = drain_fn
        # In-flight decision per role: {role: (decision id, desired)}.
        self._pending: dict = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    # ---- targeting ---------------------------------------------------------
    def targets(self) -> dict:
        """{role name: [(namespace, ds name, child lws)]} — each DS role's
        current child LeaderWorkerSets, resolved through the DS label
        contract. A role with more than one child (mid-rollout, or spread
        over slices) is not safely scalable from here: the rolling
        executor owns those replica counts."""
        from lws_tpu_torch.api import disagg

        out: dict = {}
        for ds in self.store.list("DisaggregatedSet"):
            for role in getattr(ds.spec, "roles", None) or []:
                if not role.name:
                    continue
                children = self.store.list(
                    "LeaderWorkerSet", ds.meta.namespace,
                    labels={
                        disagg.DS_NAME_LABEL_KEY: ds.meta.name,
                        disagg.DS_ROLE_LABEL_KEY: role.name,
                    },
                )
                out.setdefault(role.name, []).extend(
                    (ds.meta.namespace, ds.meta.name, child)
                    for child in children
                )
        return out

    def _ensure_autoscaler(self, namespace: str, target: str) -> str:
        """Idempotently materialize the stock Autoscaler that consumes the
        adapter's annotations — `metric=scale_recommendation`,
        `target_value=1.0`, so `ceil(n*avg/target)` reproduces the
        recommendation exactly."""
        from lws_tpu_torch.api.autoscaler import Autoscaler, AutoscalerSpec
        from lws_tpu_torch.api.meta import ObjectMeta
        from lws_tpu_torch.core.store import AlreadyExistsError

        name = f"{target}-scale"
        if self.store.try_get("Autoscaler", namespace, name) is not None:
            return "present"
        asc = Autoscaler(
            meta=ObjectMeta(name=name, namespace=namespace),
            spec=AutoscalerSpec(
                target=target, min_replicas=self.min_replicas,
                max_replicas=self.max_replicas,
                metric="scale_recommendation", target_value=1.0,
                scale_down_stabilization=self.stabilization,
            ),
        )
        try:
            self.store.create(asc)
        except AlreadyExistsError:
            return "present"
        return "created"

    def _victim(self, namespace: str, target: str):
        """The replica a one-step scale-in removes: the stock controller
        deletes the highest group index, so that group's leader is the one
        to drain."""
        from lws_tpu_torch.api import contract
        from lws_tpu_torch.utils.podutils import pod_running_and_ready

        leaders = [
            p for p in self.store.list(
                "Pod", namespace,
                labels={
                    contract.SET_NAME_LABEL_KEY: target,
                    contract.WORKER_INDEX_LABEL_KEY: "0",
                },
            )
            if pod_running_and_ready(p)
        ]
        if not leaders:
            return None
        return max(leaders, key=lambda p: int(
            p.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, "0")))

    def _drain(self, pod) -> tuple:
        """Drain the victim's worker: in-flight work finishes, parked work
        stays queued for a successor (DrainGate semantics), THEN the pod
        goes away on the autoscaler's schedule. Returns (ok, detail)."""
        from lws_tpu_torch.runtime import fleet as fleetmod

        if self._drain_fn is not None:
            try:
                return bool(self._drain_fn(pod)), pod.meta.name
            except Exception as e:  # vet: ignore[hazard-exception-swallow]: a drain failure must degrade to an undrained scale-in, never abort the actuation — the grace period still applies
                return False, f"{pod.meta.name}: {e}"
        endpoint = fleetmod.pod_metrics_endpoint(pod)
        if endpoint is None:
            return False, f"{pod.meta.name}: no telemetry endpoint"
        import urllib.request

        host, port = endpoint
        try:
            req = urllib.request.Request(
                f"http://{host}:{port}/debug/drain", data=b"{}",
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=2.0):
                pass
            return True, pod.meta.name
        except Exception as e:  # vet: ignore[hazard-exception-swallow]: same contract as above — best-effort drain, the scale-in proceeds either way
            return False, f"{pod.meta.name}: {e}"

    # ---- the evaluation-to-actuation step ----------------------------------
    def _evidence(self, rec, role: str) -> dict:
        return {
            "at": rec.at,
            "reason": rec.reasons.get(role, ""),
            "current": rec.current.get(role),
            "desired": rec.desired.get(role),
            "firing": list(rec.firing),
            "burns": list(rec.burns),
        }

    def apply(self, rec, now: Optional[float] = None) -> list:
        """One recommendation → one provenance record per role, actuated
        where every guard passes. Returns the records touched."""
        if now is None:
            now = rec.at
        out = []
        targets = self.targets()
        for role in sorted(rec.desired):
            desired = int(rec.desired[role])
            cur = int(rec.current.get(role, desired))
            verdict = "scale_out" if desired > cur else (
                "scale_in" if desired < cur else "hold")
            candidates = targets.get(role, [])
            evidence = self._evidence(rec, role)
            guards = [
                _guard("evidence", rec.reasons.get(role, "") != "no signal",
                       evidence["reason"]),
                _guard("kill_switch", not disabled("scale"),
                       os.environ.get(DISABLE_ENV, "") or "off"),
                _guard("target", len(candidates) == 1,
                       candidates[0][2].meta.name if len(candidates) == 1
                       else f"{len(candidates)} child LWS for role"),
            ]
            if verdict == "hold":
                out.append(self.ledger.open(
                    "scale", role, verdict, inputs=evidence, guards=guards,
                    now=now))
                with self._lock:
                    self._pending.pop(role, None)
                continue
            with self._lock:
                pending = self._pending.get(role)
            if pending is not None and pending[1] == desired:
                # Same move still converging: keep feeding the autoscaler
                # (scale-down stabilization NEEDS consecutive fresh
                # observations) but fold the repeat onto the open record.
                pid = pending[0]
                if all(g["passed"] for g in guards):
                    ns, _ds, child = candidates[0]
                    from lws_tpu_torch.obs.recommend import AnnotationAdapter

                    AnnotationAdapter(self.store, ns, child.meta.name).publish(
                        desired)
                self.ledger.refresh(pid, now=now)
                existing = self.ledger.get(pid)
                if existing is not None:
                    out.append(existing)
                continue
            record = self.ledger.open(
                "scale", role, verdict, inputs=evidence, guards=guards,
                now=now, collapse=False)
            out.append(record)
            if pending is not None:
                self.ledger.supersede(pending[0], record.id)
                with self._lock:
                    self._pending.pop(role, None)
            if not all(g["passed"] for g in guards):
                outcome = "suppressed" if disabled("scale") else "skipped"
                failed = [g["name"] for g in guards if not g["passed"]]
                self.ledger.actuate(
                    record.id, verdict, outcome, now=now,
                    guard=",".join(failed))
                continue
            ns, ds_name, child = candidates[0]
            autoscaler = self._ensure_autoscaler(ns, child.meta.name)
            drained = None
            if verdict == "scale_in":
                victim = self._victim(ns, child.meta.name)
                if victim is not None:
                    ok, detail = self._drain(victim)
                    drained = {"pod": victim.meta.name, "ok": ok,
                               "detail": detail}
            from lws_tpu_torch.obs.recommend import AnnotationAdapter

            published = AnnotationAdapter(
                self.store, ns, child.meta.name).publish(desired)
            outcome = "applied" if published > 0 else "failed"
            detail = {
                "namespace": ns, "ds": ds_name, "lws": child.meta.name,
                "desired": desired, "from": cur, "leaders": published,
                "autoscaler": autoscaler,
            }
            if drained is not None:
                detail["drained"] = drained
            self.ledger.actuate(
                record.id, verdict, outcome, now=now,
                generation_before=child.meta.generation, **detail)
            if outcome == "applied":
                with self._lock:
                    self._pending[role] = (record.id, desired)
        return out

    def observe(self, now: Optional[float] = None) -> list:
        """Convergence sweep: a scale decision converges when its child
        LWS reached the decided replica count in both spec and ready
        status. Returns the records that converged this pass."""
        if now is None:
            now = time.time()
        converged = []
        for record in self.ledger.pending("scale"):
            ns = record.detail.get("namespace")
            name = record.detail.get("lws")
            desired = record.detail.get("desired")
            if not ns or not name or desired is None:
                continue
            lws = self.store.try_get("LeaderWorkerSet", ns, name)
            if lws is None:
                continue
            ready = getattr(lws.status, "ready_replicas", None)
            if int(lws.spec.replicas) == int(desired) \
                    and (ready is None or int(ready) == int(desired)):
                self.ledger.converge(record.id, now=now,
                                     generation_after=lws.meta.generation)
                with self._lock:
                    if self._pending.get(record.subject, (None,))[0] \
                            == record.id:
                        self._pending.pop(record.subject, None)
                converged.append(record)
        return converged


# ---------------------------------------------------------------------------
# The rollout plane actuator


class RolloutActuator:
    """Close the loop from a `CanaryReport` to the stock rollout machinery.
    Actuation is EDGE-triggered per (lws, revision) episode — the same
    firing edge that drives the `canary_regression` watchdog rule — so a
    rollback fires once per regression, not once per scrape; the episode
    re-arms when the revision's verdict leaves rollback."""

    def __init__(self, store, ledger: Optional[DecisionLedger] = None,
                 adapter_factory: Optional[Callable] = None) -> None:
        self.store = store
        self.ledger = ledger if ledger is not None else DECISIONS
        self._adapter_factory = adapter_factory
        self._fired: set = set()  # guarded-by: _lock — (lws, revision)
        self._lock = threading.Lock()

    def _adapter(self, namespace: str, target: str):
        if self._adapter_factory is not None:
            return self._adapter_factory(self.store, namespace, target)
        from lws_tpu_torch.obs.rollout import RolloutActuationAdapter

        return RolloutActuationAdapter(self.store, namespace, target)

    def _evidence(self, report) -> dict:
        return {
            "at": report.at, "lws": report.lws,
            "baseline": report.baseline,
            "verdicts": {r: v.to_dict() for r, v in report.verdicts.items()},
        }

    def apply(self, report, now: Optional[float] = None):
        """One canary report → one provenance record; the rollback path
        pauses the update and restores the baseline through
        `RolloutActuationAdapter`. Returns the record, or None when the
        report judged nothing."""
        if not report.verdicts:
            return None
        if now is None:
            now = report.at
        offenders = sorted(
            r for r, v in report.verdicts.items()
            if v.verdict == "rollback" and r != report.baseline
        )
        verdict = "rollback" if offenders else (
            "promote" if all(v.verdict == "promote"
                             for v in report.verdicts.values()) else "hold")
        with self._lock:
            fresh = [r for r in offenders
                     if (report.lws, r) not in self._fired]
            # Re-arm episodes whose revision left the rollback verdict;
            # other targets' episodes are untouched.
            self._fired = {
                (lws, r) for (lws, r) in self._fired
                if lws != report.lws or r in offenders
            }
        guards = [
            _guard("kill_switch", not disabled("rollout"),
                   os.environ.get(DISABLE_ENV, "") or "off"),
            _guard("baseline", bool(report.baseline),
                   report.baseline or "no judged baseline"),
            _guard("regression_edge", bool(fresh),
                   ",".join(fresh) if fresh else
                   ("episode already actuated" if offenders else
                    "no rollback verdict")),
        ]
        evidence = self._evidence(report)
        if verdict != "rollback":
            return self.ledger.open("rollout", report.lws, verdict,
                                    inputs=evidence, guards=guards, now=now)
        record = self.ledger.open("rollout", report.lws, verdict,
                                  inputs=evidence, guards=guards, now=now,
                                  collapse=not fresh)
        if record.action:  # collapsed onto an already-acted record
            return record
        if not all(g["passed"] for g in guards):
            outcome = "suppressed" if disabled("rollout") else "skipped"
            failed = [g["name"] for g in guards if not g["passed"]]
            self.ledger.actuate(record.id, "rollback", outcome, now=now,
                                guard=",".join(failed))
            return record
        ns, _, name = report.lws.partition("/")
        lws = self.store.try_get("LeaderWorkerSet", ns, name)
        generation_before = lws.meta.generation if lws is not None else None
        result = self._adapter(ns, name).apply(report)
        after = self.store.try_get("LeaderWorkerSet", ns, name)
        with self._lock:
            self._fired |= {(report.lws, r) for r in fresh}
        self.ledger.actuate(
            record.id, "rollback",
            "applied" if result.get("acted") else "failed", now=now,
            generation_before=generation_before,
            generation_after=after.meta.generation if after else None,
            namespace=ns, lws=name, offenders=offenders,
            paused=result.get("paused"),
            rolled_back_to=result.get("rolled_back_to", ""),
        )
        return record

    def observe(self, now: Optional[float] = None) -> list:
        """Convergence sweep: a rollback converges when every pod of the
        target LWS is back on the restored revision and the partition is
        released."""
        from lws_tpu_torch.api import contract

        if now is None:
            now = time.time()
        converged = []
        for record in self.ledger.pending("rollout"):
            ns = record.detail.get("namespace")
            name = record.detail.get("lws")
            target = record.detail.get("rolled_back_to")
            if not ns or not name or not target:
                continue
            lws = self.store.try_get("LeaderWorkerSet", ns, name)
            if lws is None:
                continue
            ru = lws.spec.rollout_strategy.rolling_update_configuration
            if int(ru.partition) != 0:
                continue
            pods = self.store.list(
                "Pod", ns, labels={contract.SET_NAME_LABEL_KEY: name})
            if pods and all(
                p.meta.labels.get(contract.REVISION_LABEL_KEY) == target
                for p in pods
            ):
                self.ledger.converge(record.id, now=now,
                                     generation_after=lws.meta.generation)
                converged.append(record)
        return converged


# ---------------------------------------------------------------------------
# Process defaults + the control-plane seam


ACTUATOR: Optional[ScaleActuator] = None
ROLLOUT_ACTUATOR: Optional[RolloutActuator] = None
_ACTUATOR_LOCK = threading.Lock()


def default_scale_actuator(store) -> ScaleActuator:
    global ACTUATOR
    with _ACTUATOR_LOCK:
        if ACTUATOR is None or ACTUATOR.store is not store:
            ACTUATOR = ScaleActuator(store)
        return ACTUATOR


def default_rollout_actuator(store) -> RolloutActuator:
    global ROLLOUT_ACTUATOR
    with _ACTUATOR_LOCK:
        if ROLLOUT_ACTUATOR is None or ROLLOUT_ACTUATOR.store is not store:
            ROLLOUT_ACTUATOR = RolloutActuator(store)
        return ROLLOUT_ACTUATOR


def evaluate_and_actuate(store, now: Optional[float] = None) -> dict:
    """The control plane's per-ingest decision step (runtime/server.py,
    replacing the record-only pair): evaluate both planes, actuate through the
    defaults, and sweep convergence — every verdict lands in the ledger
    whether or not anything moved."""
    from lws_tpu_torch.obs import recommend as recmod
    from lws_tpu_torch.obs import rollout as rolloutmod

    rec = recmod.default_recommender(store).evaluate(now)
    actuator = default_scale_actuator(store)
    scale_records = actuator.apply(rec, now=rec.at)
    actuator.observe(now=rec.at)
    report = rolloutmod.default_canary_analyzer(store).evaluate(now)
    rollout_actuator = default_rollout_actuator(store)
    rollout_record = rollout_actuator.apply(report, now=report.at)
    rollout_actuator.observe(now=report.at)
    return {
        "scale": [r.id for r in scale_records],
        "rollout": rollout_record.id if rollout_record is not None else None,
    }


# ---------------------------------------------------------------------------
# The DS writeback watcher


def _writeback(store, ev) -> None:
    """Sync an actuator-scaled DS child LWS back into
    `ds.spec.roles[*].replicas`. Without this, `DSReconciler` re-scales the
    child to the stale spec on its next pass and the autoscaler re-scales
    it back — a permanent fight. Replicas are excluded from the DS revision
    hash (controllers/disagg/utils.py), so the writeback can never start a
    rollout. Scoped HARD to in-flight scale decisions: only a replica count
    that matches a pending applied decision for this exact child is synced,
    so the DS rolling executor's own replica stepping (role add/remove,
    revision migration) is never echoed into the spec."""
    from lws_tpu_torch.api import disagg
    from lws_tpu_torch.core.store import ConflictError

    obj = ev.obj
    if ev.type != "MODIFIED" or getattr(obj, "kind", "") != "LeaderWorkerSet":
        return
    ds_name = obj.meta.labels.get(disagg.DS_NAME_LABEL_KEY)
    role_name = obj.meta.labels.get(disagg.DS_ROLE_LABEL_KEY)
    if not ds_name or not role_name:
        return
    if not any(
        r.detail.get("lws") == obj.meta.name
        and r.detail.get("namespace") == obj.meta.namespace
        and int(r.detail.get("desired", -1)) == int(obj.spec.replicas)
        for ledger in list(_LEDGERS)
        for r in ledger.pending("scale")
    ):
        return
    for _ in range(3):  # optimistic-concurrency retries
        ds = store.try_get("DisaggregatedSet", obj.meta.namespace, ds_name)
        if ds is None:
            return
        role = ds.role(role_name)
        if role is None or int(role.replicas) == int(obj.spec.replicas):
            return
        role.replicas = int(obj.spec.replicas)
        try:
            store.update(ds)
            return
        except ConflictError:
            continue


def install(store):
    """Wire the decision plane onto a store: the synchronous replica
    writeback watcher. One call per store (the ControlPlane constructor's
    job, mirroring rollout.install). Returns the unsubscribe handle."""
    return store.watch(lambda ev: _writeback(store, ev))
