"""Request-journey forensics: the port's copy of lws_tpu/obs/journey.py,
the tail-sampled trace vault a worker serves at `/debug/request[s]`.

The bounded span ring (`core/trace.py`) evicts a slow request's early
spans before it finishes, and nothing else joins spans, SLO verdicts,
KV-stream chunk timings and retry/breaker/deadline/fault events into one
per-request story. The `JourneyVault` is that join, with TAIL-BASED
retention:

  * **Journeys assemble from three feeds.** A trace finish listener
    (`Tracer.add_finish_listener`) buffers every finished span by trace id;
    a flight-recorder observer (`FlightRecorder.add_observer`) attaches
    resilience events (retries, breaker transitions, deadline trips, fault
    injections, torn KV streams) by request id or trace ctx; an SLO sink
    (`SLORecorder.journey_sinks`) completes the journey with the timeline's
    phase values, targets, and attainment verdict. `install()` wires all
    three onto the process defaults — the worker telemetry server
    (runtime/telemetry.py) calls it. The disaggregated workers also call
    `annotate` (the KV chunk timelines) and `complete` (a dropped, expired
    or failed request's ending) directly, and the compile ledger
    (obs/device.py) annotates a request's journey with its compiles.
  * **Retention is decided at completion, tail-first.** SLO-breaching,
    errored, deadline-expired, retried, and fault-touched requests are kept
    100%; the slowest-K healthy requests per retention window ride along;
    a small reservoir fraction of the remaining healthy ones
    (`LWS_TPU_JOURNEY_SAMPLE`) keeps the baseline comparable. Everything is
    bounded (`LWS_TPU_JOURNEY_BUDGET` total span/event/annotation records)
    and every loss is counted in the same record units:
    `serving_journeys_retained_total{outcome}` /
    `serving_journeys_dropped_total{reason}`. Healthy pressure evicts
    sampled journeys first, then slowest ones — a retained breached
    journey is never evicted by a flood of healthy traffic.
  * **Exemplars resolve vault-first.** An SLO histogram exemplar carries a
    trace id; a breaching observation belongs to a request that fails
    attainment, so its journey is retained and `get(trace_id)` finds it
    long after the span ring wrapped — the ring is only the fallback for
    unsampled healthy traffic.

Each process's vault holds its LOCAL leg (keyed by the request id that
rides the KV frame meta); the JAX control plane's API server fleet-joins
the legs of every worker, JAX's or the port's, through their
`GET /debug/request/{id}`. The module-level VAULT is the process default,
like metrics.REGISTRY and trace.TRACER (the port's, not the JAX package's).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from lws_tpu_torch.core import metrics
from lws_tpu_torch.utils.common import env_float as _env_float

JOURNEYS_ENV = "LWS_TPU_JOURNEYS"          # "0" disables install()
SAMPLE_ENV = "LWS_TPU_JOURNEY_SAMPLE"      # healthy reservoir fraction
BUDGET_ENV = "LWS_TPU_JOURNEY_BUDGET"      # total retained span+event records
SOURCE_BUDGET_ENV = "LWS_TPU_JOURNEY_SOURCE_BUDGET"  # per (klass, revision)
RETENTION_ENV = "LWS_TPU_JOURNEY_RETENTION_S"

DEFAULT_SAMPLE_RATE = 0.02
DEFAULT_BUDGET_RECORDS = 8192
DEFAULT_SOURCE_BUDGET_RECORDS = 2048
DEFAULT_SLOWEST_K = 16
DEFAULT_RETENTION_S = 900.0
DEFAULT_MAX_OPEN_TRACES = 512
DEFAULT_MAX_SPANS = 256

# /debug/requests?outcome= vocabulary (the index surface's 400 contract).
OUTCOMES = ("all", "breached", "errored", "deadline_expired", "retried",
            "fault", "slowest", "sampled")

# Flight-recorder event kinds that join a journey and the retention flag
# each one raises. `fault_injected` marks chaos-touched requests; the
# torn-stream/requeue/replay kinds are the at-least-once retry story.
_EVENT_FLAGS = {
    "retry": "retried",
    "kv_stream_torn": "retried",
    "kv_requeue": "retried",
    "replay_deduped": "retried",
    "circuit_breaker": "retried",
    "deadline_exceeded": "deadline_expired",
    "fault_injected": "fault",
}

# Must-keep flag priority for the journey's outcome label.
_FLAG_PRIORITY = ("errored", "deadline_expired", "breached", "retried",
                  "fault")


class _Journey:
    __slots__ = (
        "id", "trace_id", "root_span_id", "engine", "klass", "revision",
        "spans", "events", "annotations", "timeline", "flags", "outcome",
        "completed", "completed_unix", "completed_mono", "latency_s",
        "spans_dropped",
    )

    def __init__(self, rid: str) -> None:
        self.id = rid
        self.trace_id: Optional[str] = None
        # The span id the completion ctx named (the request's root span,
        # which closes AFTER the timeline finishes): once it attaches, the
        # journey's trace claim is released — several requests may share
        # one trace (a client grafting requests onto a reconcile root),
        # and a finished journey must not steal the next request's spans.
        self.root_span_id: Optional[str] = None
        self.engine = ""
        self.klass = ""
        self.revision = ""
        self.spans: list[dict] = []
        self.events: list[dict] = []
        self.annotations: dict = {}
        self.timeline: dict = {}
        self.flags: set = set()
        self.outcome = "open"
        self.completed = False
        self.completed_unix = 0.0
        self.completed_mono = 0.0
        self.latency_s = 0.0
        self.spans_dropped = 0

    def records(self) -> int:
        # Annotations (KV chunk timelines) count too: a retained streamed
        # journey's per-chunk dicts are real memory the budget must see.
        ann = sum(len(v) if isinstance(v, list) else 1
                  for v in self.annotations.values())
        return len(self.spans) + len(self.events) + ann

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "trace_id": self.trace_id,
            "engine": self.engine,
            "klass": self.klass,
            "revision": self.revision,
            "outcome": self.outcome,
            "flags": sorted(self.flags),
            "completed": self.completed,
            "completed_unix": round(self.completed_unix, 6),
            "latency_s": round(self.latency_s, 6),
            "timeline": dict(self.timeline),
            "spans": list(self.spans),
            "events": list(self.events),
            "annotations": dict(self.annotations),
            "spans_dropped": self.spans_dropped,
        }

    def digest(self) -> dict:
        """The compact index row (`/debug/requests`, watchdog dumps)."""
        return {
            "id": self.id,
            "trace_id": self.trace_id,
            "engine": self.engine,
            "klass": self.klass,
            "revision": self.revision,
            "outcome": self.outcome,
            "flags": sorted(self.flags),
            "latency_s": round(self.latency_s, 6),
            "ttft_s": self.timeline.get("ttft_s"),
            "total_s": self.timeline.get("total_s"),
            "completed_unix": round(self.completed_unix, 6),
            "spans": len(self.spans),
            "events": len(self.events),
        }


def enabled() -> bool:
    """The plane's kill switch (`LWS_TPU_JOURNEYS=0`). Gates install() AND
    the direct vault entry points the disagg workers call (`complete`,
    `annotate`), so disabling really disables — no half-on vault filling
    behind unregistered listeners."""
    return os.environ.get(JOURNEYS_ENV, "1").lower() not in ("0", "false",
                                                             "off")


def verdict(journey: dict) -> dict:
    """One-line verdict for a journey record: which phase blew the budget?
    Pure function of the journey's timeline + flags, shared by the explain
    renderer and tests. Returns {"ok", "phase", "value", "target", "text"}
    — `phase` is None when every recorded phase met its target."""
    flags = set(journey.get("flags") or [])
    tl = journey.get("timeline") or {}
    targets = tl.get("targets") or {}
    if "errored" in flags:
        err = tl.get("error") or next(
            (e.get("error") for e in journey.get("events") or []
             if e.get("error")), "request failed",
        )
        return {"ok": False, "phase": "error", "value": None, "target": None,
                "text": f"FAILED — {err}"}
    if "deadline_expired" in flags:
        return {"ok": False, "phase": "deadline", "value": None,
                "target": None,
                "text": "DEADLINE EXPIRED — the request's budget ran out "
                        "before the work finished"}
    checks = (
        ("queue_wait", tl.get("queue_wait_s"), targets.get("queue_wait_s")),
        ("ttft", tl.get("ttft_s"), targets.get("ttft_s")),
        ("itl", tl.get("worst_itl_s"), targets.get("itl_s")),
    )
    worst = None
    for phase, value, target in checks:
        if value is None or target is None or value <= target:
            continue
        overrun = value / target if target > 0 else float("inf")
        if worst is None or overrun > worst[3]:
            worst = (phase, value, target, overrun)
    if worst is not None:
        phase, value, target, _ = worst
        if phase == "ttft":
            # Compile blame: when the compile ledger annotated this journey
            # (obs/device.py) and the compile seconds cover at
            # least half the TTFT overrun, recompilation IS the phase —
            # name it, so the fix is bucket tuning, not prefill capacity.
            compiles = (journey.get("annotations") or {}).get("compiles") or []
            compile_s = sum(c.get("seconds") or 0.0 for c in compiles)
            if compiles and compile_s >= 0.5 * (value - target):
                kinds = sorted({c.get("kind") or "?" for c in compiles})
                return {
                    "ok": False, "phase": "compile", "value": value,
                    "target": target,
                    "text": f"BREACHED — ttft {value:.4f}s blew the "
                            f"{target:.4f}s budget; {compile_s:.4f}s of it "
                            f"was kernel compilation ({len(compiles)} "
                            f"{'/'.join(kinds)} compile(s) — tune shape "
                            "buckets, don't add prefill capacity)",
                }
        return {
            "ok": False, "phase": phase, "value": value, "target": target,
            "text": f"BREACHED — {phase} {value:.4f}s blew the "
                    f"{target:.4f}s budget",
        }
    if "breached" in flags:
        return {"ok": False, "phase": "unknown", "value": None,
                "target": None,
                "text": "BREACHED — attainment verdict was false but no "
                        "recorded phase exceeds its target"}
    extra = " (retried)" if "retried" in flags else ""
    return {"ok": True, "phase": None, "value": None, "target": None,
            "text": f"ok — every recorded phase within target{extra}"}


def _closes_tree(j: _Journey, record: dict) -> bool:
    """True when `record` is an ancestor the journey's spans already point
    at but the journey doesn't hold — the late-closing parent chain of a
    completed request whose ctx named no root span. Anything else arriving
    on a completed journey's trace belongs to a different request."""
    sid = record.get("span_id")
    if sid is None:
        return False
    held = {s.get("span_id") for s in j.spans}
    if sid in held:
        return False
    return any(s.get("parent_id") == sid for s in j.spans)


class JourneyVault:
    def __init__(
        self,
        budget_records: Optional[int] = None,
        source_budget_records: Optional[int] = None,
        slowest_k: int = DEFAULT_SLOWEST_K,
        sample_rate: Optional[float] = None,
        retention_s: Optional[float] = None,
        max_open_traces: int = DEFAULT_MAX_OPEN_TRACES,
        max_spans_per_journey: int = DEFAULT_MAX_SPANS,
        registry=None,
        rng: Optional[Callable[[], float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        """`budget_records` bounds the TOTAL retained span/event/annotation
        records (env LWS_TPU_JOURNEY_BUDGET); `source_budget_records` bounds
        each (klass, revision) source's share of it (env
        LWS_TPU_JOURNEY_SOURCE_BUDGET, 0 disables) so one hot class at
        fleet scale cannot evict every other source's tail evidence through
        the global budget; `slowest_k` the healthy slow set;
        `sample_rate` the healthy reservoir fraction (env
        LWS_TPU_JOURNEY_SAMPLE); `retention_s` ages completed journeys out
        (env LWS_TPU_JOURNEY_RETENTION_S). `rng`/`clock` are injectable so
        retention tests are deterministic."""
        self.budget_records = int(
            budget_records if budget_records is not None
            else _env_float(BUDGET_ENV, DEFAULT_BUDGET_RECORDS)
        )
        self.source_budget_records = int(
            source_budget_records if source_budget_records is not None
            else _env_float(SOURCE_BUDGET_ENV, DEFAULT_SOURCE_BUDGET_RECORDS)
        )
        self.slowest_k = max(0, int(slowest_k))
        self.sample_rate = (
            sample_rate if sample_rate is not None
            else _env_float(SAMPLE_ENV, DEFAULT_SAMPLE_RATE)
        )
        self.retention_s = (
            retention_s if retention_s is not None
            else _env_float(RETENTION_ENV, DEFAULT_RETENTION_S)
        )
        self.max_open_traces = max(1, int(max_open_traces))
        self.max_spans_per_journey = max(1, int(max_spans_per_journey))
        self._registry = registry
        self._rng = rng if rng is not None else random.random
        self._clock = clock
        self._lock = threading.Lock()
        # trace_id -> buffered finished spans (requests still in flight,
        # before any completion names them). LRU-bounded: evictions are
        # counted — this is where the span ring's wrap problem is solved,
        # so its own bound must be visible too.
        self._open_traces: "OrderedDict[str, list]" = OrderedDict()  # guarded-by: _lock
        # trace_id -> buffered resilience events for requests still in
        # flight whose events carry only a trace ctx (resilience.call's
        # retry events have no request id): joined at complete(), so a
        # mid-request retry still raises the must-keep `retried` flag.
        # Bounded exactly like the open-span buffers.
        self._open_events: "OrderedDict[str, list]" = OrderedDict()  # guarded-by: _lock
        # trace_id -> journey that claimed it (spans arriving after the
        # claim — the root serve.request span closes last — attach direct).
        self._trace_owner: dict[str, _Journey] = {}  # guarded-by: _lock
        # request_id -> journey opened by an event/annotation before its
        # completion arrived (bounded like the open traces).
        self._pending: "OrderedDict[str, _Journey]" = OrderedDict()  # guarded-by: _lock
        self._kept: "OrderedDict[str, _Journey]" = OrderedDict()  # guarded-by: _lock
        self._records = 0  # guarded-by: _lock — span+event records in _kept
        # (klass, revision) -> retained records charged to that source; the
        # fairness ledger behind source_budget_records.
        self._source_records: dict = {}  # guarded-by: _lock
        # Disambiguates trace-derived keys when several requests complete
        # on one shared trace (engine paths have no wire request id).
        self._trace_seq = 0  # guarded-by: _lock

    # ---- metrics ---------------------------------------------------------
    def _inc(self, name: str, labels: dict, value: float = 1.0) -> None:
        reg = self._registry if self._registry is not None else metrics.REGISTRY
        reg.inc(name, labels, value)

    def _retained(self, outcome: str) -> None:  # holds-lock: _lock
        self._inc("serving_journeys_retained_total", {"outcome": outcome})

    def _dropped(self, reason: str, n: int = 1) -> None:  # holds-lock: _lock
        self._inc("serving_journeys_dropped_total", {"reason": reason},
                  float(n))

    # ---- source ledger ---------------------------------------------------
    @staticmethod
    def _source_of(j: _Journey) -> tuple:
        return (j.klass or "", j.revision or "")

    def _bump_source_locked(self, j: _Journey, n: int) -> None:  # holds-lock: _lock
        """Adjust the (klass, revision) ledger by `n` records. klass and
        revision are fixed at complete() before retention, so post-retention
        record growth (late spans, events, annotations) charges the same
        bucket the retention charge opened."""
        if self.source_budget_records <= 0 or n == 0:
            return
        key = self._source_of(j)
        total = self._source_records.get(key, 0) + n
        if total > 0:
            self._source_records[key] = total
        else:
            self._source_records.pop(key, None)

    # ---- feeds -----------------------------------------------------------
    def on_span(self, record: dict) -> None:
        """Trace finish listener: buffer the span under its trace id (or
        attach it straight to the journey that already claimed the trace).
        This is the decode hot path's recurring cost — one lock, one dict
        lookup, one append. Listener contract: runs on the
        finishing span's own thread, so a vault bug must surface as a lost
        journey record, never as an exception into that thread."""
        try:
            self._on_span(record)
        except Exception:  # noqa: BLE001 — a vault bug must never break span accounting on the finishing thread
            pass

    def _on_span(self, record: dict) -> None:
        tid = record.get("trace_id")
        if not tid:
            return
        with self._lock:
            owner = self._trace_owner.get(tid)
            # A COMPLETED journey only accepts its own root span (the span
            # the completion ctx named, which closes after the timeline
            # finishes — everything below it already closed by then). Any
            # OTHER span arriving on a finished journey's trace belongs to
            # a different request re-using the trace (client grafting onto
            # a reconcile root, or a worker that completed a dropped
            # request against the client's wire ctx whose root will never
            # close HERE) — buffer it fresh instead of letting a finished
            # journey steal it.
            if owner is not None and owner.completed \
                    and record.get("span_id") != owner.root_span_id \
                    and not (owner.root_span_id is None
                             and _closes_tree(owner, record)):
                owner = None
            if owner is not None:
                if len(owner.spans) < self.max_spans_per_journey:
                    owner.spans.append(record)
                    if owner.completed:
                        self._records += 1
                        self._bump_source_locked(owner, 1)
                        self._enforce_budget_locked()
                else:
                    owner.spans_dropped += 1
                    self._dropped("journey_span_cap")
                # The completed journey's own root closed: release the
                # trace so the NEXT request sharing this trace id buffers
                # its spans fresh instead of feeding a finished journey.
                if owner.completed and self._trace_owner.get(tid) is owner \
                        and (record.get("span_id") == owner.root_span_id
                             if owner.root_span_id is not None
                             else record.get("parent_id") is None):
                    del self._trace_owner[tid]
                return
            bucket = self._open_traces.get(tid)
            if bucket is None:
                while len(self._open_traces) >= self.max_open_traces:
                    _, evicted = self._open_traces.popitem(last=False)
                    self._dropped("open_evicted", len(evicted) or 1)
                bucket = self._open_traces[tid] = []
            else:
                self._open_traces.move_to_end(tid)
            if len(bucket) < self.max_spans_per_journey:
                bucket.append(record)
            else:
                self._dropped("journey_span_cap")

    def on_event(self, event: dict) -> None:
        """Flight-recorder observer: attach resilience/chaos events to the
        journey they belong to — by explicit `request_id` field first, by
        the event's recorded trace ctx second. Unjoinable events are
        ignored (the ring still has them). Same containment contract as
        on_span: the recording thread never sees a vault exception."""
        try:
            self._on_event(event)
        except Exception:  # noqa: BLE001 — a vault bug must cost one journey join, not the recording thread
            pass

    def _on_event(self, event: dict) -> None:
        flag = _EVENT_FLAGS.get(event.get("kind", ""))
        if flag is None:
            return
        rid = str(event.get("request_id") or event.get("id") or "")
        ctx = event.get("trace") or {}
        tid = ctx.get("trace_id") if isinstance(ctx, dict) else None
        with self._lock:
            j = None
            if rid:
                j = self._kept.get(rid) or self._pending.get(rid)
            if j is None and tid:
                owner = self._trace_owner.get(tid)
                if owner is not None and not owner.completed:
                    j = owner
            if j is None:
                if not rid:
                    if tid:
                        # Trace-only event for a request still in flight
                        # (resilience.call's retry events carry no id):
                        # buffer under the trace, joined at complete() —
                        # a mid-request retry must still raise the
                        # must-keep `retried` flag.
                        self._buffer_event_locked(tid, event)
                    return
                j = self._open_pending_locked(rid)
                if j is None:
                    return
                if tid:
                    j.trace_id = tid
                    self._trace_owner.setdefault(tid, j)
            if len(j.events) >= self.max_spans_per_journey:
                self._dropped("journey_event_cap")
                return
            j.events.append(dict(event))
            j.flags.add(flag)
            if j.completed:
                self._records += 1
                self._bump_source_locked(j, 1)
                # A must-keep signal arriving after a sampled/slowest
                # retention upgrades the journey's eviction class.
                if j.outcome in ("sampled", "slowest"):
                    j.outcome = self._outcome_locked(j)
                self._enforce_budget_locked()

    def on_timeline(self, summary: dict) -> None:
        """SLO sink (`SLORecorder.journey_sinks`): a request timeline
        finished — complete the journey with its phase values and verdict.
        Contained like the other feeds (the sink loop in slo.py also
        wraps, but the vault does not rely on every dispatcher doing so)."""
        try:
            self._on_timeline(summary)
        except Exception:  # noqa: BLE001 — a vault bug must not fail a request's SLO completion
            pass

    def _on_timeline(self, summary: dict) -> None:
        phases = {
            k: summary.get(k)
            for k in ("queue_wait_s", "ttft_s", "worst_itl_s", "total_s",
                      "tokens", "good_tokens")
            if summary.get(k) is not None
        }
        self.complete(
            str(summary.get("request_id") or ""),
            trace=summary.get("trace"),
            engine=str(summary.get("engine") or ""),
            klass=str(summary.get("klass") or ""),
            revision=str(summary.get("revision") or ""),
            ok=bool(summary.get("ok", True)),
            phases=phases,
            targets=summary.get("targets"),
        )

    def annotate(self, request_id: str, **fields) -> None:
        """Attach structured extras (the KV-stream chunk timelines) to a
        journey by request id — pre- or post-completion."""
        rid = str(request_id or "")
        if not rid or not enabled():
            return
        with self._lock:
            j = self._kept.get(rid) or self._pending.get(rid)
            if j is None:
                j = self._open_pending_locked(rid)
                if j is None:
                    return
            tracked = self._kept.get(rid) is j
            before = j.records() if tracked else 0
            j.annotations.update(fields)
            if tracked:
                # Kept journeys are budget-tracked: annotation payloads
                # attached after retention adjust the record count.
                delta = j.records() - before
                self._records += delta
                self._bump_source_locked(j, delta)
                self._enforce_budget_locked()

    # ---- completion + retention ------------------------------------------
    def complete(
        self,
        request_id: str,
        trace: Optional[dict] = None,
        engine: str = "",
        klass: str = "",
        revision: str = "",
        ok: bool = True,
        outcome: Optional[str] = None,
        error: Optional[str] = None,
        phases: Optional[dict] = None,
        targets: Optional[dict] = None,
        now: Optional[float] = None,
    ) -> Optional[str]:
        """A request finished in THIS process: join its buffered spans and
        events, grade it, and decide retention. `outcome` forces a verdict
        class for the non-timeline completions (`errored`,
        `deadline_expired`); returns the retention outcome, or None when
        the journey was not kept."""
        if not enabled():
            return None
        tid = (trace or {}).get("trace_id") if isinstance(trace, dict) else None
        rid = str(request_id or "") or (tid or "")
        if not rid:
            with self._lock:
                self._dropped("unidentified")
            return None
        if now is None:
            now = self._clock()
        with self._lock:
            self._sweep_locked(now)
            j = self._pending.pop(rid, None)
            if j is None:
                j = self._kept.get(rid)
                if j is not None:
                    if j.completed and not request_id:
                        # The key was TRACE-derived (engine paths carry no
                        # wire id): a completed journey under it means a
                        # SECOND request finishing on a shared trace, not
                        # an idempotent re-finish — grade it fresh under a
                        # distinct key instead of discarding its verdict.
                        self._trace_seq += 1
                        rid = f"{rid}#{self._trace_seq}"
                        j = None
                    else:
                        del self._kept[rid]
            if j is None:
                j = _Journey(rid)
            if j.completed:
                # Already graded (idempotent finish): re-keep as-is.
                self._kept[rid] = j
                return j.outcome
            if tid:
                j.trace_id = tid
                j.root_span_id = (trace or {}).get("span_id")
                buffered = self._open_traces.pop(tid, None)
                if buffered:
                    room = self.max_spans_per_journey - len(j.spans)
                    j.spans.extend(buffered[:room])
                    if len(buffered) > room:
                        j.spans_dropped += len(buffered) - room
                        self._dropped("journey_span_cap",
                                      len(buffered) - room)
                # Trace-only resilience events buffered while the request
                # was in flight (mid-request retries) join here and raise
                # their must-keep flags before retention is decided.
                for ev in self._open_events.pop(tid, ()):
                    if len(j.events) >= self.max_spans_per_journey:
                        self._dropped("journey_event_cap")
                        break
                    j.events.append(ev)
                    ev_flag = _EVENT_FLAGS.get(ev.get("kind", ""))
                    if ev_flag:
                        j.flags.add(ev_flag)
                self._trace_owner[tid] = j
            j.engine = engine or j.engine
            j.klass = klass or j.klass
            j.revision = revision or j.revision
            if phases:
                j.timeline.update(phases)
            if targets:
                j.timeline["targets"] = dict(targets)
            if error:
                j.timeline["error"] = str(error)[:300]
            if outcome in ("errored",):
                j.flags.add("errored")
            if outcome in ("deadline_expired",):
                j.flags.add("deadline_expired")
            if not ok:
                j.flags.add("breached")
            j.completed = True
            j.completed_unix = time.time()
            j.completed_mono = now
            j.latency_s = max(
                float(j.timeline.get("total_s") or 0.0),
                float(j.timeline.get("ttft_s") or 0.0),
            )
            verdict_outcome = self._decide_locked(j)
            if verdict_outcome is None:
                # Not retained: release the trace claim so the vault holds
                # no reference (late spans re-open a bucket that ages out).
                if tid and self._trace_owner.get(tid) is j:
                    del self._trace_owner[tid]
                self._dropped("not_sampled", max(j.records(), 1))
                return None
            j.outcome = verdict_outcome
            self._kept[rid] = j
            self._records += j.records()
            self._bump_source_locked(j, j.records())
            self._retained(verdict_outcome)
            self._enforce_budget_locked()
            return verdict_outcome

    def _outcome_locked(self, j: _Journey) -> str:  # holds-lock: _lock
        for flag in _FLAG_PRIORITY:
            if flag in j.flags:
                return flag
        return j.outcome if j.outcome not in ("open",) else "sampled"

    def _decide_locked(self, j: _Journey) -> Optional[str]:  # holds-lock: _lock
        """The tail-sampling decision. Must-keep flags win outright; then
        the slowest-K healthy set; then the reservoir roll."""
        for flag in _FLAG_PRIORITY:
            if flag in j.flags:
                return flag
        if self.slowest_k > 0:
            slow = [k for k in self._kept
                    if self._kept[k].outcome == "slowest"]
            if len(slow) < self.slowest_k:
                return "slowest"
            floor_key = min(slow, key=lambda k: self._kept[k].latency_s)
            if j.latency_s > self._kept[floor_key].latency_s:
                evicted = self._kept.pop(floor_key)
                self._records -= evicted.records()
                self._bump_source_locked(evicted, -evicted.records())
                self._release_locked(evicted)
                self._dropped("displaced", max(evicted.records(), 1))
                return "slowest"
        if self._rng() < self.sample_rate:
            return "sampled"
        return None

    def _buffer_event_locked(self, tid: str, event: dict) -> None:  # holds-lock: _lock
        bucket = self._open_events.get(tid)
        if bucket is None:
            while len(self._open_events) >= self.max_open_traces:
                _, evicted = self._open_events.popitem(last=False)
                self._dropped("open_evicted", len(evicted) or 1)
            bucket = self._open_events[tid] = []
        else:
            self._open_events.move_to_end(tid)
        if len(bucket) < self.max_spans_per_journey:
            bucket.append(dict(event))
        else:
            self._dropped("journey_event_cap")

    def _open_pending_locked(self, rid: str) -> Optional[_Journey]:  # holds-lock: _lock
        j = self._pending.get(rid)
        if j is not None:
            self._pending.move_to_end(rid)
            return j
        while len(self._pending) >= self.max_open_traces:
            _, evicted = self._pending.popitem(last=False)
            self._release_locked(evicted)
            self._dropped("open_evicted", max(evicted.records(), 1))
        j = self._pending[rid] = _Journey(rid)
        return j

    def _release_locked(self, j: _Journey) -> None:  # holds-lock: _lock
        if j.trace_id and self._trace_owner.get(j.trace_id) is j:
            del self._trace_owner[j.trace_id]

    def _sweep_locked(self, now: float) -> None:  # holds-lock: _lock
        cutoff = now - self.retention_s
        for rid in [r for r, j in self._kept.items()
                    if j.completed_mono < cutoff]:
            evicted = self._kept.pop(rid)
            self._records -= evicted.records()
            self._bump_source_locked(evicted, -evicted.records())
            self._release_locked(evicted)
            self._dropped("aged", max(evicted.records(), 1))

    def _enforce_budget_locked(self) -> None:  # holds-lock: _lock
        """Evict down to the record budget, cheapest truth first: sampled
        healthy journeys, then the slowest set, and only then — when the
        must-keep class ALONE exceeds the budget — the oldest flagged
        journeys. A healthy-request flood can therefore never evict a
        retained breached journey. The per-source fairness bound is
        enforced after the global one with the same pass order."""
        if self._records > self.budget_records:
            for klass_pass in ("sampled", "slowest", None):
                victims = [
                    rid for rid, j in self._kept.items()
                    if klass_pass is None or j.outcome == klass_pass
                ]
                for rid in victims:
                    if self._records <= self.budget_records:
                        break
                    evicted = self._kept.pop(rid)
                    self._records -= evicted.records()
                    self._bump_source_locked(evicted, -evicted.records())
                    self._release_locked(evicted)
                    self._dropped("budget", max(evicted.records(), 1))
                if self._records <= self.budget_records:
                    break
        self._enforce_source_budget_locked()

    def _enforce_source_budget_locked(self) -> None:  # holds-lock: _lock
        """Per-(klass, revision) fairness: at 1,000 instances × classes ×
        revisions one hot source can stay under the GLOBAL budget while
        monopolising it. Sources over their share evict within-source in
        the same cheapest-truth-first order; losses count under the
        existing drop convention as reason="source_budget"."""
        if self.source_budget_records <= 0:
            return
        over = [key for key, n in self._source_records.items()
                if n > self.source_budget_records]
        for key in over:
            for klass_pass in ("sampled", "slowest", None):
                if (self._source_records.get(key, 0)
                        <= self.source_budget_records):
                    break
                victims = [
                    rid for rid, j in self._kept.items()
                    if self._source_of(j) == key
                    and (klass_pass is None or j.outcome == klass_pass)
                ]
                for rid in victims:
                    if (self._source_records.get(key, 0)
                            <= self.source_budget_records):
                        break
                    evicted = self._kept.pop(rid)
                    self._records -= evicted.records()
                    self._bump_source_locked(evicted, -evicted.records())
                    self._release_locked(evicted)
                    self._dropped("source_budget", max(evicted.records(), 1))

    # ---- views -----------------------------------------------------------
    def get(self, key: str) -> Optional[dict]:
        """A retained journey by REQUEST id or TRACE id (the exemplar
        resolution path) — None when the vault never kept it."""
        with self._lock:
            # Read-time sweep: the age bound must hold on a quiet process
            # too, not only while completions keep arriving.
            self._sweep_locked(self._clock())
            j = self._kept.get(key)
            if j is None or j.trace_id == key:
                # Newest first: several requests may share one trace (a
                # client grafting onto a reconcile root) — an exemplar's
                # trace id should resolve to the most recent of them, even
                # when the oldest one's key IS the trace id (engine paths).
                for cand in reversed(self._kept.values()):
                    if cand.trace_id == key:
                        j = cand
                        break
            if j is None:
                j = self._pending.get(key)
            return j.to_dict() if j is not None else None

    def spans_for_trace(self, trace_id: str) -> list[dict]:
        """Every span this process holds for `trace_id`: a kept journey's
        subtree, or the in-flight open-trace buffer — the local leg the
        fleet join pulls even when no completion ran here (the API-server
        process's client/reconcile spans)."""
        with self._lock:
            owner = self._trace_owner.get(trace_id)
            if owner is not None:
                return list(owner.spans)
            return list(self._open_traces.get(trace_id, ()))

    def index(self, outcome: str = "all", klass: str = "",
              limit: int = 32, revision: str = "") -> list[dict]:
        """Digest rows for `/debug/requests`, worst-first: `slowest` sorts
        by latency, everything else newest-first. `revision` filters to one
        serving revision's journeys (`explain --breached --revision`).
        Unknown outcomes raise ValueError (the debug surfaces answer 400)."""
        if outcome not in OUTCOMES:
            raise ValueError(
                f"outcome must be one of {', '.join(OUTCOMES)}, got {outcome!r}"
            )
        with self._lock:
            self._sweep_locked(self._clock())
            rows = [j for j in self._kept.values() if j.completed]
            if klass:
                rows = [j for j in rows if j.klass == klass]
            if revision:
                rows = [j for j in rows if j.revision == revision]
            if outcome == "slowest":
                rows.sort(key=lambda j: -j.latency_s)
            else:
                if outcome != "all":
                    rows = [j for j in rows
                            if j.outcome == outcome or outcome in j.flags]
                rows.sort(key=lambda j: -j.completed_unix)
            if limit >= 0:
                rows = rows[:limit] if limit else []
            # Digest under the lock: on_event() mutates a kept journey's
            # flags set, and sorted() over a set racing an add() raises.
            return [j.digest() for j in rows]

    def worst(self, limit: int = 8) -> list[dict]:
        """The flight-recorder dump embed: the window's worst journeys —
        every flagged one (newest first), padded with the slowest healthy
        ones."""
        with self._lock:
            self._sweep_locked(self._clock())
            kept = [j for j in self._kept.values() if j.completed]
            flagged = sorted(
                (j for j in kept if j.flags), key=lambda j: -j.completed_unix
            )
            healthy = sorted(
                (j for j in kept if not j.flags), key=lambda j: -j.latency_s
            )
            return [j.digest() for j in (flagged + healthy)[:max(0, limit)]]

    def stats(self) -> dict:
        with self._lock:
            return {
                "kept": len(self._kept),
                "records": self._records,
                "budget_records": self.budget_records,
                "source_budget_records": self.source_budget_records,
                "sources": len(self._source_records),
                "open_traces": len(self._open_traces),
                "pending": len(self._pending),
            }

    def clear(self) -> None:
        with self._lock:
            self._open_traces.clear()
            self._open_events.clear()
            self._trace_owner.clear()
            self._pending.clear()
            self._kept.clear()
            self._records = 0
            self._source_records.clear()


# ---------------------------------------------------------------------------
# Process-default vault + feed wiring.

VAULT = JourneyVault()

_INSTALL_LOCK = threading.Lock()
_INSTALLED = False


def install(vault: Optional[JourneyVault] = None) -> Optional[JourneyVault]:
    """Wire `vault` (default: the process VAULT) onto the process-default
    tracer, flight recorder, and SLO recorder. Idempotent — the worker
    telemetry server calls it at startup; LWS_TPU_JOURNEYS=0 disables the plane entirely
    (listeners never registered: the only residual cost is the empty
    listener-list iteration, covered by the trace-overhead budget)."""
    global _INSTALLED
    if not enabled():
        return None
    target = vault if vault is not None else VAULT
    with _INSTALL_LOCK:
        if _INSTALLED and vault is None:
            return VAULT
        from lws_tpu_torch.core import flightrecorder, slo, trace

        trace.TRACER.add_finish_listener(target.on_span)
        flightrecorder.RECORDER.add_observer(target.on_event)
        if target.on_timeline not in slo.RECORDER.journey_sinks:
            slo.RECORDER.journey_sinks.append(target.on_timeline)
        if vault is None:
            _INSTALLED = True
    return target


def local_journey(key: str, span_limit: int = 512) -> Optional[dict]:
    """The `/debug/request/{id}` body for THIS process: the vault's journey
    (by request OR trace id) first; the bounded span ring second — the ring
    fallback keeps unsampled healthy traffic explainable while it is still
    young, and the vault keeps the tail explainable forever. None when the
    process knows nothing about the id."""
    from lws_tpu_torch.core import trace

    journey = VAULT.get(key)
    if journey is not None:
        journey["source"] = "vault"
        return journey
    # Open, uncompleted trace buffers (a request still in flight).
    spans = VAULT.spans_for_trace(key)
    if spans:
        return {"id": key, "trace_id": key, "outcome": "open",
                "completed": False, "flags": [], "timeline": {},
                "events": [], "annotations": {}, "spans": spans,
                "source": "vault"}
    ring = [
        s for s in trace.TRACER.spans(span_limit)
        if s.get("trace_id") == key
        or (s.get("attrs") or {}).get("request_id") == key
    ]
    if ring:
        tid = ring[0].get("trace_id")
        return {"id": key, "trace_id": tid, "outcome": "open",
                "completed": False, "flags": [], "timeline": {},
                "events": [], "annotations": {}, "spans": ring,
                "source": "ring"}
    return None
