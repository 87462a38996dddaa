"""Per-request SLO telemetry: the port's copy of lws_tpu/core/slo.py, the
request-lifecycle recorder the serving engines thread their timings through.

Serving a fleet is managed against latency DISTRIBUTIONS, not single-process
averages (PAPERS.md, "Fine-Tuning and Serving Gemma on Cloud TPU"): the
operator question is "what fraction of requests met the targets", asked per
engine, per WORKLOAD CLASS, and per worker, aggregated by /metrics/fleet.
Three histograms, one gauge, and a token ledger carry it:

  * `serving_queue_wait_seconds{engine,klass}` — arrival -> admission;
  * `serving_ttft_seconds{engine,klass}`      — arrival -> first token;
  * `serving_itl_seconds{engine,klass}`       — inter-token latency, observed
    once per decode dispatch as the mean step gap of that chunk (a per-token
    observation would tax exactly the hot loop the <2% trace budget
    protects);
  * `serving_slo_attainment{engine,klass}`    — fraction of the trailing
    request window (default 256 requests, AGE-BOUND — see below) that met
    EVERY target;
  * `serving_tokens_total{engine,klass}` / `serving_goodput_tokens_total`
    — the GOODPUT ledger: every delivered token vs only the tokens
    delivered within their deadline (arrival + ttft target + (i-1) x itl
    target for the i-th token — `token_deadline_s`). Raw throughput counts
    "fast but late" work as success; the goodput fraction is what the
    loadgen harness (loadgen/) and the autoscaler steer on.

The `klass` label is the request's workload/QoS class (tenant tier, traffic
class — threaded through every engine's submit path). Requests without a class omit the label entirely, so single-class
deployments keep the exact pre-class series identity.

STALENESS: the attainment window is age-bound (`LWS_TPU_SLO_WINDOW_AGE_S`,
default 600s). A trailing request-count window alone never decays — an
engine that went quiet would advertise its last attainment forever, and
`lws-tpu top` (or an autoscaler) would act on fiction. Entries past the age
bound are evicted at finish/read time, and `refresh()` — called by the
/metrics surfaces per scrape — re-publishes the gauges, retires attainment
series whose windows emptied, and reports the window's age in
`serving_slo_window_age_seconds` so consumers can discount what remains.

Every histogram observation carries the active trace/span context as an
OpenMetrics exemplar, so a breach bucket in a scrape resolves directly to
its request tree in `/debug/traces`.

Targets come from `SLOTargets` (env-overridable: LWS_TPU_SLO_TTFT_S,
LWS_TPU_SLO_ITL_S, LWS_TPU_SLO_QUEUE_S) with per-class overrides from
`LWS_TPU_SLO_CLASS_TARGETS` (JSON: `{"premium": {"ttft_s": 0.5}}`) or a
loadgen scenario spec via `set_class_targets`. The module-level RECORDER is
the process default, like metrics.REGISTRY and trace.TRACER (the port's,
not the JAX package's).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from lws_tpu_torch.core import metrics, trace
from lws_tpu_torch.utils.common import env_float as _env_float

# The serving template revision this worker process runs (injected into the
# pod env from the pod's revision labels). When set, every SLO series this
# process emits carries a `revision` label.
REVISION_ENV = "LWS_TPU_REVISION"


@dataclass(frozen=True)
class SLOTargets:
    """Per-request latency targets. A request attains its SLO when every
    recorded phase met its target (phases never recorded don't count
    against it — a dense generate() has no queue)."""

    ttft_s: float = 1.0
    itl_s: float = 0.1
    queue_wait_s: float = 0.5

    @classmethod
    def from_env(cls) -> "SLOTargets":
        return cls(
            ttft_s=_env_float("LWS_TPU_SLO_TTFT_S", cls.ttft_s),
            itl_s=_env_float("LWS_TPU_SLO_ITL_S", cls.itl_s),
            queue_wait_s=_env_float("LWS_TPU_SLO_QUEUE_S", cls.queue_wait_s),
        )

    def overridden(self, spec: dict) -> "SLOTargets":
        """These targets with `spec`'s fields replacing their defaults —
        the per-class override shape (scenario spec / env JSON). Unknown
        keys raise: a typoed `ttft` silently keeping the default would
        misgrade every request of that class."""
        known = {f.name for f in dataclasses.fields(self)}
        bad = set(spec) - known
        if bad:
            raise ValueError(f"unknown SLO target field(s): {sorted(bad)}")
        return dataclasses.replace(self, **{k: float(v) for k, v in spec.items()})


def class_targets_from_env(base: SLOTargets) -> dict[str, SLOTargets]:
    """`LWS_TPU_SLO_CLASS_TARGETS={"premium":{"ttft_s":0.5},...}` -> per-
    class targets over `base`. A malformed value raises at recorder build
    time (boot), not at request time."""
    raw = os.environ.get("LWS_TPU_SLO_CLASS_TARGETS", "")
    if not raw.strip():
        return {}
    try:
        data = json.loads(raw)
        if not isinstance(data, dict):
            raise ValueError("expected a JSON object of class -> targets")
        return {str(k): base.overridden(dict(v)) for k, v in data.items()}
    except (ValueError, TypeError) as e:
        raise ValueError(f"bad LWS_TPU_SLO_CLASS_TARGETS: {e}") from None


def token_deadline_s(targets: SLOTargets, cum_tokens: int) -> float:
    """Delivery deadline (seconds from arrival) for the `cum_tokens`-th
    token of a request: first token by the TTFT target, each later token
    one ITL target after its predecessor. The goodput ledger counts a token
    only when it landed by this bound — shared by the in-engine timeline
    accounting and the loadgen runner's client-side verdicts so the two
    ledgers agree on what "on time" means."""
    return targets.ttft_s + max(0, cum_tokens - 1) * targets.itl_s


def _labels(engine: str, klass: str, revision: str = "") -> dict[str, str]:
    """Label set for one timeline's series: the `klass` label rides only
    when a class was assigned — class-free deployments keep the exact
    pre-class series identity (and tests their label-set lookups). The
    `revision` label rides the same way: only when the process knows its
    serving revision (LWS_TPU_REVISION)."""
    out = {"engine": engine}
    if klass:
        out["klass"] = klass
    if revision:
        out["revision"] = revision
    return out


class RequestTimeline:
    """One request's lifecycle clock. Engines create it at arrival (submit /
    generate entry), mark admission and first token, feed decode chunks, and
    finish it on completion. All marks are idempotent-safe in the sense that
    the attainment verdict folds whatever was recorded by finish() time."""

    __slots__ = (
        "engine", "klass", "request_id", "_rec", "_arrival", "_ttft_s",
        "_queue_wait_s", "_worst_itl_s", "_last_token_t", "_finished",
        "_cursor_s", "_tokens_total", "_good_tokens",
    )

    def __init__(self, recorder: "SLORecorder", engine: str,
                 arrival_t: Optional[float] = None, klass: str = "",
                 request_id: str = "") -> None:
        self.engine = engine
        self.klass = klass
        # The cross-process request id (disagg frame meta `id`): the key
        # the journey vault files this timeline's verdict under. Engines
        # without one leave it empty — the journey falls back to trace id.
        self.request_id = request_id
        self._rec = recorder
        self._arrival = time.perf_counter() if arrival_t is None else arrival_t
        self._ttft_s: Optional[float] = None
        self._queue_wait_s: Optional[float] = None
        self._worst_itl_s: Optional[float] = None
        self._last_token_t: Optional[float] = None
        self._finished = False
        # Goodput ledger state: arrival-relative delivery clock (explicit
        # marks accumulate here, so injected timings stay deterministic)
        # and the delivered / on-time token counts folded at finish().
        self._cursor_s = 0.0
        self._tokens_total = 0
        self._good_tokens = 0

    # ---- lifecycle marks -------------------------------------------------
    def queue_wait(self, seconds: Optional[float] = None) -> None:
        """Arrival -> admission. Without an explicit value, measures from
        the timeline's own arrival clock."""
        if seconds is None:
            seconds = time.perf_counter() - self._arrival
        self._queue_wait_s = max(0.0, seconds)
        self._rec._observe(
            "serving_queue_wait_seconds", self._labels_(), self._queue_wait_s
        )

    def first_token(self, ttft_s: Optional[float] = None) -> None:
        if ttft_s is None:
            ttft_s = time.perf_counter() - self._arrival
        self._ttft_s = max(0.0, ttft_s)
        self._last_token_t = time.perf_counter()
        self._cursor_s = self._ttft_s
        self._tokens_total += 1
        if self._ttft_s <= self._rec.targets_for(self.klass).ttft_s:
            self._good_tokens += 1
        self._rec._observe("serving_ttft_seconds", self._labels_(), self._ttft_s)

    def tokens(self, n: int, elapsed_s: Optional[float] = None) -> None:
        """A decode chunk of `n` tokens landed. `elapsed_s` defaults to the
        gap since the previous chunk (or first token) on this timeline; the
        ITL sample is the chunk's mean step gap — one histogram observation
        per dispatch, never per token. The chunk also feeds the goodput
        ledger: its tokens count as goodput only when the chunk landed by
        the LAST token's cumulative deadline (chunk granularity — the same
        per-dispatch discipline as the ITL observation)."""
        if n <= 0:
            return
        now = time.perf_counter()
        if elapsed_s is None:
            since = self._last_token_t if self._last_token_t is not None else self._arrival
            elapsed_s = now - since
        self._last_token_t = now
        itl = max(0.0, elapsed_s) / n
        if self._worst_itl_s is None or itl > self._worst_itl_s:
            self._worst_itl_s = itl
        self._cursor_s += max(0.0, elapsed_s)
        self._tokens_total += n
        targets = self._rec.targets_for(self.klass)
        if self._cursor_s <= token_deadline_s(targets, self._tokens_total):
            self._good_tokens += n
        self._rec._observe("serving_itl_seconds", self._labels_(), itl)

    def finish(self) -> bool:
        """Fold the recorded phases into the attainment window and the
        goodput ledger; returns the verdict. Safe to call more than once
        (later calls are no-ops)."""
        if self._finished:
            return True
        self._finished = True
        return self._rec._finish(self)

    # ---- verdict ---------------------------------------------------------
    def _labels_(self) -> dict[str, str]:
        return _labels(self.engine, self.klass, self._rec.revision)

    def attained(self, targets: SLOTargets) -> bool:
        if self._queue_wait_s is not None and self._queue_wait_s > targets.queue_wait_s:
            return False
        if self._ttft_s is not None and self._ttft_s > targets.ttft_s:
            return False
        if self._worst_itl_s is not None and self._worst_itl_s > targets.itl_s:
            return False
        return True


class SLORecorder:
    def __init__(
        self,
        targets: Optional[SLOTargets] = None,
        registry=None,
        window: int = 256,
        max_age_s: Optional[float] = None,
        class_targets: Optional[dict[str, SLOTargets]] = None,
        revision: Optional[str] = None,
    ) -> None:
        """`registry` defaults to the process metrics helpers; `window` is
        the trailing request count the attainment gauge averages over (a
        cumulative ratio would never recover from one bad hour) and
        `max_age_s` its AGE bound (entries older than this are evicted, so
        a quiet engine stops advertising stale attainment; env
        LWS_TPU_SLO_WINDOW_AGE_S, default 600s). `class_targets` overrides
        targets per workload class (default: LWS_TPU_SLO_CLASS_TARGETS).
        `revision` stamps every series with the serving template revision
        (default: LWS_TPU_REVISION; empty keeps the pre-revision series
        identity)."""
        self.targets = targets if targets is not None else SLOTargets.from_env()
        self.revision = (
            revision if revision is not None
            else os.environ.get(REVISION_ENV, "")
        )
        self._registry = registry
        self._window = window
        self._max_age_s = (
            max_age_s if max_age_s is not None
            else _env_float("LWS_TPU_SLO_WINDOW_AGE_S", 600.0)
        )
        # (engine, klass) -> deque[(monotonic_t, ok)]
        self._outcomes: dict[tuple[str, str], deque] = {}  # guarded-by: _lock
        self._class_targets: dict[str, SLOTargets] = (  # guarded-by: _lock
            dict(class_targets) if class_targets is not None
            else class_targets_from_env(self.targets)
        )
        self._lock = threading.Lock()
        # Journey sinks: called with each finished timeline's summary
        # (phases + verdict + targets) — the journey vault's completion
        # feed (obs/journey.py install()). Per-instance, so tests' private
        # recorders never leak into the process vault.
        self.journey_sinks: list = []
    def request(self, engine: str, arrival_t: Optional[float] = None,
                klass: str = "", request_id: str = "") -> RequestTimeline:
        return RequestTimeline(self, engine, arrival_t, klass=klass,
                               request_id=request_id)

    def targets_for(self, klass: str) -> SLOTargets:
        """The effective targets for one workload class (the engine-wide
        targets unless the class carries an override)."""
        if not klass:
            return self.targets
        with self._lock:
            return self._class_targets.get(klass, self.targets)

    def set_class_targets(self, mapping: dict[str, SLOTargets]) -> None:
        """Install per-class target overrides (the loadgen scenario-spec
        path; replaces any env-derived set wholesale so a scenario run is
        self-describing)."""
        with self._lock:
            self._class_targets = dict(mapping)

    def attainment(self, engine: str, klass: str = "",
                   now: Optional[float] = None) -> Optional[float]:
        if now is None:
            now = time.monotonic()
        with self._lock:
            window = self._outcomes.get((engine, klass))
            if window is not None:
                self._evict_locked(window, now)
            if not window:
                return None
            return sum(ok for _, ok in window) / len(window)

    def refresh(self, now: Optional[float] = None) -> None:
        """Re-publish every attainment gauge against the age bound — the
        /metrics surfaces call this per scrape. Windows that emptied retire
        their gauge series (a scraper sees the series DISAPPEAR, not
        freeze); surviving windows also publish their age in
        `serving_slo_window_age_seconds` so consumers can discount a
        window that stopped filling."""
        if now is None:
            now = time.monotonic()
        reg = self._registry if self._registry is not None else metrics.REGISTRY
        with self._lock:
            for (engine, klass), window in list(self._outcomes.items()):
                self._evict_locked(window, now)
                labels = _labels(engine, klass, self.revision)
                if not window:
                    del self._outcomes[(engine, klass)]
                    # exact: retiring the class-free {engine} series must
                    # not take every live {engine, klass} sibling with it
                    # (clear_gauge's default subset match would).
                    reg.clear_gauge("serving_slo_attainment", labels, exact=True)
                    reg.clear_gauge("serving_slo_window_age_seconds", labels,
                                    exact=True)
                    continue
                value = sum(ok for _, ok in window) / len(window)
                reg.set("serving_slo_attainment", value, labels)
                reg.set(
                    "serving_slo_window_age_seconds",
                    max(0.0, now - window[-1][0]), labels,
                )

    # ---- plumbing --------------------------------------------------------
    def _evict_locked(self, window: deque, now: float) -> None:  # holds-lock: _lock
        cutoff = now - self._max_age_s
        while window and window[0][0] < cutoff:
            window.popleft()

    def _observe(self, name: str, labels: dict[str, str], value: float) -> None:
        ctx = trace.current_context()
        if self._registry is not None:
            self._registry.observe(name, value, labels, exemplar=ctx)
        else:
            metrics.observe(name, value, labels, exemplar=ctx)

    def _inc(self, name: str, labels: dict[str, str], value: float) -> None:
        if self._registry is not None:
            self._registry.inc(name, labels, value)
        else:
            metrics.inc(name, labels, value)

    def _finish(self, tl: RequestTimeline) -> bool:
        now = time.monotonic()
        targets = self.targets_for(tl.klass)
        ok = tl.attained(targets)
        key = (tl.engine, tl.klass)
        with self._lock:
            window = self._outcomes.get(key)
            if window is None:
                window = self._outcomes[key] = deque(maxlen=self._window)
            window.append((now, 1.0 if ok else 0.0))
            self._evict_locked(window, now)
            value = sum(o for _, o in window) / len(window)
        labels = _labels(tl.engine, tl.klass, self.revision)
        reg = self._registry if self._registry is not None else metrics.REGISTRY
        reg.set("serving_slo_attainment", value, labels)
        reg.set("serving_slo_window_age_seconds", 0.0, labels)
        # Goodput ledger: delivered vs delivered-on-time, folded once per
        # request (a per-chunk inc would tax the decode hot loop for a
        # counter nobody rates within one request).
        if tl._tokens_total > 0:
            self._inc("serving_tokens_total", labels, float(tl._tokens_total))
            if tl._good_tokens > 0:
                self._inc(
                    "serving_goodput_tokens_total", labels,
                    float(tl._good_tokens),
                )
        # Journey completion feed: the vault joins this verdict with the
        # request's buffered span subtree and resilience events, then
        # decides tail-sampled retention. Captured HERE (finish runs inside
        # the request's span on the disagg legs) so the trace ctx is live.
        if self.journey_sinks:
            summary = {
                "engine": tl.engine,
                "klass": tl.klass,
                "revision": self.revision,
                "request_id": tl.request_id,
                "trace": trace.current_context(),
                "queue_wait_s": tl._queue_wait_s,
                "ttft_s": tl._ttft_s,
                "worst_itl_s": tl._worst_itl_s,
                "total_s": tl._cursor_s if tl._tokens_total else None,
                "tokens": tl._tokens_total,
                "good_tokens": tl._good_tokens,
                "ok": ok,
                "targets": dataclasses.asdict(targets),
            }
            for sink in self.journey_sinks:
                try:
                    sink(summary)
                except Exception:  # noqa: BLE001 — a broken journey sink must never fail a request's SLO accounting
                    pass
        return ok


# Process-default recorder: the serving engines report here, exactly like
# the process-global metrics.REGISTRY and trace.TRACER.
RECORDER = SLORecorder()


def request(engine: str, arrival_t: Optional[float] = None,
            klass: str = "", request_id: str = "") -> RequestTimeline:
    return RECORDER.request(engine, arrival_t, klass=klass,
                            request_id=request_id)
