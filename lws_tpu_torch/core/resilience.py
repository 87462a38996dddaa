"""Serving-plane resilience for the port's KV wire and disaggregated
workers: the port's copy of lws_tpu/core/resilience.py.

  * `Deadline`: a request's remaining time budget. It rides the KV frame
    meta as `deadline_s` (remaining seconds, re-anchored on the receiver's
    clock), so its semantics are part of the wire protocol and equal the
    JAX package's exactly. `bind`/`current`/`check`/`clamp_timeout` give a
    thread its bound deadline at every blocking point; `expire` records an
    expiration without raising (the workers' drop paths).
  * `call(fn, site, policy, budget)`: retry with decorrelated-jitter
    backoff, deadline-aware, optionally spending a `RetryBudget` so a
    brownout cannot multiply into a retry storm. Every event lands in
    `serving_retries_total{site,outcome}`.
  * `CircuitBreaker`: per-endpoint closed/open/half-open, with gauge,
    counter, flight-recorder event and `breaker:{endpoint}` heartbeat on
    every transition.
  * `DrainGate` (`DRAIN`): graceful worker drain on SIGTERM.
  * `SeenIds`: the bounded seen-id guard that makes at-least-once KV
    delivery safe to replay; each replay it absorbs bumps
    `serving_replays_deduped_total{site}`.

Every mechanism has a kill switch for mutation-proofing the chaos suite:
`LWS_TPU_RESILIENCE_DISABLE=deadline,retry,breaker,drain,dedup` turns the
named mechanisms into no-ops (read per call).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from lws_tpu_torch.core import flightrecorder, metrics

DISABLE_ENV = "LWS_TPU_RESILIENCE_DISABLE"
MECHANISMS = ("deadline", "retry", "breaker", "drain", "dedup")


def csv_disabled(env_var: str, name: str) -> bool:
    """The shared kill-switch predicate: `name` appears in the comma list
    held by `env_var`. Read per call (never cached) so the mutation-proof
    suites can flip switches between scenarios to prove each mechanism is
    load-bearing. The actuation planes (obs/decisions.py,
    LWS_TPU_ACTUATION_DISABLE) share this exact contract."""
    raw = os.environ.get(env_var, "")
    if not raw:
        return False
    return name in {part.strip() for part in raw.split(",")}


def disabled(mechanism: str) -> bool:
    return csv_disabled(DISABLE_ENV, mechanism)


# ---------------------------------------------------------------------------
# Deadlines


class DeadlineExceeded(RuntimeError):
    def __init__(self, site: str, overdue_s: float) -> None:
        super().__init__(f"deadline exceeded at {site} ({overdue_s:.3f}s overdue)")
        self.site = site
        self.overdue_s = overdue_s


def expire(site: str, request_id: str = "") -> None:
    """Record a deadline expiration (metric + trip heartbeat + ring event)
    WITHOUT raising — the drop-don't-crash paths (prefill skipping an
    expired prompt) record the same way the raising paths do. `request_id`
    (when the site knows it — the worker admit paths do) joins the event
    to its journey in the vault."""
    metrics.inc("serving_deadline_expirations_total", {"site": site})
    # TripRule feed: progress auto-increments, so the watchdog sees a
    # recent advance and alerts once per burst.
    flightrecorder.beat(f"deadline_trips:{site}")
    if request_id:
        flightrecorder.record("deadline_exceeded", site=site,
                              request_id=request_id)
    else:
        flightrecorder.record("deadline_exceeded", site=site)


class Deadline:
    """Absolute time budget on an injectable clock. `clock` exists for
    deterministic tests; production uses time.monotonic."""

    __slots__ = ("deadline_at", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self.deadline_at = clock() + float(budget_s)

    def remaining(self) -> float:
        return self.deadline_at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, site: str) -> None:
        """The blocking-point gate: raise DeadlineExceeded (and record the
        trip) when the budget is gone. No-op when the mechanism is
        disabled (fail open: behave like the pre-deadline stack)."""
        if disabled("deadline"):
            return
        overdue = -self.remaining()
        if overdue >= 0.0:
            expire(site)
            raise DeadlineExceeded(site, overdue)

    def timeout(self, cap_s: float) -> float:
        """Clamp a socket/poll timeout to the remaining budget: a blocking
        wait must never outlive the request it serves."""
        if disabled("deadline"):
            return cap_s
        return max(0.001, min(cap_s, self.remaining()))

    # ---- wire propagation (rides KV frame meta like trace ctx) -----------
    def to_wire(self) -> float:
        """REMAINING seconds, not an absolute stamp: peers re-anchor on
        their own clock, so skewed wall clocks across hosts cannot forge
        or destroy budget."""
        return round(max(0.0, self.remaining()), 6)

    @staticmethod
    def from_wire(value, clock: Callable[[], float] = time.monotonic
                  ) -> Optional["Deadline"]:
        if value is None:
            return None
        try:
            return Deadline(float(value), clock=clock)
        except (TypeError, ValueError):
            return None


# Thread-local deadline binding, mirroring trace's span stack: the KV
# client helpers pick up the caller's deadline without plumbing a
# parameter through every call shape.
_TLS = threading.local()


class bind:
    """Context manager pushing a deadline onto this thread's stack.
    `bind(None)` is a no-op frame (callers can bind unconditionally)."""

    def __init__(self, deadline: Optional[Deadline]) -> None:
        self._deadline = deadline

    def __enter__(self) -> Optional[Deadline]:
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self._deadline)
        return self._deadline

    def __exit__(self, *exc) -> bool:
        _TLS.stack.pop()
        return False


def current() -> Optional[Deadline]:
    stack = getattr(_TLS, "stack", None)
    for deadline in reversed(stack or []):
        if deadline is not None:
            return deadline
    return None


def check(site: str) -> None:
    """Check the bound deadline (if any) at a blocking point."""
    deadline = current()
    if deadline is not None:
        deadline.check(site)


def clamp_timeout(cap_s: float) -> float:
    deadline = current()
    if deadline is None:
        return cap_s
    return deadline.timeout(cap_s)


# ---------------------------------------------------------------------------
# Retry with decorrelated jitter + budget


@dataclass(frozen=True)
class RetryPolicy:
    """`retry_on` must be exception TYPES the caller considers transient;
    anything else propagates immediately (a poison request is not a
    network blip)."""

    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    retry_on: tuple = (OSError,)


class RetryBudget:
    """Token bucket damping retry storms: each retry spends one token,
    each clean first-attempt success earns `earn` back (capped). When the
    bucket is dry the failure propagates immediately — a brownout where
    every caller retries at full fan-out is how partial outages go total."""

    def __init__(self, capacity: float = 10.0, earn: float = 0.5) -> None:
        self._lock = threading.Lock()
        self._capacity = capacity
        self._earn = earn
        self._tokens = capacity  # guarded-by: _lock

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    def record_success(self) -> None:
        with self._lock:
            self._tokens = min(self._capacity, self._tokens + self._earn)

    def remaining(self) -> float:
        with self._lock:
            return self._tokens


def call(
    fn: Callable,
    site: str,
    policy: Optional[RetryPolicy] = None,
    budget: Optional[RetryBudget] = None,
    deadline: Optional[Deadline] = None,
    sleeper: Callable[[float], None] = time.sleep,
    rng=None,
):
    """Run `fn()` under the retry policy. `deadline` defaults to the
    thread-bound one; `sleeper`/`rng` are injectable so chaos tests run
    with zero wall-clock sleeps and deterministic jitter."""
    policy = policy if policy is not None else RetryPolicy()
    if deadline is None:
        deadline = current()
    uniform = rng.uniform if rng is not None else random.uniform
    attempts = 1 if disabled("retry") else max(1, policy.max_attempts)
    prev_sleep = policy.base_s
    for attempt in range(1, attempts + 1):
        if deadline is not None:
            deadline.check(site)
        try:
            result = fn()
        except policy.retry_on:
            if attempt >= attempts:
                metrics.inc("serving_retries_total",
                            {"site": site, "outcome": "exhausted"})
                raise
            if budget is not None and not budget.try_spend():
                metrics.inc("serving_retries_total",
                            {"site": site, "outcome": "budget_exhausted"})
                raise
            metrics.inc("serving_retries_total",
                        {"site": site, "outcome": "retry"})
            # Retries are notable, not hot (a retrying site is already
            # paying a backoff sleep): the ring event carries the active
            # trace ctx so the journey vault can pin the retry leg to the
            # request it delayed.
            flightrecorder.record("retry", site=site, attempt=attempt)
            # Decorrelated jitter: spreads a thundering herd of retriers
            # instead of synchronizing them onto the recovering peer.
            sleep_s = min(policy.cap_s, uniform(policy.base_s, prev_sleep * 3))
            prev_sleep = sleep_s
            if deadline is not None and not disabled("deadline"):
                sleep_s = min(sleep_s, max(0.0, deadline.remaining()))
            if sleep_s > 0:
                sleeper(sleep_s)
            continue
        if attempt > 1:
            metrics.inc("serving_retries_total",
                        {"site": site, "outcome": "recovered"})
        elif budget is not None:
            budget.record_success()
        return result


# ---------------------------------------------------------------------------
# Circuit breaker

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitOpenError(RuntimeError):
    pass


class CircuitBreaker:
    """Per-endpoint circuit: `failure_threshold` consecutive failures open
    it; after `reset_timeout_s` ONE half-open probe is allowed — success
    closes, failure re-opens. `clock` is injectable for deterministic
    tests. Wrap calls as:

        if not breaker.allow():
            ...fail fast / back off...
        try:    result = dial()
        except OSError: breaker.record_failure(); raise
        else:   breaker.record_success()
    """

    def __init__(
        self,
        endpoint: str,
        failure_threshold: int = 5,
        reset_timeout_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.endpoint = endpoint
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED       # guarded-by: _lock
        self._failures = 0         # guarded-by: _lock
        self._opened_at = 0.0      # guarded-by: _lock
        self._probe_inflight = False  # guarded-by: _lock
        self._probe_started_at = 0.0  # guarded-by: _lock
        # Publish the gauge at construction: a breaker that never trips is
        # still visible (state 0) on the fleet surface.
        metrics.set("serving_circuit_state", _STATE_CODE[CLOSED],
                    {"endpoint": endpoint})

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now? Open circuits fail fast until the
        reset timeout, then admit exactly one half-open probe."""
        if disabled("breaker"):
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._transition(HALF_OPEN)
                    self._probe_inflight = True
                    self._probe_started_at = self._clock()
                    return True
                return False
            # HALF_OPEN: one probe at a time — but a probe whose caller
            # never reported back (died, or raised something outside its
            # retry_on set) must not wedge the circuit here forever: past
            # one reset window the probe slot reopens.
            if not self._probe_inflight or (
                self._clock() - self._probe_started_at >= self.reset_timeout_s
            ):
                self._probe_inflight = True
                self._probe_started_at = self._clock()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._probe_inflight = False
            self._failures = 0
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        if disabled("breaker"):
            return
        with self._lock:
            self._probe_inflight = False
            self._failures += 1
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                if self._state != OPEN:
                    self._transition(OPEN)

    def call(self, fn: Callable, retry_on: tuple = (OSError,)):
        """Convenience wrapper: fail fast with CircuitOpenError when open,
        otherwise run `fn` and record the outcome."""
        if not self.allow():
            raise CircuitOpenError(f"circuit open for {self.endpoint}")
        try:
            result = fn()
        except retry_on:
            self.record_failure()
            raise
        except BaseException:
            # Not a transport verdict (poison input, cancellation): the
            # circuit learns nothing, but the probe slot must be released
            # or a half-open circuit wedges on a probe that never reported.
            with self._lock:
                self._probe_inflight = False
            raise
        self.record_success()
        return result

    def retire(self) -> None:
        """Tear down this breaker's observable footprint (gauge series +
        watchdog heartbeat) when its endpoint is evicted from a bounded
        registry — an evicted-while-open breaker must not leave the
        `circuit_open` alert latched on an endpoint that no longer exists."""
        metrics.REGISTRY.clear_gauge("serving_circuit_state",
                                     {"endpoint": self.endpoint})
        flightrecorder.beat(f"breaker:{self.endpoint}", progress=0.0,
                            depth=0.0)

    def _transition(self, to: str) -> None:  # holds-lock: _lock
        frm, self._state = self._state, to
        metrics.inc("serving_circuit_transitions_total",
                    {"endpoint": self.endpoint, "state": to})
        metrics.set("serving_circuit_state", _STATE_CODE[to],
                    {"endpoint": self.endpoint})
        flightrecorder.record(
            "circuit_breaker", endpoint=self.endpoint, from_state=frm,
            to_state=to,
        )
        # Watchdog feed (`circuit_open` rule): depth 1 while open, 0
        # otherwise; progress pinned so BacklogRule's sustain clock runs.
        flightrecorder.beat(f"breaker:{self.endpoint}", progress=0.0,
                            depth=1.0 if to == OPEN else 0.0)


# ---------------------------------------------------------------------------
# Graceful drain


class DrainGate:
    """Process-wide drain latch. `request()` flips it (idempotent); worker
    loops poll `draining` between work items: admit nothing new, finish
    what's in flight, leave queued work for a successor, exit clean.
    Unacked KV bundles re-queue server-side by the at-least-once protocol,
    so a drained decode worker loses nothing."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self.reason: Optional[str] = None

    @property
    def draining(self) -> bool:
        if disabled("drain"):
            return False
        return self._event.is_set()

    def request(self, reason: str = "requested") -> bool:
        """Returns True when the drain was accepted (False = mechanism
        disabled; the caller keeps serving)."""
        if disabled("drain"):
            flightrecorder.record("drain_ignored", reason=reason)
            return False
        first = not self._event.is_set()
        self.reason = reason
        self._event.set()
        if first:
            metrics.set("serving_draining", 1.0)
            flightrecorder.record("drain_requested", reason=reason)
        return True

    def reset(self) -> None:
        """Re-arm after a completed drain (tests; a real worker exits)."""
        self._event.clear()
        self.reason = None
        metrics.set("serving_draining", 0.0)

    def install_signal_handler(self) -> None:
        """SIGTERM -> drain (the kubelet's stop signal; the pod grace
        period is the drain window). Main thread only — signal.signal
        raises elsewhere, and workers install from their entrypoint."""
        import signal

        signal.signal(
            signal.SIGTERM, lambda signum, frame: self.request("sigterm")
        )


DRAIN = DrainGate()


# ---------------------------------------------------------------------------
# Replay dedup


class SeenIds:
    """Bounded seen-id set for at-least-once consumers: `seen(id)` returns
    True for a replay (and counts it), False the first time (and records
    the id, evicting the oldest past `capacity`). The bound matters: an
    unbounded set on a long-lived decode worker is a slow leak."""

    def __init__(self, capacity: int = 1024, site: str = "decode") -> None:
        self._lock = threading.Lock()
        self._capacity = max(1, int(capacity))
        self._site = site
        self._order: "deque[str]" = deque()  # guarded-by: _lock
        self._ids: set = set()               # guarded-by: _lock

    def seen(self, rid: str) -> bool:
        """Atomic check-and-record: True for a replay, else records `rid`.
        For consumers whose side effects (result posting) can FAIL between
        delivery and completion, use the two-phase `contains()` at entry +
        `record()` after the side effect — recording up front would let a
        failed first attempt turn the redelivery into an ack-with-no-
        result (the request silently lost)."""
        if disabled("dedup"):
            return False
        with self._lock:
            if rid in self._ids:
                replay = True
            else:
                replay = False
                self._record_locked(rid)
        if replay:
            self._replayed(rid)
        return replay

    def contains(self, rid: str) -> bool:
        """Read-only replay check (counts the dedup when it hits)."""
        if disabled("dedup"):
            return False
        with self._lock:
            replay = rid in self._ids
        if replay:
            self._replayed(rid)
        return replay

    def _replayed(self, rid: str) -> None:
        metrics.inc("serving_replays_deduped_total", {"site": self._site})
        # Replays are rare and notable (an ack was lost somewhere): the
        # ring event carries the id so the journey vault flags the leg.
        flightrecorder.record("replay_deduped", site=self._site,
                              request_id=rid)

    def record(self, rid: str) -> None:
        """Mark `rid` complete — call AFTER its side effects succeeded."""
        if disabled("dedup"):
            return
        with self._lock:
            if rid not in self._ids:
                self._record_locked(rid)

    def _record_locked(self, rid: str) -> None:  # holds-lock: _lock
        self._ids.add(rid)
        self._order.append(rid)
        while len(self._order) > self._capacity:
            self._ids.discard(self._order.popleft())

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)
