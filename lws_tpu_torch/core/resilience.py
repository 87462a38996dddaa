"""Serving-plane resilience for the port's KV wire and disaggregated
workers: the port's copy of lws_tpu/core/resilience.py, trimmed to what
`serving/kv_transport.py` and `serving/disagg_worker.py` call, without the
flight-recorder and metrics hooks (they come with the telemetry slice).

  * `Deadline`: a request's remaining time budget. It rides the KV frame
    meta as `deadline_s` (remaining seconds, re-anchored on the receiver's
    clock), so its semantics are part of the wire protocol and equal the
    JAX package's exactly. `bind`/`current`/`check`/`clamp_timeout` give a
    thread its bound deadline at every blocking point.
  * `call(fn, site, policy)`: retry with decorrelated-jitter backoff,
    deadline-aware.
  * `CircuitBreaker`: per-endpoint closed/open/half-open.
  * `DrainGate` (`DRAIN`): graceful worker drain on SIGTERM.
  * `SeenIds`: the bounded seen-id guard that makes at-least-once KV
    delivery safe to replay.

Left out with the telemetry and chaos slices: the JAX package's `expire`
(it only records an expiration), the `LWS_TPU_RESILIENCE_DISABLE` kill
switch (it exists for the chaos suite's mutation proofs) and `RetryBudget`
(no caller in the port).
"""

from __future__ import annotations

import collections
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

# ---------------------------------------------------------------------------
# Deadlines


class DeadlineExceeded(RuntimeError):
    def __init__(self, site: str, overdue_s: float) -> None:
        super().__init__(f"deadline exceeded at {site} ({overdue_s:.3f}s overdue)")
        self.site = site
        self.overdue_s = overdue_s


class Deadline:
    """Absolute time budget on an injectable clock (`clock` exists for
    deterministic tests; production uses time.monotonic)."""

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
        """The blocking-point gate: raise DeadlineExceeded when the budget
        is gone."""
        overdue = -self.remaining()
        if overdue >= 0.0:
            raise DeadlineExceeded(site, overdue)

    def timeout(self, cap_s: float) -> float:
        """Clamp a socket or poll timeout to the remaining budget."""
        return max(0.001, min(cap_s, self.remaining()))

    def to_wire(self) -> float:
        """REMAINING seconds, not an absolute stamp: peers re-anchor on
        their own clock, so skewed clocks cannot forge or destroy budget."""
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


# Thread-local deadline binding: the KV client helpers pick up the caller's
# deadline without a parameter through every call shape.
_TLS = threading.local()


class bind:
    """Context manager pushing a deadline onto this thread's stack;
    `bind(None)` is a no-op frame."""

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
# Retry with decorrelated jitter


@dataclass(frozen=True)
class RetryPolicy:
    """`retry_on` must be exception TYPES the caller considers transient;
    anything else propagates immediately."""

    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    retry_on: tuple = (OSError,)


def call(
    fn: Callable,
    site: str,
    policy: Optional[RetryPolicy] = None,
    deadline: Optional[Deadline] = None,
    sleeper: Callable[[float], None] = time.sleep,
    rng=None,
):
    """Run `fn()` under the retry policy. `deadline` defaults to the
    thread-bound one; `sleeper`/`rng` are injectable so tests run without
    wall-clock sleeps and with deterministic jitter."""
    policy = policy if policy is not None else RetryPolicy()
    if deadline is None:
        deadline = current()
    uniform = rng.uniform if rng is not None else random.uniform
    attempts = max(1, policy.max_attempts)
    prev_sleep = policy.base_s
    for attempt in range(1, attempts + 1):
        if deadline is not None:
            deadline.check(site)
        try:
            result = fn()
        except policy.retry_on:
            if attempt >= attempts:
                raise
            # Decorrelated jitter spreads a herd of retriers instead of
            # synchronizing them onto the recovering peer.
            sleep_s = min(policy.cap_s, uniform(policy.base_s, prev_sleep * 3))
            prev_sleep = sleep_s
            if deadline is not None:
                sleep_s = min(sleep_s, max(0.0, deadline.remaining()))
            if sleep_s > 0:
                sleeper(sleep_s)
            continue
        return result


# ---------------------------------------------------------------------------
# Circuit breaker

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitOpenError(RuntimeError):
    pass


class CircuitBreaker:
    """Per-endpoint circuit: `failure_threshold` consecutive failures open
    it; after `reset_timeout_s` ONE half-open probe is allowed, whose
    success closes it and whose failure re-opens it. `clock` is injectable
    for deterministic tests."""

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
        self._state = CLOSED          # guarded-by: _lock
        self._failures = 0            # guarded-by: _lock
        self._opened_at = 0.0         # guarded-by: _lock
        self._probe_inflight = False  # guarded-by: _lock
        self._probe_started_at = 0.0  # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed now? Open circuits fail fast until the reset
        timeout, then admit exactly one half-open probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = HALF_OPEN
                    self._probe_inflight = True
                    self._probe_started_at = self._clock()
                    return True
                return False
            # HALF_OPEN: one probe at a time, but a probe that never
            # reported back frees its slot after one reset window.
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
            self._state = CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            self._failures += 1
            if self._state == HALF_OPEN or (
                self._state == CLOSED and self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._state = OPEN

    def call(self, fn: Callable, retry_on: tuple = (OSError,)):
        """Fail fast with CircuitOpenError when open, otherwise run `fn`
        and record the outcome."""
        if not self.allow():
            raise CircuitOpenError(f"circuit open for {self.endpoint}")
        try:
            result = fn()
        except retry_on:
            self.record_failure()
            raise
        except BaseException:
            # Not a transport verdict: the circuit learns nothing, but the
            # probe slot is released.
            with self._lock:
                self._probe_inflight = False
            raise
        self.record_success()
        return result


# ---------------------------------------------------------------------------
# Graceful drain


class DrainGate:
    """Process-wide drain latch. `request()` flips it; worker loops poll
    `draining` between work items: admit nothing new, finish what is in
    flight, leave queued work for a successor, exit clean."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self.reason: Optional[str] = None

    @property
    def draining(self) -> bool:
        return self._event.is_set()

    def request(self, reason: str = "requested") -> bool:
        """Flip the latch (always accepted: True, as in the JAX package)."""
        self.reason = reason
        self._event.set()
        return True

    def reset(self) -> None:
        """Re-arm after a completed drain (tests; a real worker exits)."""
        self._event.clear()
        self.reason = None

    def install_signal_handler(self) -> None:
        """SIGTERM -> drain (main thread only)."""
        import signal

        signal.signal(signal.SIGTERM, lambda signum, frame: self.request("sigterm"))


DRAIN = DrainGate()


# ---------------------------------------------------------------------------
# Replay dedup


class SeenIds:
    """Bounded seen-id set for at-least-once consumers: `seen(id)` is True
    for a replay, else records the id (evicting the oldest past
    `capacity`)."""

    def __init__(self, capacity: int = 1024) -> None:
        self._lock = threading.Lock()
        self._capacity = max(1, int(capacity))
        self._order: "collections.deque[str]" = collections.deque()  # guarded-by: _lock
        self._ids: set = set()                                         # guarded-by: _lock

    def seen(self, rid: str) -> bool:
        """Atomic check-and-record. Consumers whose side effects can fail
        between delivery and completion use `contains()` at entry and
        `record()` after the side effect instead."""
        with self._lock:
            replay = rid in self._ids
            if not replay:
                self._record_locked(rid)
        return replay

    def contains(self, rid: str) -> bool:
        """Read-only replay check."""
        with self._lock:
            return rid in self._ids

    def record(self, rid: str) -> None:
        """Mark `rid` complete: call AFTER its side effects succeeded."""
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
