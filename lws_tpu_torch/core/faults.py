"""Deterministic fault injection: the port's copy of lws_tpu/core/faults.py,
trimmed to the injector's raising and delay modes, armed through the API.
Production code names its failure-prone moments as fault points
(`faults.fire("pipeline.dispatch")`), and a chaos test arms a deterministic
schedule against any point: the same schedule fires the same way every run.

Schedules (the `spec` grammar of `arm`):

  fail_n_times:N[:Exc]   first N calls raise Exc (default OSError)
  every_k:K[:Exc]        every K-th call raises Exc
  delay:SECONDS[:N]      first N calls (0 = every call) sleep SECONDS
  exit[:N]               first N calls raise SystemExit(3)
  prob:P:SEED[:Exc]      seeded Bernoulli(P) failure — deterministic for a
                         given seed (`random.Random(SEED)`)

Every firing bumps `lws_fault_trips_total{point,mode}` and appends a
`fault_injected` flight-recorder event. The JAX package's env arming
(`LWS_TPU_FAULTS`) and its cooperative modes (drop, partial_write, pace)
come with the port's first caller of either: the KV wire's fault points.

Disarmed fast path (the production state): `fire()` reads one
module-object flag and returns — no locks, no dict lookups.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# Exceptions a schedule may raise, by name — an allowlist, never eval():
# the schedules may come from operator input.
_EXCEPTIONS = {
    "OSError": OSError,
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "ConnectionRefusedError": ConnectionRefusedError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}

MODES = ("fail_n_times", "every_k", "delay", "exit", "prob")


class _Schedule:
    """One armed point's parsed spec + firing state. Counters are touched
    only under the injector's lock."""

    def __init__(self, point: str, spec: str) -> None:
        self.point = point
        self.spec = spec
        self.hits = 0   # calls seen
        self.trips = 0  # calls fired
        parts = spec.split(":")
        self.mode = parts[0]
        if self.mode not in MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r} for point {point!r}; "
                f"one of {', '.join(MODES)}"
            )
        self.exc = OSError
        self.n = 0          # firing-count bound (0 = unlimited)
        self.delay_s = 0.0
        self.k = 0          # every_k period
        self._rng = None
        self.p = 0.0
        try:
            if self.mode == "fail_n_times":
                self.n = int(parts[1])
                if len(parts) > 2:
                    self.exc = _exception(parts[2])
            elif self.mode == "every_k":
                self.k = int(parts[1])
                if self.k < 1:
                    raise ValueError("every_k period must be >= 1")
                if len(parts) > 2:
                    self.exc = _exception(parts[2])
            elif self.mode == "delay":
                self.delay_s = float(parts[1])
                self.n = int(parts[2]) if len(parts) > 2 else 0
            elif self.mode == "exit":
                self.n = int(parts[1]) if len(parts) > 1 else 1
            elif self.mode == "prob":
                import random

                self.p = float(parts[1])
                self._rng = random.Random(int(parts[2]))
                if len(parts) > 3:
                    self.exc = _exception(parts[3])
        except (IndexError, ValueError) as e:
            raise ValueError(f"bad fault spec {spec!r} for {point!r}: {e}") from e

    def should_fire(self) -> bool:  # holds-lock: injector _lock
        self.hits += 1
        if self.mode == "fail_n_times":
            fired = self.trips < self.n
        elif self.mode == "every_k":
            fired = self.hits % self.k == 0
        elif self.mode == "prob":
            fired = self._rng.random() < self.p
        else:  # delay / exit: first n (0 = every)
            fired = self.n == 0 or self.trips < self.n
        if fired:
            self.trips += 1
        return fired


def _exception(name: str) -> type:
    exc = _EXCEPTIONS.get(name)
    if exc is None:
        raise ValueError(
            f"unknown fault exception {name!r}; one of {', '.join(_EXCEPTIONS)}"
        )
    return exc


class FaultInjector:
    """Per-process fault-point registry. The module-level INJECTOR is the
    process default; tests build private instances or arm/disarm the
    default under try/finally."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._points: dict[str, _Schedule] = {}  # guarded-by: _lock
        # Lock-free fast-path flag: fire() bails on it before touching the
        # lock, so a disarmed process pays one attribute read per point.
        self.armed = False

    # ---- arming ----------------------------------------------------------
    def arm(self, point: str, spec: str) -> None:
        schedule = _Schedule(point, spec)  # validate BEFORE mutating state
        with self._lock:
            self._points[point] = schedule
            self.armed = True
        self._gauge()

    def disarm(self, point: Optional[str] = None) -> None:
        """Disarm one point, or everything when `point` is None."""
        with self._lock:
            if point is None:
                self._points.clear()
            else:
                self._points.pop(point, None)
            self.armed = bool(self._points)
        self._gauge()

    def _gauge(self) -> None:
        from lws_tpu_torch.core import metrics

        with self._lock:
            n = len(self._points)
        metrics.set("lws_fault_points_armed", float(n))

    # ---- firing ----------------------------------------------------------
    def fire(self, point: str) -> None:
        """Evaluate `point`'s schedule and enact it: raising modes raise
        their exception (exit raises SystemExit(3) — process death), delay
        sleeps."""
        if not self.armed:
            return
        with self._lock:
            schedule = self._points.get(point)
            if schedule is None or not schedule.should_fire():
                return
            mode, delay_s, exc = schedule.mode, schedule.delay_s, schedule.exc
        self._on_trip(point, mode)
        if mode == "exit":
            raise SystemExit(3)
        if mode == "delay":
            time.sleep(delay_s)
            return
        raise exc(f"injected fault at {point}")

    def _on_trip(self, point: str, mode: str) -> None:
        from lws_tpu_torch.core import flightrecorder, metrics

        metrics.inc("lws_fault_trips_total", {"point": point, "mode": mode})
        flightrecorder.record("fault_injected", point=point, mode=mode)

    # ---- views -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Armed specs + counters."""
        with self._lock:
            return {
                "armed": {p: s.spec for p, s in self._points.items()},
                "hits": {p: s.hits for p, s in self._points.items()},
                "trips": {p: s.trips for p, s in self._points.items()},
            }


# Process-default injector, disarmed until a caller arms it.
INJECTOR = FaultInjector()


def fire(point: str) -> None:
    if not INJECTOR.armed:
        return
    INJECTOR.fire(point)
