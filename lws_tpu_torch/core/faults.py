"""Deterministic fault injection: the port's copy of lws_tpu/core/faults.py.
Production code names its failure-prone moments as fault points
(`faults.fire("kv.ack")`), and a chaos test arms a deterministic schedule
against any point: the same schedule fires the same way every run.

Schedules (the `spec` grammar, also the `LWS_TPU_FAULTS` env grammar):

  fail_n_times:N[:Exc]   first N calls raise Exc (default OSError)
  every_k:K[:Exc]        every K-th call raises Exc
  delay:SECONDS[:N]      first N calls (0 = every call) sleep SECONDS
  drop[:N]               cooperative: first N calls (0 = every) return a
                         Fault("drop"); the call site implements the loss
                         (skip the ack, abandon the read)
  partial_write:BYTES[:N] cooperative: return Fault("partial_write", BYTES);
                         the site ships only BYTES bytes then fails
  exit[:N]               first N calls raise SystemExit(3): process death
                         when fired on a worker's main loop (the disagg
                         points); on a handler thread it ends that thread
  prob:P:SEED[:Exc]      seeded Bernoulli(P) failure, deterministic for a
                         given seed (`random.Random(SEED)`)
  pace:MBPS              cooperative: return Fault("pace", MBPS); the send
                         site sleeps nbytes / (MBPS * 1e6), a bandwidth-
                         limited link, fair per byte across monolithic and
                         streamed KV deliveries

A cooperative mode arms only at a point whose call site honors it
(`COOPERATIVE_POINTS`); anywhere else `arm` refuses it. Arm through
`LWS_TPU_FAULTS="point=spec,point=spec"` in the worker env (read at import
and again by `arm_from_env` at worker start), the injector API, or `POST
/debug/faults` on the worker telemetry server (`apply_control`). Every
firing bumps `lws_fault_trips_total{point,mode}` and appends a
`fault_injected` flight-recorder event.

Disarmed fast path (the production state): `fire()`/`hit()` read one
module-object flag and return: no locks, no dict lookups.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

FAULTS_ENV = "LWS_TPU_FAULTS"

# Exceptions a schedule may raise, by name — an allowlist, never eval():
# schedules may come from operator input.
_EXCEPTIONS = {
    "OSError": OSError,
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "ConnectionRefusedError": ConnectionRefusedError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}

MODES = ("fail_n_times", "every_k", "delay", "drop", "partial_write",
         "exit", "prob", "pace")
# Modes fire() enacts by raising/sleeping; the rest are cooperative — the
# call site reads the returned Fault and implements the behavior.
_RAISING_MODES = ("fail_n_times", "every_k", "exit", "prob")
_COOPERATIVE_MODES = ("drop", "partial_write", "pace")
# Cooperative modes each point's call site actually HONORS. Arming a
# cooperative mode anywhere (or any mode) the site does not implement is
# rejected at arm time: a bare fire() site would count the trip (and
# ring-event it) while injecting NOTHING, and a chaos run reasoning from
# trips that never happened proves the wrong thing. The map is
# (point, mode)-granular for the same reason — `kv.ack` implements drop
# but not partial_write or pace. Extend an entry when a site implements a
# new cooperation.
COOPERATIVE_POINTS = {
    "kv.ack": frozenset({"drop"}),
    "kv.server.send_bundle": frozenset({"partial_write", "pace"}),
    "kv.server.send_result": frozenset({"partial_write"}),
    "kv.stream.send_chunk": frozenset({"partial_write", "pace"}),
    "kv.stream.recv_chunk": frozenset({"drop", "partial_write"}),
}


@dataclass(frozen=True)
class Fault:
    """What a fired cooperative schedule hands the call site."""

    point: str
    mode: str
    arg: float = 0.0  # partial_write byte count / delay seconds


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
        self.arg = 0.0      # delay seconds / partial_write bytes
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
                self.arg = float(parts[1])
                self.n = int(parts[2]) if len(parts) > 2 else 0
            elif self.mode == "drop":
                self.n = int(parts[1]) if len(parts) > 1 else 0
            elif self.mode == "partial_write":
                self.arg = float(parts[1])
                self.n = int(parts[2]) if len(parts) > 2 else 0
            elif self.mode == "exit":
                self.n = int(parts[1]) if len(parts) > 1 else 1
            elif self.mode == "pace":
                self.arg = float(parts[1])  # MB/s the link is clamped to
                if self.arg <= 0:
                    raise ValueError("pace MB/s must be > 0")
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
        else:  # delay / drop / partial_write / exit: first n (0 = every)
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


def parse(text: str) -> dict[str, str]:
    """`LWS_TPU_FAULTS` grammar -> {point: spec}. Entries separated by `,`
    or `;`; each entry is `point=spec`. Raises ValueError on malformed
    input — a silently half-armed chaos run proves nothing."""
    out: dict[str, str] = {}
    for entry in text.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, sep, spec = entry.partition("=")
        if not sep or not point.strip() or not spec.strip():
            raise ValueError(f"bad fault entry {entry!r}; expected point=spec")
        out[point.strip()] = spec.strip()
    return out


class FaultInjector:
    """Per-process fault-point registry. The module-level INJECTOR is the
    process default (armed from LWS_TPU_FAULTS at import); tests build
    private instances or arm/disarm the default under try/finally."""

    def __init__(self, env: Optional[str] = None) -> None:
        self._lock = threading.Lock()
        self._points: dict[str, _Schedule] = {}  # guarded-by: _lock
        # Lock-free fast-path flag: fire()/hit() bail on it before touching
        # the lock, so a disarmed process pays one attribute read per point.
        self.armed = False
        text = os.environ.get(FAULTS_ENV, "") if env is None else env
        if text:
            self.arm_many(parse(text))

    # ---- arming ----------------------------------------------------------
    def arm(self, point: str, spec: str) -> None:
        schedule = _Schedule(point, spec)  # validate BEFORE mutating state
        if schedule.mode in _COOPERATIVE_MODES \
                and schedule.mode not in COOPERATIVE_POINTS.get(point, frozenset()):
            honoring = ", ".join(sorted(
                p for p, modes in COOPERATIVE_POINTS.items()
                if schedule.mode in modes
            )) or "none"
            raise ValueError(
                f"point {point!r} does not honor cooperative mode "
                f"{schedule.mode!r}; points honoring it: {honoring}"
            )
        with self._lock:
            self._points[point] = schedule
            self.armed = True
        self._gauge()

    def arm_many(self, specs: dict[str, str]) -> None:
        for point, spec in specs.items():
            self.arm(point, spec)

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
    def hit(self, point: str) -> Optional[Fault]:
        """Evaluate `point`'s schedule WITHOUT enacting anything: returns a
        Fault when it fired, None otherwise. The cooperative entry — call
        sites that need a typed failure (the store's injected ConflictError)
        or byte counts (partial_write) branch on the result."""
        if not self.armed:
            return None
        with self._lock:
            schedule = self._points.get(point)
            if schedule is None or not schedule.should_fire():
                return None
            mode, arg, exc = schedule.mode, schedule.arg, schedule.exc
        self._on_trip(point, mode)
        fault = Fault(point, mode, arg)
        # Stash the configured exception for fire() without widening the
        # frozen dataclass surface.
        object.__setattr__(fault, "_exc", exc)
        return fault

    def fire(self, point: str) -> Optional[Fault]:
        """hit() + enact: raising modes raise their exception (exit raises
        SystemExit(3) — process death), delay sleeps, cooperative modes
        (drop / partial_write) return the Fault for the site to honor."""
        fault = self.hit(point)
        if fault is None:
            return None
        if fault.mode == "exit":
            raise SystemExit(3)
        if fault.mode in _RAISING_MODES:
            raise getattr(fault, "_exc")(f"injected fault at {point}")
        if fault.mode == "delay":
            time.sleep(fault.arg)
            return None
        return fault  # drop / partial_write: cooperative

    def _on_trip(self, point: str, mode: str) -> None:
        from lws_tpu_torch.core import flightrecorder, metrics

        metrics.inc("lws_fault_trips_total", {"point": point, "mode": mode})
        flightrecorder.record("fault_injected", point=point, mode=mode)

    # ---- views -----------------------------------------------------------
    def snapshot(self) -> dict:
        """The GET /debug/faults response body: armed specs + counters."""
        with self._lock:
            return {
                "armed": {p: s.spec for p, s in self._points.items()},
                "hits": {p: s.hits for p, s in self._points.items()},
                "trips": {p: s.trips for p, s in self._points.items()},
            }


def apply_control(payload: dict) -> dict:
    """The POST /debug/faults body handler of the worker telemetry server:
    `{"arm": {point: spec, ...}}`, `{"disarm": [point, ...]}`, `{"clear":
    true}` — any combination; clear applies first. Bad specs/shapes raise
    ValueError (the caller answers 400)."""
    if not isinstance(payload, dict):
        raise ValueError("faults control body must be a JSON object")
    unknown = set(payload) - {"arm", "disarm", "clear"}
    if unknown:
        raise ValueError(f"unknown faults control key(s): {', '.join(sorted(unknown))}")
    if payload.get("clear"):
        INJECTOR.disarm()
    for point in payload.get("disarm") or []:
        INJECTOR.disarm(str(point))
    arm = payload.get("arm") or {}
    if not isinstance(arm, dict):
        raise ValueError("faults control 'arm' must be {point: spec}")
    INJECTOR.arm_many({str(p): str(s) for p, s in arm.items()})
    return INJECTOR.snapshot()


# Process-default injector, armed from the pod env at import (the worker
# processes read LWS_TPU_FAULTS exactly like LWS_TPU_TRACE).
INJECTOR = FaultInjector()


def fire(point: str) -> Optional[Fault]:
    if not INJECTOR.armed:
        return None
    return INJECTOR.fire(point)


def hit(point: str) -> Optional[Fault]:
    if not INJECTOR.armed:
        return None
    return INJECTOR.hit(point)


def arm_from_env() -> None:
    """Re-read LWS_TPU_FAULTS into the process injector (worker startup
    calls this so a spawn-time env always wins over import order)."""
    text = os.environ.get(FAULTS_ENV, "")
    if text:
        INJECTOR.arm_many(parse(text))
