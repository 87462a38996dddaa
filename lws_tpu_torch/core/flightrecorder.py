"""Flight recorder + stall watchdogs: the port's copy of
lws_tpu/core/flightrecorder.py. Capture the anomalous window, not the
average one.

Two cheap feeds, one bounded ring:

  * `record(kind, **fields)` appends a structured event (wall time, kind,
    the active trace context, fields) to a bounded deque — the black-box
    ring a diagnostics dump replays. Call sites are the NOTABLE paths
    (pipeline rollback, watchdog trips, injected faults), not the hot loop.
  * `beat(name, progress=None, depth=0.0)` updates a per-source heartbeat:
    `progress` is a monotonic work counter (auto-incremented when omitted),
    `depth` is the work currently pending behind it. Heartbeats are a dict
    write + one clock read — cheap enough for the decode dispatch ring.

The Watchdog evaluates rules over the heartbeat table:

  * StallRule     — pending work (`depth > 0`) whose progress counter has
    not advanced for `stall_after` seconds: a wedged decode ring.
    Slow-but-progressing sources never trip (progress advancing resets
    the clock).
  * HotLoopRule   — a source whose `depth` carries a same-key streak past
    `streak`: a controller requeue-looping on one object.
  * BacklogRule   — `depth` at or above `depth_threshold` for `sustain`
    seconds: KV bundles piling up faster than decode drains them; with
    pinned progress and sustain 0, a condition held by an external
    evaluator (an open breaker, a compile storm, HBM pressure).
  * TripRule      — a counter that advanced within `window_s`: a burst of
    deadline expirations.

On an alert transitioning inactive -> firing the watchdog appends a ring
event, bumps `lws_watchdog_alerts_total{watchdog}`, flips
`lws_watchdog_active{watchdog}` to 1, and captures a diagnostics bundle
(ring + recent spans + metrics snapshot + heartbeat table, and the
profile, compile-ledger, history-ring and worst-journey snapshots, and
the rollout ledger and the decision window) retrievable at
`GET /debug/flightrecorder`. `check_now()` is the deterministic entry tests
use; `start()` runs the same check on a thread (the worker telemetry
server's, runtime/telemetry.py).

The module-level RECORDER is the process default (one black box per
process, like metrics.REGISTRY and trace.TRACER; the port's, not the JAX
package's).
"""

from __future__ import annotations

import fnmatch
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from lws_tpu_torch.core import metrics, trace
from lws_tpu_torch.utils.common import env_float as _env_float


@dataclass
class Heartbeat:
    name: str
    progress: float = 0.0
    depth: float = 0.0
    last_beat: float = 0.0     # monotonic time of the last beat
    last_advance: float = 0.0  # monotonic time progress last CHANGED


class FlightRecorder:
    def __init__(self, ring: int = 2048) -> None:
        self._ring: "deque[dict]" = deque(maxlen=ring)  # guarded-by: _lock
        self._beats: dict[str, Heartbeat] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # Event observers: called with every recorded event — the journey
        # vault's resilience feed (obs/journey.py). The ring stays
        # the source of truth; observers only mirror.
        self._observers: list = []

    def add_observer(self, fn) -> None:
        """Register `fn(event)` to observe every recorded event (idempotent
        per function) — how the journey vault attaches retries, breaker
        transitions, deadline trips, and fault injections to requests."""
        if fn not in self._observers:
            self._observers.append(fn)

    def remove_observer(self, fn) -> None:
        if fn in self._observers:
            self._observers.remove(fn)

    # ---- feeds -----------------------------------------------------------
    def record(self, kind: str, **fields) -> dict:
        ctx = trace.current_context()
        event = {
            "ts": round(time.time(), 6),
            "kind": kind,
            "trace": ctx,
            **fields,
        }
        with self._lock:
            self._ring.append(event)
        metrics.inc("lws_flightrecorder_events_total", {"kind": kind})
        for observer in self._observers:
            try:
                observer(event)
            except Exception:  # noqa: BLE001 — a broken observer must never break event recording
                pass
        return event

    def beat(self, name: str, progress: Optional[float] = None,
             depth: float = 0.0, now: Optional[float] = None) -> None:
        """`now` (monotonic seconds) exists for deterministic tests — the
        production feeds never pass it."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            hb = self._beats.get(name)
            if hb is None:
                hb = self._beats[name] = Heartbeat(
                    name, last_beat=now, last_advance=now
                )
            if progress is None:
                progress = hb.progress + 1.0
            if progress != hb.progress:
                hb.last_advance = now
            hb.progress = progress
            hb.depth = depth
            hb.last_beat = now

    # ---- views -----------------------------------------------------------
    def events(self, limit: Optional[int] = None) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        if limit is not None and limit >= 0:
            out = out[-limit:] if limit else []
        return out

    def snapshot_beats(self) -> dict[str, Heartbeat]:
        """Consistent point-in-time copies for the watchdog rules: reading
        the live Heartbeat objects field-by-field outside the lock could
        tear (new depth, stale last_advance) into a one-tick false alert."""
        with self._lock:
            return {
                name: Heartbeat(hb.name, hb.progress, hb.depth,
                                hb.last_beat, hb.last_advance)
                for name, hb in self._beats.items()
            }

    def heartbeats(self) -> dict[str, dict]:
        now = time.monotonic()
        with self._lock:
            return {
                name: {
                    "progress": hb.progress,
                    "depth": hb.depth,
                    "beat_age_s": round(now - hb.last_beat, 3),
                    "advance_age_s": round(now - hb.last_advance, 3),
                }
                for name, hb in self._beats.items()
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._beats.clear()

    def dump(self, reason: str = "manual", registries: tuple = (),
             span_limit: int = 256) -> dict:
        """The diagnostics bundle: everything an operator needs to explain
        the window that just went wrong, in one JSON-serializable dict —
        including the process profile (a stall alert ships the collapsed
        stacks of the window that stalled), the compile-ledger window, the
        process history ring, the journey vault's worst retained journeys
        (the requests the bad window actually hurt), the rollout ledger
        and the decision window (local imports: profile.py and the obs
        modules are consumers of this module's surfaces, not
        dependencies)."""
        from lws_tpu_torch.core import profile as profmod
        from lws_tpu_torch.obs import decisions as decisionsmod
        from lws_tpu_torch.obs import device as devicemod
        from lws_tpu_torch.obs import history as historymod
        from lws_tpu_torch.obs import journey as journeymod
        from lws_tpu_torch.obs import rollout as rolloutmod

        exposition = (
            metrics.render_exposition(metrics.REGISTRY, *registries)
            if registries else metrics.REGISTRY.render()
        )
        return {
            "reason": reason,
            "captured_unix": round(time.time(), 6),
            "events": self.events(),
            "heartbeats": self.heartbeats(),
            "spans": trace.TRACER.spans(span_limit),
            "metrics": exposition,
            "profile": profmod.PROFILER.snapshot(limit=128),
            "history": historymod.HISTORY.snapshot(limit=64, max_points=256),
            "journeys": journeymod.VAULT.worst(limit=8),
            "rollout": rolloutmod.LEDGER.snapshot(limit=64),
            # The recent decision window: an alert's dump carries the
            # actuation provenance of the episode that fired it.
            "decisions": decisionsmod.DECISIONS.snapshot(limit=32),
            # The compile-ledger window: a compile_storm (or any) alert
            # ships the offending executable's recompile provenance.
            "compiles": devicemod.LEDGER.snapshot(limit=64),
        }


# ---------------------------------------------------------------------------
# Watchdog rules. Each rule names the sources it watches by fnmatch pattern
# and returns firing (name, detail) pairs from the heartbeat table.


@dataclass(frozen=True)
class StallRule:
    """Pending work with a non-advancing progress counter = a stall."""

    name: str
    pattern: str
    stall_after_s: float = 5.0

    def firing(self, beats: dict[str, Heartbeat], now: float) -> list[dict]:
        out = []
        for src, hb in beats.items():
            if not fnmatch.fnmatch(src, self.pattern):
                continue
            if hb.depth > 0 and now - hb.last_advance > self.stall_after_s:
                out.append({
                    "source": src, "depth": hb.depth,
                    "stalled_for_s": round(now - hb.last_advance, 3),
                })
        return out


@dataclass(frozen=True)
class HotLoopRule:
    """depth carries a same-key streak counter; past `streak` it's a loop.
    A source whose beats went quiet for `idle_after_s` stops firing: the
    streak value latches in the table (nothing resets it once the loop's
    queue drains), so staleness — not depth — is the clear signal."""

    name: str
    pattern: str
    streak: float = 100.0
    idle_after_s: float = 5.0

    def firing(self, beats: dict[str, Heartbeat], now: float) -> list[dict]:
        return [
            {"source": src, "streak": hb.depth}
            for src, hb in beats.items()
            if fnmatch.fnmatch(src, self.pattern) and hb.depth >= self.streak
            and now - hb.last_beat <= self.idle_after_s
        ]


@dataclass(frozen=True)
class TripRule:
    """A counter that ADVANCED within `window_s` = a recent trip burst.
    The deadline feed (`deadline_trips:{site}`, core/resilience.py) beats
    progress on every expiration: the rule fires while trips are fresh and
    clears once the burst goes quiet — so the Watchdog's edge logic yields
    exactly one alert (and one diagnostics dump) per burst."""

    name: str
    pattern: str
    window_s: float = 5.0

    def firing(self, beats: dict[str, Heartbeat], now: float) -> list[dict]:
        return [
            {"source": src, "trips": hb.progress}
            for src, hb in beats.items()
            if fnmatch.fnmatch(src, self.pattern) and hb.progress > 0
            and now - hb.last_advance <= self.window_s
        ]


@dataclass(frozen=True)
class BacklogRule:
    """Sustained queue depth at/over the threshold = a backlog."""

    name: str
    pattern: str
    depth_threshold: float = 8.0
    sustain_s: float = 5.0

    def firing(self, beats: dict[str, Heartbeat], now: float) -> list[dict]:
        # A beat below threshold bumps nothing; sustain is measured as time
        # since progress last advanced while depth sits at/over threshold —
        # a draining backlog advances progress and never fires.
        out = []
        for src, hb in beats.items():
            if not fnmatch.fnmatch(src, self.pattern):
                continue
            if hb.depth >= self.depth_threshold and \
                    now - hb.last_advance > self.sustain_s:
                out.append({
                    "source": src, "depth": hb.depth,
                    "backlogged_for_s": round(now - hb.last_advance, 3),
                })
        return out


def default_rules() -> list:
    """The JAX package's rule set, name for name: a non-advancing decode
    dispatch ring (serving/pipeline.py), a reconcile hot loop, KV-handoff
    backlog (serving/kv_transport.py), an open circuit breaker, a
    deadline-expiration burst (core/resilience.py), and the device-runtime
    rules (obs/device.py). A port worker beats no `reconcile:*`,
    `burn_rate:*` or `canary:*` source (the control plane's feeds), so
    those rules stay inert there, as in a JAX worker. The ring's progress
    counter cannot distinguish one legitimately long device dispatch from
    a wedge, so the default stall window is generous (30s — far past any
    sane dispatch, short enough to catch a real wedge) and env-tunable per
    deployment (LWS_TPU_WATCHDOG_STALL_S, and the other LWS_TPU_WATCHDOG_*
    knobs below)."""
    return [
        StallRule("decode_ring_stall", "decode_ring:*",
                  stall_after_s=_env_float("LWS_TPU_WATCHDOG_STALL_S", 30.0)),
        HotLoopRule("reconcile_hot_loop", "reconcile:*",
                    streak=_env_float("LWS_TPU_WATCHDOG_STREAK", 100.0)),
        BacklogRule("kv_handoff_backlog", "kv_backlog:*",
                    depth_threshold=_env_float("LWS_TPU_WATCHDOG_DEPTH", 8.0),
                    sustain_s=_env_float("LWS_TPU_WATCHDOG_SUSTAIN_S", 5.0)),
        # Resilience-plane rules (core/resilience.py feeds): an OPEN
        # circuit breaker (depth 1 on `breaker:{endpoint}`, progress
        # pinned so sustain runs) and a recent deadline-expiration burst
        # each produce one edge-triggered alert with a diagnostics dump.
        BacklogRule("circuit_open", "breaker:*",
                    depth_threshold=1.0, sustain_s=0.0),
        TripRule("deadline_tripped", "deadline_trips:*",
                 window_s=_env_float("LWS_TPU_WATCHDOG_TRIP_WINDOW_S", 5.0)),
        # History-plane rule (the JAX package's obs/recommend.py feed): while an SLO
        # series' fast burn tier fires, the recommender holds a
        # `burn_rate:{engine}[/{klass}]` heartbeat at depth 1 with pinned
        # progress (the circuit_open convention) — one edge-triggered
        # alert + diagnostics dump per burn episode, the dump's event ring
        # carrying the offending error-series window.
        BacklogRule("burn_rate", "burn_rate:*",
                    depth_threshold=1.0, sustain_s=0.0),
        # Rollout-plane rule (the JAX package's obs/rollout.py feed): while a
        # revision's canary verdict is `rollback`, the analyzer holds a
        # `canary:{lws}/{revision}` heartbeat at depth 1 — one
        # edge-triggered alert + dump per regression episode, the firing
        # edge's ring event embedding the offending revision's error
        # series and the rollout-ledger window.
        BacklogRule("canary_regression", "canary:*",
                    depth_threshold=1.0, sustain_s=0.0),
        # Device-runtime rules (obs/device.py feeds): the compile
        # ledger holds `compile_storm:{executable}` at depth >= storm_n
        # while one executable has recompiled N times inside the window,
        # and the shared device-memory refresh holds
        # `hbm_pressure:{device}` at its occupancy while past the
        # LWS_TPU_HBM_PRESSURE threshold — both pinned-progress, so each
        # episode fires exactly once and the dump embeds the compile
        # ledger window that explains it.
        BacklogRule("compile_storm", "compile_storm:*",
                    depth_threshold=1.0, sustain_s=0.0),
        BacklogRule("hbm_pressure", "hbm_pressure:*",
                    depth_threshold=1.0, sustain_s=0.0),
    ]


class Watchdog:
    def __init__(
        self,
        recorder: Optional[FlightRecorder] = None,
        rules: Optional[list] = None,
        registries: tuple = (),
        on_alert: Optional[Callable[[dict], None]] = None,
    ) -> None:
        self.recorder = recorder if recorder is not None else RECORDER
        self.rules = rules if rules is not None else default_rules()
        self._registries = registries
        self._on_alert = on_alert
        self._active: dict[str, list[dict]] = {}  # guarded-by: _lock
        # Written by check_now (any thread: the watchdog loop, a caller's
        # deterministic check) and read by debug surfaces — the
        # `last_dump` property serializes both sides.
        self._last_dump: Optional[dict] = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ---- deterministic entry (tests) --------------------------------------
    def check_now(self, now: Optional[float] = None) -> dict[str, list[dict]]:
        """Evaluate every rule; returns {alert_name: [detail, ...]} for the
        currently-firing set. Transitions drive the metrics/ring/dump side
        effects; steady firing states don't re-dump."""
        now = time.monotonic() if now is None else now
        beats = self.recorder.snapshot_beats()
        firing: dict[str, list[dict]] = {}
        for rule in self.rules:
            hits = rule.firing(beats, now)
            if hits:
                firing[rule.name] = hits
        with self._lock:
            started = {k: v for k, v in firing.items() if k not in self._active}
            cleared = [k for k in self._active if k not in firing]
            self._active = firing
        for name in cleared:
            metrics.set("lws_watchdog_active", 0.0, {"watchdog": name})
        for name, hits in started.items():
            metrics.inc("lws_watchdog_alerts_total", {"watchdog": name})
            metrics.set("lws_watchdog_active", 1.0, {"watchdog": name})
            event = self.recorder.record(
                "watchdog_alert", watchdog=name, detail=hits
            )
            # Capture the window NOW: the ring still holds the events that
            # led here, the tracer still holds the request's spans.
            dump = self.recorder.dump(
                reason=f"watchdog:{name}", registries=self._registries
            )
            dump["alert"] = event
            with self._lock:
                self._last_dump = dump
            if self._on_alert is not None:
                self._on_alert(event)
        return firing

    @property
    def last_dump(self) -> Optional[dict]:
        """Diagnostics bundle captured at the most recent inactive->firing
        transition (None until the first alert)."""
        with self._lock:
            return self._last_dump

    def active(self) -> dict[str, list[dict]]:
        with self._lock:
            return dict(self._active)

    # ---- threaded mode ---------------------------------------------------
    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.check_now()
                except Exception:  # noqa: BLE001 — the watchdog must outlive bad beats
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# Process-default recorder + conveniences (one black box per process).
RECORDER = FlightRecorder()


def record(kind: str, **fields) -> dict:
    return RECORDER.record(kind, **fields)


def beat(name: str, progress: Optional[float] = None, depth: float = 0.0) -> None:
    RECORDER.beat(name, progress, depth)


def dump(reason: str = "manual", registries: tuple = ()) -> dict:
    return RECORDER.dump(reason, registries)


def debug_snapshot(limit: int, watchdog: Optional[Watchdog] = None) -> dict:
    """The GET /debug/flightrecorder response body (runtime/telemetry.py)."""
    return {
        "events": RECORDER.events(limit),
        "heartbeats": RECORDER.heartbeats(),
        "alerts": watchdog.active() if watchdog else {},
        "last_dump": watchdog.last_dump if watchdog else None,
    }
