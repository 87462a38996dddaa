"""Bounded in-flight dispatch ring: the port's copy of
lws_tpu/serving/pipeline.py (DecodePipeline, remaining_steps), with its
telemetry hooks.

CUDA launches return before the device finishes, like JAX dispatch. The ring
keeps up to `depth` dispatched-but-unconsumed decode chunks in flight, so the
host consumes chunk N's tokens (a device-to-host copy, the one deliberate
wait) while chunk N+1 runs on the card. `depth=0` is the synchronous loop.

  * `push(steps, payload, commit)` enqueues a dispatched chunk; `payload`
    carries its tokens, `commit(host)` applies the host bookkeeping once the
    copy lands. Pushing past `depth` consumes the oldest chunk (FIFO: commit
    order is dispatch order, which the engine's host truth depends on).
  * `flush()` consumes everything in flight; `discard()` drops it
    uncommitted (the rollback after a failed dispatch).
  * `host_section()` times a host scheduling window; time spent there with
    an empty ring is time the device waited on the host (`host_blocked_s`,
    and the `serving_host_blocked_seconds{engine}` counter).
  * `serving_inflight_dispatches{engine}` gauges the ring depth live; each
    consume runs in a `serve.decode_consume` span carrying its
    `device_wait_s`; the `decode_ring:{engine}` heartbeat feeds the stall
    watchdog; `discard()` leaves a `pipeline_discard` flight-recorder
    event; `push` carries the `pipeline.dispatch` fault point.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from lws_tpu_torch.core import faults, flightrecorder, metrics, trace


def remaining_steps(req, max_len: int) -> int:
    """Decode steps a request can still take before completing: its token
    budget or the engine's length ceiling, whichever is nearer."""
    return min(
        req.max_new_tokens - len(req.tokens),
        max_len - len(req.prompt) - len(req.tokens),
    )


def _to_host(payload) -> np.ndarray:
    if isinstance(payload, torch.Tensor):
        return payload.cpu().numpy()  # the completion fence for CUDA payloads
    return np.asarray(payload)


class _HostSection:
    """Counts a host window as host-blocked only when no chunk was in flight
    at entry (device idle, host is the bottleneck)."""

    __slots__ = ("_pipe", "_blocked", "_t0")

    def __init__(self, pipe: "DecodePipeline") -> None:
        self._pipe = pipe

    def __enter__(self) -> "_HostSection":
        self._blocked = not self._pipe
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._blocked:
            dt = time.perf_counter() - self._t0
            with self._pipe._lock:
                self._pipe.stats["host_blocked_s"] += dt
            metrics.inc(
                "serving_host_blocked_seconds",
                {"engine": self._pipe.engine_label}, value=dt,
            )
            trace.current_span().add(host_blocked_s=dt)
        return False


class DecodePipeline:
    def __init__(self, depth: int = 2, engine: str = "paged") -> None:
        """`depth` caps dispatched-but-unconsumed chunks (0 = synchronous);
        `engine` labels the metrics this ring reports."""
        self.depth = max(0, int(depth))
        self.engine_label = engine
        # Re-entrant: a consume's commit may call back into flush()/len().
        self._lock = threading.RLock()
        self._ring: "deque[tuple[int, object, Callable]]" = deque()  # guarded-by: _lock
        self.stats = {  # guarded-by: _lock
            "dispatched": 0, "consumed": 0, "flushes": 0, "discarded": 0,
            "host_blocked_s": 0.0, "device_wait_s": 0.0, "max_inflight": 0,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._ring)

    def inflight_steps(self) -> int:
        """Decode steps dispatched but not yet committed to host truth."""
        with self._lock:
            return sum(steps for steps, _, _ in self._ring)

    def host_section(self) -> _HostSection:
        return _HostSection(self)

    def push(self, steps: int, payload, commit: Callable) -> None:
        # Disarmed this is one flag read. An armed `delay` schedule injects
        # dispatch-side slowness, a raising one a failed dispatch.
        faults.fire("pipeline.dispatch")
        with self._lock:
            self._ring.append((steps, payload, commit))
            self.stats["dispatched"] += 1
            while len(self._ring) > self.depth:
                self._consume_oldest()
            # Gauge/max after settling to depth: the transient depth + 1
            # during eviction is not an observable state.
            self.stats["max_inflight"] = max(self.stats["max_inflight"], len(self._ring))
            self._gauge()
            self._heartbeat()

    def flush(self) -> None:
        with self._lock:
            if self._ring:
                self.stats["flushes"] += 1
            while self._ring:
                self._consume_oldest()

    def discard(self) -> None:
        """Abandon every in-flight chunk without its commit: the caller
        restores device state from host truth (lws_tpu/serving/pipeline.py:161)."""
        with self._lock:
            if self._ring:
                # Ring event + trace id: a flight-recorder dump correlates
                # the rollback with the request that triggered it.
                flightrecorder.record(
                    "pipeline_discard", engine=self.engine_label,
                    chunks=len(self._ring), steps=self.inflight_steps(),
                )
            self.stats["discarded"] += len(self._ring)
            self._ring.clear()
            self._gauge()
            self._heartbeat()

    def _consume_oldest(self) -> None:  # holds-lock: _lock
        steps, payload, commit = self._ring.popleft()
        with trace.span(
            "serve.decode_consume", engine=self.engine_label, steps=steps,
            inflight=len(self._ring),
        ) as sp:
            t0 = time.perf_counter()
            host = _to_host(payload)
            wait = time.perf_counter() - t0
            self.stats["device_wait_s"] += wait
            sp.set(device_wait_s=round(wait, 6))
            with self.host_section():
                commit(host)
        self.stats["consumed"] += 1
        self._gauge()
        self._heartbeat()

    def _gauge(self) -> None:  # holds-lock: _lock
        metrics.set(
            "serving_inflight_dispatches", len(self._ring),
            {"engine": self.engine_label},
        )

    def _heartbeat(self) -> None:  # holds-lock: _lock
        # Stall-watchdog feed: progress = chunks that left the ring
        # (consumed or discarded), depth = chunks still in flight. A wedged
        # device dispatch shows as depth > 0 with frozen progress.
        flightrecorder.beat(
            f"decode_ring:{self.engine_label}",
            progress=self.stats["consumed"] + self.stats["discarded"],
            depth=len(self._ring),
        )
