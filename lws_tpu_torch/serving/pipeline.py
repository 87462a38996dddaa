"""Bounded in-flight dispatch ring: the port's copy of
lws_tpu/serving/pipeline.py (DecodePipeline, remaining_steps) without the
telemetry hooks (faults, flight recorder, metrics, spans).

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
    an empty ring is time the device waited on the host (`host_blocked_s`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch


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
        return False


class DecodePipeline:
    def __init__(self, depth: int = 2) -> None:
        """`depth` caps dispatched-but-unconsumed chunks (0 = synchronous)."""
        self.depth = max(0, int(depth))
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
        with self._lock:
            self._ring.append((steps, payload, commit))
            self.stats["dispatched"] += 1
            while len(self._ring) > self.depth:
                self._consume_oldest()
            self.stats["max_inflight"] = max(self.stats["max_inflight"], len(self._ring))

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
            self.stats["discarded"] += len(self._ring)
            self._ring.clear()

    def _consume_oldest(self) -> None:  # holds-lock: _lock
        _, payload, commit = self._ring.popleft()
        t0 = time.perf_counter()
        host = _to_host(payload)
        self.stats["device_wait_s"] += time.perf_counter() - t0
        with self.host_section():
            commit(host)
        self.stats["consumed"] += 1
