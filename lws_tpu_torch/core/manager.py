"""Reconciler runtime: per-controller dedup workqueues fed by store watches.

≈ controller-runtime: level-triggered, idempotent reconciles keyed by object
key; watch mapping functions translate events on secondary kinds into primary
keys (ref SetupWithManager wiring, leaderworkerset_controller.go:224-256).

Deterministic execution: `run_until_stable()` drains every queue to a fixed
point with zero sleeps — the test-and-embedding-friendly mode. A threaded mode
(`start()`/`stop()`) runs the same queues on background workers for live
deployments.

The port's copy of lws_tpu/core/manager.py.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

from lws_tpu_torch.core import flightrecorder, trace
from lws_tpu_torch.core.store import ConflictError, Key, Store, WatchEvent


@dataclass
class Result:
    requeue: bool = False  # re-run immediately
    requeue_after: float = 0.0  # re-run after N seconds (ignored if requeue)


class Reconciler(Protocol):
    name: str

    def reconcile(self, key: Key) -> Optional[Result]: ...


MapFn = Callable[[object], list[Key]]


@dataclass
class _Registration:
    reconciler: Reconciler
    # kind -> mapping fn from event object to primary keys to enqueue.
    watches: dict[str, MapFn]
    queue: "collections.deque[Key]" = field(default_factory=lambda: collections.deque())
    queued: set[Key] = field(default_factory=set)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # Delayed requeues (Result.requeue_after): min-heap of (due, seq, key),
    # promoted into the live queue once due (controller-runtime RequeueAfter).
    delayed: list[tuple[float, int, Key]] = field(default_factory=list)
    _seq: "itertools.count" = field(default_factory=lambda: itertools.count())
    # (last key, last reconcile time, same-key streak) — the hot-loop
    # watchdog feed (Manager._hot_loop_beat).
    hot_loop: tuple = (None, 0.0, 0)

    def enqueue(self, key: Key) -> None:
        with self.lock:
            if key not in self.queued:
                self.queued.add(key)
                self.queue.append(key)

    def enqueue_after(self, key: Key, delay: float) -> None:
        with self.lock:
            heapq.heappush(self.delayed, (time.monotonic() + delay, next(self._seq), key))

    def _promote_due(self, now: float) -> None:
        # Caller holds self.lock.
        while self.delayed and self.delayed[0][0] <= now:
            _, _, key = heapq.heappop(self.delayed)
            if key not in self.queued:
                self.queued.add(key)
                self.queue.append(key)

    def flush_delays(self) -> None:
        """Promote ALL pending delayed requeues now (deterministic tests —
        'time passed' without sleeping)."""
        with self.lock:
            self._promote_due(float("inf"))

    def pop(self) -> Optional[Key]:
        with self.lock:
            self._promote_due(time.monotonic())
            if not self.queue:
                return None
            key = self.queue.popleft()
            self.queued.discard(key)
            return key

    def empty(self) -> bool:
        with self.lock:
            self._promote_due(time.monotonic())
            return not self.queue


class Manager:
    def __init__(self, store: Store, metrics=None, gate=None) -> None:
        """`gate`: optional () -> bool checked before dispatching work; while
        False (e.g. a standby awaiting leader election) queued items are held,
        not dropped. Applies to BOTH run_until_stable and threaded mode.

        Reconcile root spans go to the PROCESS tracer (trace.TRACER) — the
        same sink the reconcilers' child spans use; a per-manager tracer
        would orphan every child."""
        self.store = store
        self.metrics = metrics
        self.gate = gate
        self._registrations: list[_Registration] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        store.watch(self._on_event)

    def _timed_reconcile(self, reg: _Registration, key: Key):  # reconcile-path
        # ^ explicit purity-pass root: every registered reconciler dispatches
        # through here (register()-discovery also finds typed reconcilers,
        # but the mark anchors the loop itself).
        # Every reconcile runs inside a root span: the controller-layer
        # anchor of the trace spine (child spans live in the reconcilers;
        # serving subtrees graft on via propagated span contexts).
        name = reg.reconciler.name
        self._hot_loop_beat(reg, key, name)
        with trace.TRACER.span(
            "reconcile", controller=name,
            kind=key[0], namespace=key[1], object=key[2],
        ):
            if self.metrics is None:
                return reg.reconciler.reconcile(key)
            labels = {"controller": name}
            outcome = "success"
            start = time.perf_counter()
            try:
                result = reg.reconciler.reconcile(key)
            except ConflictError:
                # Benign optimistic-concurrency loss: requeued, not an error.
                outcome = "conflict"
                raise
            except Exception:
                outcome = "error"
                self.metrics.inc("lws_reconcile_errors_total", labels)
                raise
            finally:
                self.metrics.inc("lws_reconcile_total", labels)
                self.metrics.observe(
                    "lws_reconcile_duration_seconds",
                    time.perf_counter() - start,
                    {"controller": name, "result": outcome},
                )
            return result

    # Same-key reconciles inside this window extend the hot-loop streak;
    # a gap longer than the window (or a different key) resets it.
    HOT_LOOP_WINDOW_S = 1.0

    def _hot_loop_beat(self, reg: _Registration, key: Key, name: str) -> None:
        """Hot-loop watchdog feed: the heartbeat's depth carries this
        controller's current same-key reconcile streak — a controller
        requeue-looping on one object shows as an ever-growing streak with
        the flight recorder holding the offending key."""
        now = time.monotonic()
        last_key, last_t, streak = reg.hot_loop
        if key == last_key and now - last_t < self.HOT_LOOP_WINDOW_S:
            streak += 1
        else:
            streak = 1
        reg.hot_loop = (key, now, streak)
        flightrecorder.beat(f"reconcile:{name}", depth=streak)
        if streak in (100, 1000, 10000):  # log the key at escalation points
            flightrecorder.record(
                "reconcile_hot_loop", controller=name,
                object_kind=key[0], namespace=key[1], object=key[2],
                streak=streak,
            )

    def register(self, reconciler: Reconciler, watches: dict[str, MapFn]) -> None:
        self._registrations.append(_Registration(reconciler, watches))

    def flush_delays(self) -> None:
        """Promote every pending Result.requeue_after timer to runnable now
        (deterministic mode's substitute for waiting on the wall clock)."""
        for reg in self._registrations:
            reg.flush_delays()

    # ---- event fan-out -----------------------------------------------------
    def resync(self, kinds: Optional[list[str]] = None) -> None:
        """Enqueue every stored object of `kinds` (default: every kind any
        registration watches) to its watching controllers — the level-triggered
        cold-start resync after standing up a manager over existing state
        (≈ controller-runtime's initial cache List+sync)."""
        if kinds is None:
            seen: set[str] = set()
            for reg in self._registrations:
                seen.update(reg.watches)
            kinds = sorted(seen)
        for kind in kinds:
            for obj in self.store.list(kind):
                self._on_event(WatchEvent("MODIFIED", obj))

    def _on_event(self, event: WatchEvent) -> None:
        # Store-watch observer: runs synchronously on the COMMITTING writer's
        # thread. A key_fn is user-supplied mapping code — if it raises, the
        # exception must degrade to a missed requeue (re-covered by the next
        # resync sweep), not kill whichever thread happened to commit.
        for reg in self._registrations:
            fn = reg.watches.get(event.obj.kind)
            if fn is None:
                continue
            types = getattr(fn, "_event_types", None)
            if types is not None and event.type not in types:
                continue
            try:
                for key in fn(event.obj):
                    reg.enqueue(key)
            except Exception:  # vet: ignore[hazard-exception-swallow]: a broken key_fn must not kill the committing writer's thread (purity-observer-raise)
                continue

    # ---- deterministic mode ------------------------------------------------
    def run_until_stable(self, max_iterations: int = 10000) -> int:
        """Process queues to a fixed point; returns reconcile count.

        Conflict errors requeue (another writer won the optimistic-concurrency
        race — the standard controller-runtime pattern); any other exception
        propagates so tests fail loudly instead of looping.
        """
        if self.gate is not None and not self.gate():
            return 0  # standby: hold queued work until elected
        processed = 0
        for _ in range(max_iterations):
            progressed = False
            for reg in self._registrations:
                key = reg.pop()
                if key is None:
                    continue
                progressed = True
                processed += 1
                try:
                    result = self._timed_reconcile(reg, key)
                except ConflictError:
                    reg.enqueue(key)
                    continue
                if result and result.requeue:
                    reg.enqueue(key)
                elif result and result.requeue_after > 0:
                    reg.enqueue_after(key, result.requeue_after)
            if not progressed:
                return processed
        raise RuntimeError(
            f"run_until_stable did not converge after {max_iterations} iterations "
            f"(queues: {[(r.reconciler.name, len(r.queue)) for r in self._registrations]})"
        )

    # ---- threaded mode -----------------------------------------------------
    def start(self, poll_interval: float = 0.01) -> None:
        self._stop.clear()

        def worker(reg: _Registration) -> None:
            while not self._stop.is_set():
                if self.gate is not None and not self.gate():
                    time.sleep(poll_interval * 10)  # standby: hold the queue
                    continue
                key = reg.pop()
                if key is None:
                    time.sleep(poll_interval)
                    continue
                try:
                    result = self._timed_reconcile(reg, key)
                except ConflictError:
                    reg.enqueue(key)
                    continue
                except Exception:  # noqa: BLE001 — keep the loop alive like controller-runtime
                    import traceback

                    traceback.print_exc()
                    continue
                if result and result.requeue:
                    reg.enqueue(key)
                elif result and result.requeue_after > 0:
                    reg.enqueue_after(key, result.requeue_after)

        for reg in self._registrations:
            t = threading.Thread(target=worker, args=(reg,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()


def deleted_only(fn: MapFn) -> MapFn:
    """Mark a watch mapper to fire on DELETED events only. MapFns receive
    the object, not the event, so repair-style mappers (requeue the owner to
    recreate a deleted dependent) would otherwise also fire on every
    creation/status write of the dependent — pure no-op reconcile churn."""
    fn._event_types = ("DELETED",)  # type: ignore[attr-defined]
    return fn
