"""Continuous profiling + capacity accounting: the port's copy of
lws_tpu/core/profile.py, trimmed to what the port calls: the wall-clock
`StackSampler` whose snapshot every flight-recorder dump embeds, phase
tags, and `record_device_memory`, which reads the CUDA caching
allocator's statistics where the JAX package reads jax's. Left out: the
folding and merge helpers and `start_from_env`, which serve the JAX
package's `/debug/profile` surfaces and `lws-tpu profile`.

  * `StackSampler` — a low-overhead wall-clock sampling profiler: a daemon
    thread walks `sys._current_frames()` at `hz` and folds every thread's
    frame stack into a bounded collapsed-stack table. Each sample is
    tagged with the sampled thread's live `core/trace.py` span stack (plus
    any explicit `phase()` tags), rendered as synthetic `span:<name>` root
    frames. `sample_once(frames=...)` is the deterministic entry.
  * capacity accounting — `record_device_memory()` refreshes per-device
    HBM gauges from the allocator (a process that never used the card
    reports nothing), and the serving engines feed
    `serving_kv_pool_blocks{state=free|live|parked}` plus the prefix-cache
    hit/miss/evict counters.

The module-level PROFILER is the process default, like metrics.REGISTRY
and trace.TRACER.
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

from lws_tpu_torch.core import metrics, trace

# Default rate: ~67 samples/s costs tens of microseconds each (walk every
# thread's ~30 frames) — well under the 2% budget — and the non-round rate
# avoids phase-locking with 10ms/100ms periodic work.
DEFAULT_HZ = 67.0
DEFAULT_MAX_STACKS = 2048
MAX_FRAMES = 64


# ---------------------------------------------------------------------------
# Phase tags: explicit semantic markers for regions that want profile
# attribution even when tracing is off (spans are the usual tag source —
# phases are the lighter escape hatch, a list append/pop with no ring, no
# clock reads, no export).

_PHASE_STACKS: dict[int, list[str]] = {}  # ident -> tag stack (GIL-atomic ops)


class _PhaseTag:
    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_PhaseTag":
        _PHASE_STACKS.setdefault(threading.get_ident(), []).append(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _PHASE_STACKS.get(threading.get_ident())
        if stack and stack[-1] == self.name:
            stack.pop()
        return False


def phase(name: str) -> _PhaseTag:
    """Tag the current thread's profile samples with a semantic phase name
    for the duration of the `with` block."""
    return _PhaseTag(name)


def phase_names(ident: int) -> list[str]:
    """The explicit phase-tag stack live on thread `ident` (outermost
    first). Copied so a concurrent push/pop cannot tear the read."""
    return list(_PHASE_STACKS.get(ident) or ())


# ---------------------------------------------------------------------------


class StackSampler:
    """Wall-clock sampling profiler over `sys._current_frames()`.

    `hz` is the sampling rate of the threaded mode (start()/stop());
    `sample_once()` is the deterministic entry tests and benchmarks drive.
    `max_stacks` bounds the collapsed table: novel stacks past the cap are
    dropped and counted (`lws_profile_stacks_dropped_total`) instead of
    growing host memory without bound — known stacks keep counting."""

    def __init__(
        self,
        hz: Optional[float] = None,
        max_stacks: int = DEFAULT_MAX_STACKS,
        tracer: Optional["trace.Tracer"] = None,
    ) -> None:
        if hz is None:
            hz = DEFAULT_HZ
        self.hz = float(hz)
        self.max_stacks = max_stacks
        self._tracer = tracer if tracer is not None else trace.TRACER
        self._lock = threading.Lock()
        self._stacks: dict[str, int] = {}  # guarded-by: _lock
        self._samples = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- sampling --------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None

    @staticmethod
    def _walk(frame) -> list[str]:
        """One thread's frame stack as `module:qualname` strings, outermost
        first, bounded at MAX_FRAMES (deep recursion keeps its leaf end —
        that is where the time is attributed)."""
        out: list[str] = []
        f = frame
        while f is not None and len(out) < MAX_FRAMES:
            code = f.f_code
            module = f.f_globals.get("__name__", "?")
            out.append(f"{module}:{getattr(code, 'co_qualname', code.co_name)}")
            f = f.f_back
        out.reverse()
        return out

    def sample_once(self, frames: Optional[dict] = None) -> int:
        """One sampling pass over every live thread; returns the number of
        thread samples folded in. `frames` (an `{ident: frame}` dict, the
        `sys._current_frames()` shape) is injectable for deterministic
        tests. The sampler's own threads are excluded — a profiler must not
        profile itself into every report."""
        injected = frames is not None
        if frames is None:
            frames = sys._current_frames()
        own = {threading.get_ident()}
        if self._thread is not None and self._thread.ident is not None:
            own.add(self._thread.ident)
        if not injected:
            # Dead threads' span stacks would otherwise pin their lists
            # forever. Only prune on FULL passes: an injected frame dict
            # (tests, benchmarks) covers a subset of live threads, and
            # pruning against it would permanently deregister every other
            # thread's span stack (TLS state already exists, so nothing
            # ever re-registers them).
            self._tracer.prune_thread_stacks(set(frames))
        folded: list[str] = []
        for ident, frame in frames.items():
            if ident in own:
                continue
            stack = self._walk(frame)
            if not stack:
                continue
            tags = self._tracer.stack_names(ident) + phase_names(ident)
            folded.append(";".join([f"span:{t}" for t in tags] + stack))
        dropped = 0
        with self._lock:
            for key in folded:
                if key not in self._stacks and len(self._stacks) >= self.max_stacks:
                    self._dropped += 1
                    dropped += 1
                    continue
                self._stacks[key] = self._stacks.get(key, 0) + 1
            self._samples += len(folded)
        if folded:
            metrics.inc("lws_profile_samples_total", value=float(len(folded)))
        if dropped:
            metrics.inc("lws_profile_stacks_dropped_total", value=float(dropped))
        return len(folded)

    # ---- threaded mode ---------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            period = 1.0 / max(self.hz, 0.1)
            while not self._stop.wait(period):
                try:
                    self.sample_once()
                except Exception:  # noqa: BLE001 — the sampler must outlive odd frames
                    pass

        self._thread = threading.Thread(
            target=loop, name="lws-tpu-profiler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ---- views -----------------------------------------------------------
    def snapshot(self, limit: Optional[int] = None) -> dict:
        """Collapsed stacks (count-desc,
        `limit` keeps the heaviest N) plus sampler meta. JSON-serializable."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: (-kv[1], kv[0]))
            samples, dropped = self._samples, self._dropped
        if limit is not None and limit >= 0:
            items = items[:limit] if limit else []
        return {
            "enabled": self.running,
            "hz": self.hz,
            "samples": samples,
            "dropped_stacks": dropped,
            "stacks": [[k, v] for k, v in items],
        }

    def clear(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._samples = 0
            self._dropped = 0


# ---------------------------------------------------------------------------
# Capacity accounting: device-memory headroom.


def record_device_memory() -> list:
    """Refresh `serving_hbm_bytes_in_use` / `serving_hbm_bytes_limit` from
    the CUDA caching allocator's per-device statistics; returns the
    per-device stat dicts ({device, in_use, limit, peak}) so
    `obs.device.refresh_device_memory` can derive the peak watermark,
    fragmentation, and pressure heartbeat from one allocator read:
    in_use = `allocated_bytes.all.current`, peak =
    `allocated_bytes.all.peak`, limit = the card's total memory. Devices
    are labelled `gpu:{i}`, the label JAX gives a CUDA device.

    A process that has not initialized CUDA reports nothing and never
    creates a context (the JAX package's guard is `"jax" not in
    sys.modules`): a scrape in a process that never used the card must not
    take it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        labels = {"device": f"gpu:{i}"}
        in_use = stats.get("allocated_bytes.all.current")
        limit = torch.cuda.get_device_properties(i).total_memory
        if in_use is not None:
            metrics.set("serving_hbm_bytes_in_use", float(in_use), labels)
        metrics.set("serving_hbm_bytes_limit", float(limit), labels)
        out.append({
            "device": labels["device"],
            "in_use": in_use,
            "limit": limit,
            "peak": stats.get("allocated_bytes.all.peak"),
        })
    return out


# Process-default sampler (one profile surface per process, like
# metrics.REGISTRY / trace.TRACER / flightrecorder.RECORDER).
PROFILER = StackSampler()
