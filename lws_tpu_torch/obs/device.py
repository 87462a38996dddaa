"""Device-runtime observability: the port's copy of lws_tpu/obs/device.py
(compile ledger, HBM attribution, transfer accounting).

  * **Compile ledger** — the JAX package feeds it from `jax.monitoring`
    backend-compile events. The port has one kind of compile: the nvcc
    build of a CUDA source (`ops/_ext.py:build`), which calls
    `LEDGER.observe(seconds, executable=<source stem>)` once per source it
    compiles, on the calling thread. A library found by its hash is a
    cache hit and records nothing, as a persistent compile-cache hit
    records nothing in JAX. The first kernel call builds on the thread
    that made it, so a first-use build under an engine dispatch lands in
    that engine's ambient `compile_site(...)`, as a first-call XLA compile
    does. Each record is a bounded provenance entry {executable, compile
    seconds, triggering shape/bucket, engine + trace ctx}, published as
    `serving_compiles_total{engine,kind}` + `serving_compile_seconds`.
    `arm()` has no `jax.monitoring` to register with: it only (re)enables
    the ledger.
  * **HBM attribution** — `refresh_device_memory()`: per-device
    in-use/limit gauges (core/profile.py, from the CUDA caching
    allocator), the allocator peak watermark + fragmentation fraction, and
    per-pool accounting (`serving_hbm_pool_bytes{pool}`, pools = weights |
    kv | arena_restore | workspace) from bytes the engines register at
    allocation time; `workspace` is the residual of in-use the pools do
    not claim.
  * **Transfer accounting** — `record_transfer(site, nbytes)` /
    `transfer(site, nbytes)` count host<->device bytes and seconds at the
    engines' upload seams, labelled by site.

The ledger holds a `compile_storm:{executable}` heartbeat at depth>=1 with
pinned progress while one executable has recompiled >= N times inside the
window (one edge-triggered Watchdog alert + diagnostics dump per episode),
and `refresh_device_memory` holds `hbm_pressure:{device}` the same way
past the occupancy threshold. A compile made while a request is in flight
(under a `compile_site` that names its request id) annotates that
request's journey (obs/journey.py, `annotations.compiles`), so the
journey's verdict can blame compilation for a blown TTFT.

Importing this module creates no CUDA context, and neither does a refresh
in a process that never used the card.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Optional

from lws_tpu_torch.core import metrics, trace
from lws_tpu_torch.utils.common import env_float as _env_float

COMPILE_LEDGER_ENV = "LWS_TPU_COMPILE_LEDGER"      # 0 disables arming
STORM_N_ENV = "LWS_TPU_COMPILE_STORM_N"            # recompiles per window
STORM_WINDOW_ENV = "LWS_TPU_COMPILE_STORM_WINDOW_S"
HBM_PRESSURE_ENV = "LWS_TPU_HBM_PRESSURE"          # occupancy threshold

POOLS = ("weights", "kv", "arena_restore", "workspace")
# Pools that occupy HBM (subtracted from device in-use to derive the
# workspace residual). arena_restore is HOST-resident by construction — it
# rides the same gauge family for one capacity view but never subtracts
# from device memory.
DEVICE_RESIDENT_POOLS = ("weights", "kv")

# ---------------------------------------------------------------------------
# Ambient compile-site context: the engines declare WHERE a compile could
# fire (executable name, engine label, triggering shape/bucket, request id)
# around their dispatch seams; a kernel's first-use build runs
# synchronously on the calling thread, so a thread-local stack attributes
# the record.

_SITE = threading.local()


def _site_stack() -> list:
    stack = getattr(_SITE, "stack", None)
    if stack is None:
        stack = _SITE.stack = []
    return stack


@contextmanager
def compile_site(executable: str, engine: str = "", shape: str = "",
                 request_id: str = ""):
    """Declare the ambient compile provenance for the enclosed dispatch:
    any backend compile that fires inside the block is recorded against
    `executable` with this engine/shape/request attribution. Nesting wins
    innermost (a prefill site inside a request site names the prefill)."""
    stack = _site_stack()
    stack.append({"executable": executable, "engine": engine,
                  "shape": shape, "request_id": request_id})
    try:
        yield
    finally:
        stack.pop()


def current_site() -> Optional[dict]:
    stack = _site_stack()
    return stack[-1] if stack else None


# ---------------------------------------------------------------------------
# The compile ledger.


class CompileLedger:
    """Bounded provenance ring of compiles + per-executable counters and
    storm windows. `observe()` is BOTH the kernel build's feed and the
    deterministic injectable feed tests drive (same pattern as
    `StackSampler.sample_once(frames=...)`)."""

    def __init__(self, ring: int = 256, recorder=None,
                 storm_n: Optional[int] = None,
                 storm_window_s: Optional[float] = None,
                 max_request_annotations: int = 64) -> None:
        self._ring: "deque[dict]" = deque(maxlen=ring)  # guarded-by: _lock
        self._counts: dict[str, dict] = {}              # guarded-by: _lock
        self._recent: dict[str, deque] = {}             # guarded-by: _lock
        self._per_request: "dict[str, list]" = {}       # guarded-by: _lock
        self._request_order: "deque[str]" = deque()     # guarded-by: _lock
        self._max_request_annotations = max_request_annotations
        self._lock = threading.Lock()
        self._recorder = recorder
        self._armed = False
        self._enabled = True
        self._seq = 0
        self.storm_n = int(storm_n if storm_n is not None
                           else _env_float(STORM_N_ENV, 3.0))
        self.storm_window_s = (storm_window_s if storm_window_s is not None
                               else _env_float(STORM_WINDOW_ENV, 60.0))

    def _beat(self, name: str, depth: float, now: Optional[float]) -> None:
        # Pinned progress (always 0.0): the BacklogRule convention for
        # externally-evaluated conditions — depth>=1 with a non-advancing
        # progress counter fires once per episode; depth 0 clears it.
        recorder = self._recorder
        if recorder is None:
            from lws_tpu_torch.core import flightrecorder as frmod

            recorder = frmod.RECORDER
        recorder.beat(name, progress=0.0, depth=depth, now=now)

    # ---- the feed --------------------------------------------------------
    def observe(self, seconds: float, executable: Optional[str] = None,
                engine: Optional[str] = None, shape: Optional[str] = None,
                request_id: Optional[str] = None,
                now: Optional[float] = None,
                unix: Optional[float] = None) -> Optional[dict]:
        """Record one compile. Explicit kwargs override the ambient
        `compile_site` (the injectable test feed passes everything; the
        kernel build passes `seconds` and `executable`). `now` (monotonic)
        drives the storm window deterministically in tests; `unix` stamps
        the record. Returns the appended record (None while disabled)."""
        if not self._enabled:
            return None
        site = current_site() or {}
        name = executable if executable is not None else (
            site.get("executable") or "unattributed")
        eng = engine if engine is not None else (site.get("engine") or "-")
        shp = shape if shape is not None else (site.get("shape") or "")
        rid = request_id if request_id is not None else (
            site.get("request_id") or "")
        if now is None:
            now = time.monotonic()
        if unix is None:
            unix = time.time()
        ctx = trace.current_context()
        with self._lock:
            self._seq += 1
            counts = self._counts.setdefault(
                name, {"first": 0, "recompiles": 0, "seconds": 0.0,
                       "last_unix": 0.0})
            kind = "first" if counts["first"] == 0 else "recompile"
            counts[{"first": "first", "recompile": "recompiles"}[kind]] += 1
            counts["seconds"] += float(seconds)
            counts["last_unix"] = unix
            record = {
                "seq": self._seq,
                "unix": round(unix, 6),
                "executable": name,
                "kind": kind,
                "seconds": round(float(seconds), 6),
                "engine": eng,
                "shape": shp,
                "request_id": rid,
                "trace": ctx,
            }
            self._ring.append(record)
            # Storm window: in-window RECOMPILES of this executable. A
            # first compile never storms (every executable compiles once).
            recent = self._recent.setdefault(
                name, deque(maxlen=max(self.storm_n * 4, 16)))
            if kind == "recompile":
                recent.append(now)
            while recent and now - recent[0] > self.storm_window_s:
                recent.popleft()
            in_window = len(recent)
            if rid:
                entries = self._per_request.get(rid)
                if entries is None:
                    entries = self._per_request[rid] = []
                    self._request_order.append(rid)
                    while len(self._request_order) > self._max_request_annotations:
                        self._per_request.pop(self._request_order.popleft(),
                                              None)
                if len(entries) < 32:
                    entries.append({
                        "executable": name, "kind": kind,
                        "seconds": record["seconds"], "unix": record["unix"],
                        "shape": shp,
                    })
                annotation = list(entries)
            else:
                annotation = None
        metrics.inc("serving_compiles_total", {"engine": eng, "kind": kind})
        metrics.observe("serving_compile_seconds", float(seconds),
                        {"engine": eng})
        self._beat(f"compile_storm:{name}",
                   float(in_window) if in_window >= self.storm_n else 0.0,
                   now)
        if annotation is not None:
            # The compile rode a request-carrying site: annotate the owning
            # journey so its verdict can blame compilation for a blown TTFT.
            from lws_tpu_torch.obs import journey as journeymod

            journeymod.VAULT.annotate(rid, compiles=annotation)
        return record

    # ---- arming ------------------------------------------------------------
    def arm(self) -> bool:
        """Enable recording (idempotent). The JAX package registers a
        `jax.monitoring` listener here; the port's compiles reach
        `observe()` from the kernel build itself, so there is nothing to
        register."""
        self._armed = True
        self._enabled = True
        return True

    def disarm(self) -> None:
        """Stop recording."""
        self._enabled = False

    @property
    def armed(self) -> bool:
        return self._armed and self._enabled

    # ---- views -----------------------------------------------------------
    def records(self, limit: Optional[int] = None,
                executable: Optional[str] = None) -> list[dict]:
        """Ledger records oldest-first; `limit` keeps the newest N,
        `executable` narrows to one executable's window (what a
        compile_storm dump embeds)."""
        with self._lock:
            out = list(self._ring)
        if executable is not None:
            out = [r for r in out if r["executable"] == executable]
        if limit is not None and limit >= 0:
            out = out[-limit:] if limit else []
        return out

    def snapshot(self, limit: int = 256) -> dict:
        """The `GET /debug/compile` body of the JAX package's servers, in
        the same shape."""
        with self._lock:
            records = list(self._ring)
            executables = {
                name: {"first": c["first"], "recompiles": c["recompiles"],
                       "seconds": round(c["seconds"], 6),
                       "last_unix": round(c["last_unix"], 6)}
                for name, c in self._counts.items()
            }
            storms = {
                name: len(recent)
                for name, recent in self._recent.items()
                if len(recent) >= self.storm_n
            }
        if limit >= 0:
            records = records[-limit:] if limit else []
        return {
            "armed": self.armed,
            "storm_n": self.storm_n,
            "storm_window_s": self.storm_window_s,
            "records": records,
            "executables": executables,
            "storms": storms,
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._counts.clear()
            self._recent.clear()
            self._per_request.clear()
            self._request_order.clear()
            self._seq = 0


# Process-default ledger + conveniences (one ledger per process).
LEDGER = CompileLedger()


def arm_from_env() -> bool:
    """Arm the process-default ledger unless LWS_TPU_COMPILE_LEDGER=0."""
    if os.environ.get(COMPILE_LEDGER_ENV, "1").lower() in ("0", "false",
                                                           "off"):
        return False
    return LEDGER.arm()


def debug_compile(limit: int = 256) -> dict:
    return LEDGER.snapshot(limit)


# ---------------------------------------------------------------------------
# HBM attribution: per-pool accounting + fragmentation watermark, refreshed
# through ONE shared helper.

_POOL_LOCK = threading.Lock()
_POOL_BYTES: dict[str, float] = {}                    # guarded-by: _POOL_LOCK
_POOL_PROVIDERS: dict[str, Callable[[], float]] = {}  # guarded-by: _POOL_LOCK


def set_pool_bytes(pool: str, nbytes: float) -> None:
    """Push-style pool accounting: an engine reports the bytes a pool
    holds at (re)allocation time (weights at init, the paged KV pool at
    build, the host arena on spill/evict)."""
    with _POOL_LOCK:
        _POOL_BYTES[pool] = float(nbytes)


def register_pool_provider(pool: str, provider: Callable[[], float]) -> None:
    """Pull-style pool accounting: `provider()` is called per refresh (for
    pools whose size moves between scrapes, e.g. the restore arena)."""
    with _POOL_LOCK:
        _POOL_PROVIDERS[pool] = provider


def clear_pools() -> None:
    with _POOL_LOCK:
        _POOL_BYTES.clear()
        _POOL_PROVIDERS.clear()


def refresh_device_memory(stats: Optional[list] = None,
                          recorder=None, now: Optional[float] = None) -> int:
    """The single shared device-memory refresh (the worker telemetry
    server calls it per /metrics render, runtime/telemetry.py):

      * per-device in-use/limit gauges (core/profile.py);
      * `serving_hbm_peak_bytes{device}` — the allocator high-water mark —
        and `serving_hbm_fragmentation{device}` = (peak - live)/peak, the
        fraction of the watermark the allocator holds but nothing lives
        in (allocator-held headroom: a high value after a burst is memory
        the next admission can't necessarily get back contiguously);
      * `serving_hbm_pool_bytes{pool}` from the registered pools, with
        `workspace` computed as the residual (device in-use minus the
        attributed pools) when allocator stats exist;
      * the `hbm_pressure:{device}` heartbeat, held at depth>=1 with
        pinned progress while occupancy >= LWS_TPU_HBM_PRESSURE (0.92).

    `stats` injects deterministic per-device dicts ({device, in_use,
    limit, peak}) for tests — without it the live allocator is read.
    Returns the device count seen."""
    from lws_tpu_torch.core import profile as profmod

    if stats is None:
        stats = profmod.record_device_memory()
    else:
        for d in stats:
            labels = {"device": d["device"]}
            if d.get("in_use") is not None:
                metrics.set("serving_hbm_bytes_in_use", float(d["in_use"]),
                            labels)
            if d.get("limit") is not None:
                metrics.set("serving_hbm_bytes_limit", float(d["limit"]),
                            labels)
    threshold = _env_float(HBM_PRESSURE_ENV, 0.92)
    if recorder is None:
        from lws_tpu_torch.core import flightrecorder as frmod

        recorder = frmod.RECORDER
    total_in_use = 0.0
    have_in_use = False
    for d in stats:
        labels = {"device": d["device"]}
        in_use = d.get("in_use")
        limit = d.get("limit")
        peak = d.get("peak")
        if in_use is not None:
            total_in_use += float(in_use)
            have_in_use = True
        if peak is not None:
            metrics.set("serving_hbm_peak_bytes", float(peak), labels)
            if in_use is not None and peak > 0:
                metrics.set("serving_hbm_fragmentation",
                            max(0.0, (float(peak) - float(in_use))
                                / float(peak)),
                            labels)
        if in_use is not None and limit:
            occupancy = float(in_use) / float(limit)
            # Depth is occupancy over the threshold (>= 1.0 exactly when
            # the device is past LWS_TPU_HBM_PRESSURE), so the BacklogRule
            # depth_threshold=1.0 convention reads it directly. Pinned
            # progress: one edge-triggered alert + dump per episode.
            depth = occupancy / threshold if occupancy >= threshold else 0.0
            recorder.beat(f"hbm_pressure:{d['device']}", progress=0.0,
                          depth=depth, now=now)
    with _POOL_LOCK:
        pools = dict(_POOL_BYTES)
        for pool, provider in _POOL_PROVIDERS.items():
            try:
                pools[pool] = float(provider())
            except Exception:  # noqa: BLE001 — a broken pool provider must never fail a refresh
                continue
    attributed = 0.0
    for pool, nbytes in pools.items():
        metrics.set("serving_hbm_pool_bytes", float(nbytes), {"pool": pool})
        if pool in DEVICE_RESIDENT_POOLS:
            attributed += float(nbytes)
    if have_in_use:
        metrics.set("serving_hbm_pool_bytes",
                    max(0.0, total_in_use - attributed),
                    {"pool": "workspace"})
    return len(stats)


# ---------------------------------------------------------------------------
# Transfer accounting: host<->device bytes/seconds at the engines' upload
# and host-consume seams, labelled by site.


def record_transfer(site: str, nbytes: float, direction: str = "h2d",
                    seconds: Optional[float] = None) -> None:
    labels = {"site": site, "direction": direction}
    metrics.inc("serving_transfer_bytes_total", labels, float(nbytes))
    if seconds is not None:
        metrics.observe("serving_transfer_seconds", float(seconds), labels)


@contextmanager
def transfer(site: str, nbytes: float, direction: str = "h2d"):
    """Time a transfer block: counts bytes AND wall seconds (use at seams
    where the upload is synchronous enough for the wall time to mean
    something; fire-and-forget dispatch inputs use record_transfer)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_transfer(site, nbytes, direction,
                        seconds=time.perf_counter() - t0)
