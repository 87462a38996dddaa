"""Retained scrape rings: the port's copy of lws_tpu/obs/history.py, the
process's short-term memory served at `GET /debug/history`.

The `HistoryRing` turns instantaneous scrapes into bounded per-series time
series: it ingests a Prometheus exposition (the local registry render,
through `core/metrics.parse_exposition`) and appends one `(t, value)` point
per series into a retention-bounded ring. The JAX package computes its
burn rates and scale recommendations over these rings on the control
plane; a worker's ring is what that plane and `lws-tpu monitor` read back.

Semantics the ring guarantees:

  * **Counter resets never fabricate negative deltas.** Counters (and
    histogram `_bucket`/`_sum`/`_count` samples — cumulative by
    construction) are stored RESET-ADJUSTED: when a scraped raw value drops
    below its predecessor (worker restarted, counter restarted from 0),
    the series' offset absorbs the old total and the stored cumulative
    value keeps rising.
  * **Retired series stay retired.** A series the source stopped exposing
    (the SLO recorder's `clear_gauge` attainment retirement, a departed
    worker) simply stops receiving points: its `last_t` freezes, and once
    it falls out of the retention window it is dropped wholesale — it is
    never re-emitted as current.
  * **Bounded, like everything else.** Retention bounds every series'
    points (`LWS_TPU_HISTORY_RETENTION_S`); a per-ring series cap bounds
    cardinality the same way the registry caps label sets — new series past
    the cap are dropped and counted in `lws_history_series_dropped_total`.

The clock is injectable everywhere (`now=` monotonic seconds), so tests
drive time explicitly; production callers omit it. The module-level
HISTORY is the process default (one ring per process, like
metrics.REGISTRY and flightrecorder.RECORDER); `start_from_env()` runs a
sampling thread over the process registry at `LWS_TPU_HISTORY_INTERVAL_S`,
and the worker's /metrics also feeds the ring opportunistically per scrape
(`ingest_if_due`), so history accrues at scrape cadence even without the
thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Union

from lws_tpu_torch.core import metrics
from lws_tpu_torch.utils.common import env_float as _env_float

HISTORY_INTERVAL_ENV = "LWS_TPU_HISTORY_INTERVAL_S"
HISTORY_RETENTION_ENV = "LWS_TPU_HISTORY_RETENTION_S"
HISTORY_SOURCE_SERIES_ENV = "LWS_TPU_HISTORY_SOURCE_SERIES"

DEFAULT_INTERVAL_S = 5.0
DEFAULT_RETENTION_S = 900.0
DEFAULT_MAX_SERIES = 4096
# Per-SOURCE series budget (series whose labels carry `instance`): at 1,000
# instances the global cap alone would let the first few chatty workers own
# the whole ring and starve every later one; the per-source budget keeps
# admission fair. 0 disables.
DEFAULT_MAX_SERIES_PER_SOURCE = 256

# Sample-name suffixes that are cumulative by construction (histogram
# decompositions): they get the same reset adjustment as counters.
_CUMULATIVE_SUFFIXES = ("_bucket", "_sum", "_count")


class _Series:
    """One sample series' retained points. Counter-kind series store
    RESET-ADJUSTED cumulative values: `offset` absorbs every observed
    reset, so the stored sequence is monotone across source restarts."""

    __slots__ = ("kind", "points", "last_raw", "offset", "last_t")

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self.points: "deque[tuple[float, float]]" = deque()
        self.last_raw: Optional[float] = None
        self.offset = 0.0
        self.last_t: float = 0.0

    def append(self, t: float, raw: float) -> None:
        if self.kind == "counter":
            if self.last_raw is not None and raw < self.last_raw:
                # Reset: the source restarted and its counter began again
                # (near) zero. Fold the pre-restart total into the offset so
                # the adjusted series keeps rising — a rate over the
                # boundary sees `raw` new increments, never a negative step.
                self.offset += self.last_raw
            self.last_raw = raw
            value = raw + self.offset
        else:
            value = raw
        self.points.append((t, value))
        self.last_t = t

    def evict(self, cutoff: float) -> None:
        while self.points and self.points[0][0] < cutoff:
            self.points.popleft()


def _series_kind(sample_name: str, family_type: str) -> str:
    if family_type == "counter":
        return "counter"
    if family_type == "histogram" and sample_name.endswith(_CUMULATIVE_SUFFIXES):
        return "counter"
    return "gauge"


class HistoryRing:
    def __init__(
        self,
        interval_s: Optional[float] = None,
        retention_s: Optional[float] = None,
        max_series: int = DEFAULT_MAX_SERIES,
        metrics_registry=None,
        max_series_per_source: Optional[int] = None,
    ) -> None:
        """`interval_s` gates `ingest_if_due` and the sampling thread
        (env LWS_TPU_HISTORY_INTERVAL_S, default 5s; 0 disables the
        thread); `retention_s` bounds every series' points (env
        LWS_TPU_HISTORY_RETENTION_S, default 900s). `metrics_registry`
        receives the ring's own health counters (defaults to the process
        registry). `max_series_per_source` (env LWS_TPU_HISTORY_SOURCE_SERIES,
        default 256, 0 disables) additionally budgets series per scrape
        SOURCE — the `instance` label — so one chatty worker in a
        1,000-instance fleet view cannot claim the global cap for itself;
        budget refusals count under the same dropped-series counter."""
        self.interval_s = (
            interval_s if interval_s is not None
            else _env_float(HISTORY_INTERVAL_ENV, DEFAULT_INTERVAL_S)
        )
        self.retention_s = (
            retention_s if retention_s is not None
            else _env_float(HISTORY_RETENTION_ENV, DEFAULT_RETENTION_S)
        )
        self.max_series = max_series
        self.max_series_per_source = (
            max_series_per_source if max_series_per_source is not None
            else int(_env_float(HISTORY_SOURCE_SERIES_ENV,
                                DEFAULT_MAX_SERIES_PER_SOURCE))
        )
        self._own_metrics = metrics_registry
        self._lock = threading.Lock()
        # (sample_name, sorted label tuple) -> _Series
        self._series: dict[tuple[str, tuple], _Series] = {}  # guarded-by: _lock
        # instance label -> admitted series count (per-source budget ledger;
        # decremented when the retention sweep deletes a series).
        self._per_source: dict[str, int] = {}  # guarded-by: _lock
        self._last_ingest_t: Optional[float] = None  # guarded-by: _lock
        self._last_ingest_keys: set = set()  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- admission -------------------------------------------------------
    @staticmethod
    def _source_of(label_items: tuple) -> Optional[str]:
        for k, v in label_items:
            if k == "instance":
                return v
        return None

    def _admit_locked(self, key: tuple) -> bool:  # holds-lock: _lock
        """Global cap + per-source budget gate for a NEW series key; charges
        the source ledger on admission, counts the refusal otherwise."""
        if len(self._series) >= self.max_series:
            self._dropped += 1
            return False
        src = self._source_of(key[1])
        if src is not None and self.max_series_per_source > 0:
            if self._per_source.get(src, 0) >= self.max_series_per_source:
                self._dropped += 1
                return False
            self._per_source[src] = self._per_source.get(src, 0) + 1
        return True

    def _forget_locked(self, key: tuple) -> None:  # holds-lock: _lock
        """Release a deleted series' per-source budget slot."""
        src = self._source_of(key[1])
        if src is not None and src in self._per_source:
            n = self._per_source[src] - 1
            if n <= 0:
                del self._per_source[src]
            else:
                self._per_source[src] = n

    # ---- ingestion -------------------------------------------------------
    def _inc_own(self, name: str, value: float = 1.0) -> None:
        reg = self._own_metrics if self._own_metrics is not None else metrics.REGISTRY
        reg.inc(name, value=value)

    def ingest(self, text: str, now: Optional[float] = None) -> int:
        """Parse one exposition and append a point per sample series;
        returns the number of points appended. Malformed text raises
        ValueError (callers that scrape untrusted workers validate first,
        exactly like the fleet merger)."""
        if now is None:
            now = time.monotonic()
        families = metrics.parse_exposition(text)
        appended = 0
        cutoff = now - self.retention_s
        with self._lock:
            seen: set = set()
            for fam, data in families.items():
                ftype = data["type"]
                for name, labels, value, _ in data["samples"]:
                    key = (name, tuple(sorted(labels.items())))
                    series = self._series.get(key)
                    if series is None:
                        if not self._admit_locked(key):
                            continue
                        series = self._series[key] = _Series(
                            _series_kind(name, ftype)
                        )
                    series.append(now, value)
                    series.evict(cutoff)
                    seen.add(key)
                    appended += 1
            # Retention sweep over series the source stopped exposing: a
            # retired series keeps its tail until the tail ages out, then
            # disappears entirely — never resurrected as current.
            for key in [k for k, s in self._series.items()
                        if s.last_t < cutoff]:
                del self._series[key]
                self._forget_locked(key)
            self._last_ingest_t = now
            self._last_ingest_keys = seen
            dropped = self._dropped
            self._dropped = 0
        self._inc_own("lws_history_samples_total")
        if dropped:
            self._inc_own("lws_history_series_dropped_total", float(dropped))
        return appended

    def ingest_if_due(self, text: Union[str, Callable[[], str]],
                      now: Optional[float] = None) -> bool:
        """Opportunistic feed for the /metrics handlers: ingest only when a
        full sampling interval has passed since the last ingest, so scrape
        storms don't multiply ring churn. `text` may be a thunk (pay the
        render only when due)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            prev = self._last_ingest_t
            due = prev is None or now - prev >= self.interval_s
            if due:
                # Claim the interval slot ATOMICALLY with the check: two
                # concurrent scrape threads crossing the boundary together
                # must produce one ingest, not two near-identical points.
                self._last_ingest_t = now
        if not due:
            return False
        try:
            self.ingest(text() if callable(text) else text, now=now)
        except BaseException:
            # A failed render/fetch must not consume the slot: the next
            # caller inside the interval still owns a real sample, and
            # last_ingest_age must not report an ingest that never was.
            with self._lock:
                if self._last_ingest_t == now:
                    self._last_ingest_t = prev
            raise
        return True

    # ---- views -----------------------------------------------------------
    def window(self, name: str, labels: Optional[dict] = None,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> list:
        """The retained `(t, value)` points for one series (reset-adjusted
        for counters), newest last; bounded to the trailing `window_s` when
        given. Empty list for an unknown series."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            series = self._series.get(key)
            pts = list(series.points) if series is not None else []
        if window_s is not None:
            if now is None:
                now = time.monotonic()
            cutoff = now - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def series(self, name: Optional[str] = None,
               labels_subset: Optional[dict] = None) -> list:
        """[(sample_name, labels dict, kind, points, last_t)] for every
        retained series, optionally filtered by exact sample name and/or a
        label subset — the bulk accessor signals and renderers fold over."""
        wanted = tuple(sorted((labels_subset or {}).items()))
        out = []
        with self._lock:
            for (sname, slabels), s in self._series.items():
                if name is not None and sname != name:
                    continue
                if wanted and not all(item in slabels for item in wanted):
                    continue
                out.append((sname, dict(slabels), s.kind, list(s.points),
                            s.last_t))
        return out

    def last_ingest_age(self, now: Optional[float] = None) -> Optional[float]:
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._last_ingest_t is None:
                return None
            return max(0.0, now - self._last_ingest_t)

    def live_keys(self) -> set:
        """The series keys present in the most recent ingest — the set a
        consumer checks to tell a retired series (tail still retained,
        absent here) from a live one."""
        with self._lock:
            return set(self._last_ingest_keys)

    def snapshot(self, limit: Optional[int] = None,
                 max_points: int = 512) -> dict:
        """The GET /debug/history response body: every retained series with
        its points, JSON-shaped. `limit` bounds the series count (heaviest
        truncation is explicit in `truncated`); `max_points` bounds each
        series' point list to its newest entries."""
        with self._lock:
            items = sorted(self._series.items())
            total = len(items)
            if limit is not None:
                items = items[:limit] if limit else []
            live = self._last_ingest_keys
            series = [
                {
                    "name": name,
                    "labels": dict(labels),
                    "kind": s.kind,
                    "live": (name, labels) in live,
                    # The RAW counter state rides along so a ring seeded
                    # from this snapshot keeps detecting resets correctly
                    # (adjusted values alone would misread the next live
                    # raw sample as a reset after any prior restart).
                    "last_raw": s.last_raw,
                    "points": [[t, v] for t, v in list(s.points)[-max_points:]],
                }
                for (name, labels), s in items
            ]
            last_t = self._last_ingest_t
        return {
            "interval_s": self.interval_s,
            "retention_s": self.retention_s,
            "series_total": total,
            "truncated": total - len(series),
            "last_ingest_t": last_t,
            "series": series,
        }

    def load_snapshot(self, snap: dict, now: Optional[float] = None) -> int:
        """Seed this ring from another process's snapshot (the `lws-tpu
        top`/`monitor` client path: /debug/history hands over the server's
        retained points so the FIRST client frame already has rate
        history). Server timestamps are rebased onto this ring's clock —
        the newest server point lands at `now`, earlier points keep their
        relative spacing. Returns the number of points loaded."""
        if now is None:
            now = time.monotonic()
        series = snap.get("series") or []
        newest = max(
            (p[0] for s in series for p in (s.get("points") or [])),
            default=None,
        )
        if newest is None:
            return 0
        shift = now - newest
        loaded = 0
        with self._lock:
            for s in series:
                pts = s.get("points") or []
                if not pts:
                    continue
                key = (s["name"], tuple(sorted((s.get("labels") or {}).items())))
                if key in self._series:
                    continue  # local observations win over seeded history
                if not self._admit_locked(key):
                    continue
                dest = self._series[key] = _Series(s.get("kind", "gauge"))
                for t, v in pts:
                    # Seeded points are already reset-adjusted by the
                    # server ring; append raw to keep them as-is.
                    dest.points.append((t + shift, float(v)))
                dest.last_t = dest.points[-1][0]
                # Restore the RAW tracking state: last_raw is the server's
                # raw sample and offset the gap to the adjusted tail, so
                # the next LIVE ingest compares raw-to-raw — seeding with
                # the adjusted value would misread the first live sample
                # after any server-side reset as another reset and
                # fabricate an increase.
                adjusted_last = float(pts[-1][1])
                raw = s.get("last_raw")
                dest.last_raw = float(raw) if raw is not None else adjusted_last
                dest.offset = adjusted_last - dest.last_raw
                loaded += len(pts)
                if s.get("live"):
                    self._last_ingest_keys.add(key)
        return loaded

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._per_source.clear()
            self._last_ingest_t = None
            self._last_ingest_keys = set()

    # ---- threaded mode ---------------------------------------------------
    def start(self, source: Callable[[], str]) -> None:
        """Sample `source()` (an exposition render thunk) every
        `interval_s` on a daemon thread — the worker-process mode
        (`start_from_env`). The loop goes through the SAME `ingest_if_due`
        gate the /metrics scrape path uses, so thread and scrape co-feeding
        one ring yields one sample per interval, not near-duplicate pairs.
        A `source()` that raises skips that tick — a gap, not a phantom
        sample. Tests drive `ingest` directly instead."""
        if self._thread is not None or self.interval_s <= 0:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.ingest_if_due(source)
                except Exception:  # noqa: BLE001 — the sampler must outlive one bad render/fetch
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# Process-default ring (one short-term memory per process, like
# metrics.REGISTRY and flightrecorder.RECORDER).
HISTORY = HistoryRing()


def start_from_env() -> Optional[HistoryRing]:
    """Start the process ring's sampling thread over the process registry
    when LWS_TPU_HISTORY_INTERVAL_S doesn't disable it (0). Returns the
    ring while sampling, else None. The /metrics surfaces also feed the
    ring per scrape (`ingest_if_due`), so an un-threaded process still
    accrues history at scrape cadence."""
    if HISTORY.interval_s <= 0:
        return None
    HISTORY.start(lambda: metrics.REGISTRY.render())
    return HISTORY
