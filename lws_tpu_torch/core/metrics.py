"""Metrics registry with valid Prometheus text exposition: the port's copy of
lws_tpu/core/metrics.py, trimmed to what the port's engines and telemetry
copies call (the registry, `render_exposition`, `parse_exposition`, the
process REGISTRY with `inc`/`set`/`observe`, exemplars, and the HELP text of
the names the port emits). Left out: the fleet merge (`merge_expositions`,
`StreamingMerger`) and the HTTP content negotiation, which serve the JAX
package's control plane.

Counters, gauges, and histograms, rendered with `# HELP` / `# TYPE` lines so
a real scraper parses the output. Label-set cardinality is capped per metric
name: past the cap, new label sets are dropped and counted under
`lws_metric_label_sets_dropped_total{metric}` so the loss is visible.

The module-level REGISTRY (+ `inc`/`observe`/`set` helpers) is the process
default the serving engines report into. It is a different object from the
JAX package's REGISTRY: in a process that runs both packages, each side
reads its own.
"""

from __future__ import annotations

import re
import threading
from collections import defaultdict
from dataclasses import dataclass, field

# Exposition help text, keyed by metric name; describe() adds entries. The
# text of every name is the JAX package's, byte for byte, so a scrape merged
# across JAX and port workers carries one HELP line per family.
_HELP: dict[str, str] = {}

# Per-name default histogram buckets (describe(..., buckets=...)): the one
# fixed ladder saturates for minute-scale rollout durations and lumps every
# sub-ms inter-token latency into its first bucket, so a metric whose range
# is known declares its own. Process-wide, like _HELP: bucket layout is a
# property of the name, not of any one registry (a fleet merge of two
# layouts for one family would be scraper-invalid).
_BUCKETS: dict[str, tuple] = {}

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

DROPPED_METRIC = "lws_metric_label_sets_dropped_total"


@dataclass
class _Histogram:
    buckets: tuple = DEFAULT_BUCKETS
    counts: list = field(default_factory=list)
    total: float = 0.0
    n: int = 0
    # bucket index -> (exemplar labels, observed value): the most recent
    # exemplar-carrying observation per bucket, rendered OpenMetrics-style
    # so an SLO-breach bucket links straight to its trace in /debug/traces.
    exemplars: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def observe(self, v: float, exemplar: dict | None = None) -> None:
        self.total += v
        self.n += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                if exemplar:
                    self.exemplars[i] = (exemplar, v)
                return
        self.counts[-1] += 1
        if exemplar:
            self.exemplars[len(self.buckets)] = (exemplar, v)


def describe(name: str, help_text: str, buckets: tuple | list | None = None) -> None:
    """Register the # HELP line for a metric name (process-wide: exposition
    text is a property of the name, not of any one registry). For a
    histogram, `buckets` overrides the DEFAULT_BUCKETS ladder for every
    series of this name created afterwards."""
    _HELP[name] = help_text
    if buckets is not None:
        _BUCKETS[name] = tuple(sorted(float(b) for b in buckets))


class MetricsRegistry:
    def __init__(self, max_label_sets: int = 512,
                 buckets: dict[str, tuple] | None = None) -> None:
        """`max_label_sets` caps DISTINCT label sets per metric name; samples
        for label sets past the cap are dropped and counted (see module
        docstring) instead of growing the registry unboundedly. `buckets`
        maps metric names to per-registry histogram ladders, overriding both
        the describe()-declared and the default buckets."""
        self._lock = threading.Lock()
        self._max_label_sets = max_label_sets
        self._bucket_overrides: dict[str, tuple] = {  # guarded-by: _lock
            name: tuple(sorted(float(x) for x in bs))
            for name, bs in (buckets or {}).items()
        }
        # Inner dicts used as ordered sets (the module-level `set` gauge
        # helper shadows the builtin in this namespace).
        self._label_sets: dict[str, dict] = defaultdict(dict)  # guarded-by: _lock
        self._counters: dict[tuple[str, tuple], float] = defaultdict(float)  # guarded-by: _lock
        self._gauges: dict[tuple[str, tuple], float] = {}  # guarded-by: _lock
        self._histograms: dict[tuple[str, tuple], _Histogram] = {}  # guarded-by: _lock

    def set_buckets(self, name: str, buckets: tuple | list) -> None:
        """Override the bucket ladder for NEW series of `name` in this
        registry (existing series keep the layout they were created with —
        re-bucketing live counts would fabricate history)."""
        with self._lock:
            self._bucket_overrides[name] = tuple(sorted(float(b) for b in buckets))

    def _buckets_for(self, name: str) -> tuple:  # holds-lock: _lock
        return self._bucket_overrides.get(name) or _BUCKETS.get(name) or DEFAULT_BUCKETS

    def _admit(self, name: str, labels: tuple) -> bool:  # holds-lock: _lock
        """Cardinality gate (caller holds the lock). Known label sets always
        pass; new ones pass while the per-name cap has room."""
        seen = self._label_sets[name]
        if labels in seen:
            return True
        if len(seen) >= self._max_label_sets:
            key = (DROPPED_METRIC, (("metric", name),))
            self._counters[key] += 1.0
            return False
        seen[labels] = None
        return True

    def inc(self, name: str, labels: dict[str, str] | None = None, value: float = 1.0) -> None:
        with self._lock:
            lk = _lk(labels)
            if self._admit(name, lk):
                self._counters[(name, lk)] += value

    def observe(self, name: str, value: float, labels: dict[str, str] | None = None,
                exemplar: dict[str, str] | None = None) -> None:
        """`exemplar` (e.g. {"trace_id": ..., "span_id": ...}) rides the
        sample's bucket into the exposition OpenMetrics-style, so a breach
        bucket resolves straight to its trace in /debug/traces."""
        with self._lock:
            lk = _lk(labels)
            if not self._admit(name, lk):
                return
            key = (name, lk)
            if key not in self._histograms:
                self._histograms[key] = _Histogram(buckets=self._buckets_for(name))
            self._histograms[key].observe(value, exemplar)

    def set(self, name: str, value: float, labels: dict[str, str] | None = None) -> None:
        """Gauge write (last value wins): rollout progress, active slots,
        free blocks — state, not accumulation."""
        with self._lock:
            lk = _lk(labels)
            if self._admit(name, lk):
                self._gauges[(name, lk)] = float(value)

    def clear_gauge(self, name: str, labels_subset: dict[str, str],
                    exact: bool = False) -> None:
        """Drop every gauge series of `name` whose labels contain
        `labels_subset`, freeing their cardinality slots. Gauge series keyed
        by a churning label (rollout revisions) must retire when superseded
        — otherwise stale series report forever and eventually exhaust the
        label-set cap for live ones. With `exact`, only the series whose
        label set EQUALS `labels_subset` retires — the caller that wants to
        drop `{engine}` without taking every `{engine, klass}` sibling with
        it (core/slo.py refresh)."""
        wanted = tuple(sorted(labels_subset.items()))
        with self._lock:
            doomed = [
                key for key in self._gauges
                if key[0] == name and (
                    key[1] == wanted if exact
                    else all(item in key[1] for item in wanted)
                )
            ]
            seen = self._label_sets.get(name)
            for key in doomed:
                del self._gauges[key]
                if seen is not None:
                    seen.pop(key[1], None)

    def counter_value(self, name: str, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self._counters.get((name, _lk(labels)), 0.0)

    def gauge_value(self, name: str, labels: dict[str, str] | None = None) -> float | None:
        with self._lock:
            return self._gauges.get((name, _lk(labels)))

    def _families(self) -> dict[str, tuple[str, list[str]]]:
        """name -> (type, sample lines). The exposition building block —
        render() and render_exposition() both go through here so merged
        output keeps one HELP/TYPE block per family."""
        fams: dict[str, tuple[str, list[str]]] = {}
        with self._lock:
            for (name, labels), value in sorted(self._counters.items()):
                fams.setdefault(name, ("counter", []))[1].append(
                    f"{name}{_fmt(labels)} {value}"
                )
            for (name, labels), value in sorted(self._gauges.items()):
                fams.setdefault(name, ("gauge", []))[1].append(
                    f"{name}{_fmt(labels)} {value}"
                )
            for (name, labels), h in sorted(self._histograms.items()):
                out = fams.setdefault(name, ("histogram", []))[1]
                cum = 0
                for i, (b, c) in enumerate(zip(h.buckets, h.counts)):
                    cum += c
                    out.append(
                        f'{name}_bucket{_fmt(labels, le=str(b))} {cum}'
                        f'{_fmt_exemplar(h.exemplars.get(i))}'
                    )
                out.append(
                    f'{name}_bucket{_fmt(labels, le="+Inf")} {h.n}'
                    f'{_fmt_exemplar(h.exemplars.get(len(h.buckets)))}'
                )
                out.append(f"{name}_sum{_fmt(labels)} {h.total}")
                out.append(f"{name}_count{_fmt(labels)} {h.n}")
        return fams

    def render(self) -> str:
        """Prometheus text exposition format: one # HELP + # TYPE block per
        metric family, samples grouped under it — parser-valid for a real
        scrape."""
        return render_exposition(self)


def render_exposition(*registries: "MetricsRegistry") -> str:
    """Merge registries into ONE valid exposition (the API server serves
    its control-plane registry plus the process-default serving REGISTRY):
    a family appearing in several registries renders one HELP/TYPE block
    with all samples under it — duplicate TYPE lines would be invalid."""
    merged: dict[str, tuple[str, list[str]]] = {}
    for reg in registries:
        for name, (ftype, samples) in reg._families().items():
            if name in merged:
                merged[name][1].extend(samples)
            else:
                merged[name] = (ftype, list(samples))
    lines: list[str] = []
    for name in sorted(merged):
        ftype, samples = merged[name]
        lines.append(f"# HELP {name} {_HELP.get(name, name)}")
        lines.append(f"# TYPE {name} {ftype}")
        lines.extend(samples)
    return "\n".join(lines) + "\n"


def _lk(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _fmt(labels: tuple, le: str | None = None) -> str:
    items = list(labels)
    if le is not None:
        items.append(("le", le))
    if not items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + inner + "}"


def _fmt_exemplar(entry: tuple | None) -> str:
    """OpenMetrics exemplar suffix for a bucket line: ` # {labels} value`.
    OpenMetrics scrapers resolve the trace_id to a trace backend."""
    if not entry:
        return ""
    labels, value = entry
    return f" # {_fmt(_lk(labels))} {value}"


# ---------------------------------------------------------------------------
# Exposition text parsing.

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ #]+)"
    r"(?P<exemplar> # \{[^}]*\} \S+)?$"
)


def parse_exposition_lines(lines):
    """Incremental twin of parse_exposition: consume exposition lines one at
    a time and yield parse events without materializing a families dict.

    Events:
      ("help", family, help_text)
      ("type", family, type)
      ("sample", family, sample_name, labels_dict, value, exemplar_suffix)

    Grammar and leniency match parse_exposition exactly (same sample regex,
    same _bucket/_sum/_count folding against family names seen so far, other
    comment lines skipped); a malformed sample line raises ValueError at the
    line that fails."""
    seen: dict[str, None] = {}
    for line in lines:
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, name, help_text = line.split(" ", 3)
            seen.setdefault(name)
            yield ("help", name, help_text)
            continue
        if line.startswith("# TYPE "):
            _, _, name, ftype = line.split(" ", 3)
            seen.setdefault(name)
            yield ("type", name, ftype)
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed sample line: {line!r}")
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in seen:
                base = base[: -len(suffix)]
                break
        seen.setdefault(base)
        labels = {}
        for kv in (m.group("labels") or "").split(","):
            if kv:
                k, _, v = kv.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        yield ("sample", base, name, labels, float(m.group("value")),
               m.group("exemplar") or "")


def parse_exposition(text: str) -> dict:
    """Prometheus text -> {family: {"type": t, "help": h, "samples":
    [(sample_name, labels_dict, value, exemplar_suffix)]}}. Built on
    parse_exposition_lines so the batch and streaming parsers cannot
    drift."""
    families: dict = {}
    for ev in parse_exposition_lines(text.strip().split("\n")):
        fam = ev[1]
        slot = families.setdefault(fam, {"type": "untyped", "help": "", "samples": []})
        if ev[0] == "help":
            slot["help"] = ev[2]
        elif ev[0] == "type":
            slot["type"] = ev[2]
        else:
            slot["samples"].append((ev[2], ev[3], ev[4], ev[5]))
    return families


# Process-default registry + conveniences: the port's serving data plane
# reports here.
REGISTRY = MetricsRegistry()


def inc(name: str, labels: dict[str, str] | None = None, value: float = 1.0) -> None:
    REGISTRY.inc(name, labels, value)


def observe(name: str, value: float, labels: dict[str, str] | None = None,
            exemplar: dict[str, str] | None = None) -> None:
    REGISTRY.observe(name, value, labels, exemplar=exemplar)


def set(name: str, value: float, labels: dict[str, str] | None = None) -> None:  # noqa: A001 — mirrors the registry method
    REGISTRY.set(name, value, labels)


# Literal name (== DROPPED_METRIC).
describe("lws_metric_label_sets_dropped_total",
         "Samples dropped by the per-metric label-set cardinality cap")
describe("serving_requests_total", "Requests admitted per engine")
describe("serving_admission_duration_seconds", "Admission (prefill-to-slot) latency per engine")
describe("serving_decode_dispatch_duration_seconds", "Decode dispatch latency per engine")
describe("serving_spec_verify_duration_seconds", "Speculative verify dispatch latency")
describe("serving_spec_tokens_total",
         "Speculative draft tokens verified (kind=drafted) vs model-accepted (kind=accepted), per engine")
describe("serving_active_slots", "Active decode slots per engine")
describe("serving_inflight_dispatches", "Dispatched-but-unconsumed decode chunks in the engine's pipeline ring")
describe("serving_host_blocked_seconds", "Seconds the serving loop spent on host-side scheduling with no device work in flight")
# --- per-request SLO telemetry (core/slo.py) -------------------------------
# Declared bucket ladders are the whole point of describe(..., buckets=...):
# ITL distributions live sub-millisecond, queue waits can hit minutes.
describe(
    "serving_queue_wait_seconds",
    "Time a request waited between arrival and admission, per engine",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 120.0),
)
describe(
    "serving_ttft_seconds",
    "Time to first token per engine (queue wait + prefill)",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
)
describe(
    "serving_itl_seconds",
    "Inter-token latency per engine (per-dispatch mean of the step gaps)",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1, 0.25, 1.0),
)
describe(
    "serving_slo_attainment",
    "Fraction of the trailing request window meeting every SLO target, per engine (and per workload class when klass labels ride)",
)
describe(
    "serving_slo_window_age_seconds",
    "Seconds since the newest entry in the attainment window — discount (or ignore) attainment from a window that stopped filling",
)
# --- goodput ledger (core/slo.py; consumed by loadgen/) --------------------
describe(
    "serving_tokens_total",
    "Tokens delivered to requests (first token + decode chunks), per engine and workload class",
)
describe(
    "serving_goodput_tokens_total",
    "Tokens delivered WITHIN their per-token deadline (ttft target + (i-1) x itl target) — goodput/total is the fraction of throughput that met its SLO",
)
# --- stall watchdogs + flight recorder (core/flightrecorder.py) ------------
describe("lws_watchdog_alerts_total", "Watchdog alert transitions (inactive -> firing)")
describe("lws_watchdog_active", "1 while the named watchdog alert is firing, else 0")
describe("lws_flightrecorder_events_total", "Structured events appended to the flight-recorder ring")
# --- continuous profiling + capacity accounting (core/profile.py) ----------
describe("lws_profile_samples_total", "Thread samples folded into the collapsed-stack table by the wall-clock sampler")
describe("lws_profile_stacks_dropped_total", "Samples whose NOVEL stack was dropped by the bounded collapsed-stack table")
describe("serving_hbm_bytes_in_use", "Device memory in use per local device (jax allocator stats; absent on CPU)")
describe("serving_hbm_bytes_limit", "Device memory capacity per local device (jax allocator stats; absent on CPU)")
describe("serving_kv_pool_blocks", "Paged KV pool blocks by state (free / live / parked) — states sum to the pool size minus the null block")
describe("serving_prefix_cache_hits_total", "Prefix-cache block lookups served without recompute, per tier (hbm = resident pool block, host = restored from the spill arena, remote = fetched from a sibling over the KV wire); tokens skipped = hits x block_size")
describe("serving_prefix_cache_misses_total", "Shareable prompt blocks that had to be prefilled (no cached prefix in any tier)")
describe("serving_prefix_cache_evictions_total", "LRU-parked prefix blocks evicted to satisfy new allocations")
# --- hierarchical prefix cache: host spill tier (serving/kv_host_arena.py) -
describe("serving_kv_spill_bytes_total",
         "Prefix-block bytes crossing the HBM/host boundary: direction=spill "
         "(evicted block packed into the host arena) vs direction=restore "
         "(arena or remote bytes uploaded back into a pool block)")
describe("serving_kv_host_arena_bytes",
         "Bytes resident in the host-RAM prefix spill arena (bounded by "
         "LWS_TPU_KV_HOST_ARENA_MB)")
describe("serving_kv_host_arena_entries",
         "Spilled prefix blocks resident in the host arena")
# --- fault injection (core/faults.py) --------------------------------------
describe("lws_fault_trips_total", "Injected-fault firings per fault point and mode (chaos runs only; zero in production)")
describe("lws_fault_points_armed", "Fault points currently armed in this process")
# --- device-runtime observability (obs/device.py) ---------------------------
describe("serving_compiles_total",
         "Backend (XLA) compiles recorded by the compile ledger, per engine and kind — kind=first is the expected warm-up compile per executable, kind=recompile is a shape/bucket miss paying compile time on the serving path")
describe("serving_compile_seconds",
         "Wall seconds one backend compile took (jax.monitoring backend_compile_duration), per engine — the tail IS the TTFT cliff a recompiling request sees",
         buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
describe("serving_hbm_pool_bytes",
         "Device memory attributed per pool (weights / kv / arena_restore / workspace) — workspace is the allocator residual nothing else claims; pools vs serving_hbm_bytes_limit is the admission headroom answer")
describe("serving_hbm_peak_bytes",
         "Allocator high-water mark per device (peak_bytes_in_use) — the burst footprint capacity planning must fit, not the steady state")
describe("serving_hbm_fragmentation",
         "Allocator-held headroom fraction per device: (peak - live)/peak — memory the allocator touched but nothing lives in; high after a burst means the next admission may not get it back contiguously")
describe("serving_transfer_bytes_total",
         "Host<->device bytes crossing the PCIe/ICI boundary per call site and direction (h2d/d2h) — the serial fraction that caps pod-scale throughput")
describe("serving_transfer_seconds",
         "Wall seconds of one synchronous host<->device transfer per site and direction",
         buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0))
