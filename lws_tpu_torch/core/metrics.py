"""Metrics registry with valid Prometheus text exposition
(≈ controller-runtime's metrics server; SURVEY §5 adds reconcile latency
metrics as the one custom signal worth having).

Counters, gauges, and histograms, rendered with `# HELP` / `# TYPE` lines so
a real scraper parses the output (not just grep-able text). Label-set
cardinality is capped per metric name (replica-indexed labels at 512-group
scale would otherwise grow the registry without bound): past the cap, new
label sets are dropped and counted under
`lws_metric_label_sets_dropped_total{metric}` so the loss is visible.

The module-level REGISTRY (+ `inc`/`observe`/`set` helpers) is the process
default the serving engines report into — a worker process has exactly one
metrics surface, like the process-global trace.TRACER. The control plane
builds its own per-instance MetricsRegistry.

The port's copy of lws_tpu/core/metrics.py, whole: the registry, the
exposition parser, exemplars and content negotiation, and the fleet merge
(`merge_expositions`, `StreamingMerger`) behind the fleet collector's
/metrics/fleet, which labels every worker's series with `instance`
(and `role`/`revision` where the pod carries them) and adds the
collector's own `lws_fleet_*` families: `lws_fleet_instances{state}`,
`lws_fleet_scrape_errors_total{instance}`,
`lws_fleet_scrape_skipped_total{instance}`,
`lws_fleet_shard_scrape_seconds{shard}` and
`lws_fleet_shards_dropped_total`. The HELP text of every name is the JAX
package's, byte for byte, so a scrape merged across JAX and port workers
carries one HELP line per family. The process REGISTRY is a different
object from the JAX package's: in a process that runs both packages, each
side reads its own.
"""

from __future__ import annotations

import re
import threading
from collections import defaultdict
from dataclasses import dataclass, field

# Exposition help text, keyed by metric name; describe() adds entries, and
# names double as the docs-catalogue source of truth
# (tools/check_metrics_catalogue.py cross-checks docs/observability.md).
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
        scrape (validated by tests/test_dns_metrics.py's minimal parser)."""
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
    OpenMetrics scrapers resolve the trace_id to a trace backend; servers
    strip the suffix for classic text-format clients (strip_exemplars) —
    the classic 0.0.4 format has no exemplar syntax."""
    if not entry:
        return ""
    labels, value = entry
    return f" # {_fmt(_lk(labels))} {value}"


OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_EXEMPLAR_SUFFIX_RE = re.compile(r" # \{[^}]*\} \S+$", re.MULTILINE)


def wants_openmetrics(accept: str | None) -> bool:
    """Content negotiation for the /metrics surfaces: exemplars ride only
    when the client asked for OpenMetrics (a classic Prometheus text parser
    rejects a sample line with an exemplar suffix)."""
    return bool(accept and "openmetrics" in accept)


def strip_exemplars(text: str) -> str:
    return _EXEMPLAR_SUFFIX_RE.sub("", text)


def negotiate_exposition(text: str, accept: str | None) -> tuple[str, str]:
    """(body, content_type) for a /metrics response — the ONE negotiation
    rule every serving surface (worker telemetry, API server, fleet view)
    applies: OpenMetrics clients get exemplar suffixes and the mandatory
    `# EOF` terminator; classic clients get the suffixes stripped (the
    0.0.4 text format has no exemplar syntax)."""
    if wants_openmetrics(accept):
        if not text.endswith("\n"):
            text += "\n"
        return text + "# EOF\n", OPENMETRICS_CONTENT_TYPE
    return strip_exemplars(text), "text/plain"


# ---------------------------------------------------------------------------
# Exposition text parsing + fleet merging: the control plane scrapes each
# worker's /metrics and serves ONE fleet view (/metrics/fleet) with
# per-instance labels injected — see runtime/fleet.py.

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ #]+)"
    r"(?P<exemplar> # \{[^}]*\} \S+)?$"
)


def parse_exposition_lines(lines):
    """Incremental twin of parse_exposition: consume exposition lines one at
    a time and yield parse events without materializing a families dict —
    the building block StreamingMerger uses to merge shard expositions with
    peak memory bounded by one family of one source, not the whole fleet.

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
    [(sample_name, labels_dict, value, exemplar_suffix)]}}. Lenient enough
    for production use (the fleet merger and `lws-tpu top` consume scraped
    worker output); tests/test_dns_metrics.py keeps the strict
    scraper-semantics validator. Built on parse_exposition_lines so the
    batch and streaming parsers cannot drift."""
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


def merge_expositions(
    sources: list[tuple[dict, str]], max_label_sets: int | None = 512
) -> str:
    """Merge scraped expositions into ONE valid fleet view: `sources` is
    [(extra_labels, exposition_text)] — each instance's samples get its
    extra labels (instance/role/revision) injected, families dedup to one
    HELP/TYPE block, and the same per-family label-set cardinality cap as a
    registry applies (drops counted under the usual dropped-sample metric,
    labeled with the offending family). Exemplar suffixes survive the merge
    verbatim. The drop-accounting family renders LAST (not at its sorted
    position): a single-pass streaming merge cannot know the drop counts of
    families sorted after it, and StreamingMerger's output is contractually
    byte-identical to this function's."""
    merged: dict[str, dict] = {}
    dropped: dict[str, int] = {}
    # Inner dicts as ordered sets (the module-level `set` gauge helper
    # shadows the builtin here, same trick as MetricsRegistry._label_sets).
    seen_sets: dict[str, dict] = defaultdict(dict)
    for extra, text in sources:
        for fam, data in parse_exposition(text).items():
            slot = merged.setdefault(
                fam, {"type": data["type"], "help": data["help"], "lines": []}
            )
            if slot["type"] == "untyped" and data["type"] != "untyped":
                slot["type"] = data["type"]
            if not slot["help"]:
                slot["help"] = data["help"]
            for name, labels, value, exemplar in data["samples"]:
                labels = {**labels, **extra}
                if max_label_sets is not None:  # None: uncapped root merge
                    key = _lk({k: v for k, v in labels.items() if k != "le"})
                    sets = seen_sets[fam]
                    if key not in sets:
                        if len(sets) >= max_label_sets:
                            dropped[fam] = dropped.get(fam, 0) + 1
                            continue
                        sets[key] = None
                slot["lines"].append(f"{name}{_fmt(_lk(labels))} {value}{exemplar}")
    if dropped:
        slot = merged.setdefault(
            DROPPED_METRIC,
            {"type": "counter", "help": _HELP.get(DROPPED_METRIC, DROPPED_METRIC),
             "lines": []},
        )
        for fam, n in sorted(dropped.items()):
            slot["lines"].append(
                f'{DROPPED_METRIC}{_fmt(_lk({"metric": fam, "scope": "fleet"}))} {float(n)}'
            )
    lines: list[str] = []
    fams = sorted(merged)
    if DROPPED_METRIC in merged:  # drop accounting renders last (see docstring)
        fams.remove(DROPPED_METRIC)
        fams.append(DROPPED_METRIC)
    for fam in fams:
        slot = merged[fam]
        ftype = slot["type"] if slot["type"] != "untyped" else "gauge"
        lines.append(f"# HELP {fam} {slot['help'] or _HELP.get(fam, fam)}")
        lines.append(f"# TYPE {fam} {ftype}")
        lines.extend(slot["lines"])
    return "\n".join(lines) + "\n"


def _iter_exposition_lines(text: str):
    """Yield exactly the sequence ``text.strip().split("\\n")`` yields,
    WITHOUT materializing every line object up front: a 1,000-instance
    fleet render walks megabytes of shard text per pass, and the split
    lists (one str object per line, for every source at once) would cost
    more than the dict-based oracle — the streaming bound lives here."""
    start, end = 0, len(text)
    while start < end and text[start].isspace():
        start += 1
    while end > start and text[end - 1].isspace():
        end -= 1
    pos = start
    while True:
        nl = text.find("\n", pos, end)
        if nl < 0:
            yield text[pos:end]
            return
        yield text[pos:nl]
        pos = nl + 1


class _FamilyCursor:
    """One source's exposition as a cursor over per-family event runs.
    `fam`/`ftype`/`help` describe the current family; `drain()` yields its
    samples ONE at a time (folding HELP/TYPE into the cursor as they pass),
    and `advance()` positions at the next family once drained — so live
    parsed state never exceeds one sample per source. Enforces the streaming
    contract — families contiguous and sorted — which every producer in this
    codebase satisfies (registry renders and merge_expositions output both
    sort families)."""

    __slots__ = ("extra", "fam", "ftype", "help", "_events", "_pending",
                 "_prev")

    def __init__(self, extra: dict, lines) -> None:
        self.extra = extra
        self._events = parse_exposition_lines(lines)
        self._pending = next(self._events, None)
        self._prev: str | None = None
        self.fam: str | None = None
        self.advance()

    def advance(self) -> None:
        """Enter the family of the pending event (drain() must have been
        exhausted first, or the remainder of the old family is skipped)."""
        ev = self._pending
        if ev is None:
            self.fam = None
            return
        fam = ev[1]
        # The drop-accounting family is exempt from the ordering contract:
        # merge_expositions output (i.e. every shard text) renders it LAST,
        # while a plain registry render has it at its sorted position.
        if fam != DROPPED_METRIC:
            if self._prev is not None and fam <= self._prev:
                raise ValueError(
                    f"source families not contiguous+sorted: {fam!r} after {self._prev!r}"
                )
            self._prev = fam
        self.fam, self.ftype, self.help = fam, "untyped", ""

    def drain(self):
        """Yield (name, labels, value, exemplar) for the current family's
        samples; on return, `ftype`/`help` hold the family's folded
        metadata and the pending event is the next family's first."""
        fam = self.fam
        ev = self._pending
        while ev is not None and ev[1] == fam:
            if ev[0] == "help":
                self.help = ev[2]
            elif ev[0] == "type":
                self.ftype = ev[2]
            else:
                yield (ev[2], ev[3], ev[4], ev[5])
            ev = next(self._events, None)
        self._pending = ev


def _wellformed(lines) -> bool:
    """Regex-only pre-validation scan (O(1) memory) for drop_malformed: True
    iff every sample line parses and the family sequence is contiguous and
    sorted, i.e. a _FamilyCursor would traverse the source without raising."""
    cur = None
    prev_ordered = None
    try:
        for ev in parse_exposition_lines(lines):
            fam = ev[1]
            if fam != cur:
                if fam != DROPPED_METRIC:  # exempt, same as _FamilyCursor
                    if prev_ordered is not None and fam <= prev_ordered:
                        return False
                    prev_ordered = fam
                cur = fam
    except ValueError:
        return False
    return True


class StreamingMerger:
    """Streaming twin of merge_expositions: a k-way per-family merge over
    shard expositions that yields exposition text chunk by chunk, so
    /metrics/fleet can write the fleet view to the wire without ever holding
    it in one string — peak merge memory is O(largest shard), not O(fleet).

    Byte identity: ``"".join(StreamingMerger(max_label_sets=n).merge(srcs))``
    equals ``merge_expositions(srcs, max_label_sets=n)`` — same label
    injection, HELP/TYPE dedup (first non-untyped type, first non-empty help,
    in source order), per-family cardinality cap with drops counted under
    the scope="fleet" drop lines, and the drop-accounting family last.
    tests/test_streaming_merge.py pins the equivalence property.

    With ``max_label_sets=None`` the merge is uncapped and keeps NO
    fleet-wide seen-label-set state — the configuration the fleet server
    streams with (per-shard merges are already capped upstream; a root cap
    would need O(total label sets) memory and void the streaming bound).

    Sources must have families contiguous and sorted (true of every registry
    render and merge_expositions output). A violating or malformed source
    raises ValueError mid-stream — or, with ``drop_malformed=True``, is
    pre-validated with a cheap second scan and dropped whole (its index
    recorded in ``dropped_sources``) so one bad shard never poisons the
    fleet view."""

    def __init__(self, max_label_sets: int | None = None,
                 drop_malformed: bool = False) -> None:
        self.max_label_sets = max_label_sets
        self.drop_malformed = drop_malformed
        self.dropped_sources: list[int] = []

    def merge(self, sources: list[tuple[dict, str]]):
        """Yield exposition chunks (one per family block). `sources` is
        [(extra_labels, exposition_text)], same shape as merge_expositions."""
        self.dropped_sources = []
        cursors: list[_FamilyCursor] = []
        for i, (extra, text) in enumerate(sources):
            # Fresh lazy line iterators for each pass: the validation scan
            # consumes one, the cursor walks another — never a split list.
            if self.drop_malformed and not _wellformed(
                    _iter_exposition_lines(text)):
                self.dropped_sources.append(i)
                continue
            cursors.append(_FamilyCursor(extra, _iter_exposition_lines(text)))
        # Inner dicts as ordered sets, same shadowed-builtin trick as above.
        seen_sets: dict[str, dict] = defaultdict(dict)
        dropped: dict[str, int] = {}
        # Deferred drop-accounting records, (cursor_index, extra, type, help,
        # samples): sources reach the family at different walk times, but the
        # oracle admits + renders its lines in SOURCE order, so admission is
        # replayed index-ordered at the end.
        trail: list[tuple] = []
        emitted = False
        while True:
            for ci, c in enumerate(cursors):
                while c.fam == DROPPED_METRIC:
                    samples = list(c.drain())  # tiny: drop-counter lines
                    trail.append((ci, c.extra, c.ftype, c.help, samples))
                    c.advance()
            live = [c.fam for c in cursors if c.fam is not None]
            if not live:
                break
            fam = min(live)
            ftype, fhelp, out = "untyped", "", []
            for c in cursors:
                if c.fam != fam:
                    continue
                # drain() folds HELP/TYPE as a side effect, so the block
                # metadata is read AFTER the samples stream through — same
                # first-non-untyped/first-non-empty source-order fold as
                # the oracle (metadata only renders in the block header).
                for name, labels, value, exemplar in c.drain():
                    labels = {**labels, **c.extra}
                    if self.max_label_sets is not None:
                        key = _lk({k: v for k, v in labels.items() if k != "le"})
                        sets = seen_sets[fam]
                        if key not in sets:
                            if len(sets) >= self.max_label_sets:
                                dropped[fam] = dropped.get(fam, 0) + 1
                                continue
                            sets[key] = None
                    out.append(f"{name}{_fmt(_lk(labels))} {value}{exemplar}")
                if ftype == "untyped" and c.ftype != "untyped":
                    ftype = c.ftype
                if not fhelp:
                    fhelp = c.help
                c.advance()
            emitted = True
            yield self._block(fam, ftype, fhelp, out)
        ttype, thelp, tlines = "untyped", "", []
        for _, extra, ftype, fhelp, samples in sorted(trail, key=lambda t: t[0]):
            if ttype == "untyped" and ftype != "untyped":
                ttype = ftype
            if not thelp:
                thelp = fhelp
            for name, labels, value, exemplar in samples:
                labels = {**labels, **extra}
                if self.max_label_sets is not None:
                    key = _lk({k: v for k, v in labels.items() if k != "le"})
                    sets = seen_sets[DROPPED_METRIC]
                    if key not in sets:
                        if len(sets) >= self.max_label_sets:
                            dropped[DROPPED_METRIC] = dropped.get(DROPPED_METRIC, 0) + 1
                            continue
                        sets[key] = None
                tlines.append(f"{name}{_fmt(_lk(labels))} {value}{exemplar}")
        if dropped:
            if ttype == "untyped" and not trail:
                ttype = "counter"
            for fam, n in sorted(dropped.items()):
                tlines.append(
                    f'{DROPPED_METRIC}'
                    f'{_fmt(_lk({"metric": fam, "scope": "fleet"}))} {float(n)}'
                )
        if trail or dropped:
            emitted = True
            yield self._block(DROPPED_METRIC, ttype, thelp, tlines)
        if not emitted:
            yield "\n"  # empty merge: byte-identical to merge_expositions

    @staticmethod
    def _block(fam: str, ftype: str, fhelp: str, sample_lines: list[str]) -> str:
        shown = ftype if ftype != "untyped" else "gauge"
        head = f"# HELP {fam} {fhelp or _HELP.get(fam, fam)}\n# TYPE {fam} {shown}\n"
        return head + "".join(line + "\n" for line in sample_lines)


# Process-default registry + conveniences: the serving data plane reports
# here (`metrics.inc/observe/set` is the call shape the catalogue checker
# walks for); runtime/server.py merges this into its /metrics exposition.
REGISTRY = MetricsRegistry()


def inc(name: str, labels: dict[str, str] | None = None, value: float = 1.0) -> None:
    REGISTRY.inc(name, labels, value)


def observe(name: str, value: float, labels: dict[str, str] | None = None,
            exemplar: dict[str, str] | None = None) -> None:
    REGISTRY.observe(name, value, labels, exemplar=exemplar)


def set(name: str, value: float, labels: dict[str, str] | None = None) -> None:  # noqa: A001 — mirrors the registry method
    REGISTRY.set(name, value, labels)


# Literal name (== DROPPED_METRIC): the catalogue checker anchors names on
# string-literal describe()/emission sites.
describe("lws_metric_label_sets_dropped_total",
         "Samples dropped by the per-metric label-set cardinality cap")
describe("lws_reconcile_total", "Reconciles per controller")
describe("lws_reconcile_errors_total", "Reconcile exceptions per controller (conflicts excluded)")
describe("lws_reconcile_duration_seconds", "Reconcile latency per controller and result")
describe("lws_rollout_progress", "Fraction of groups on the target revision, per LWS rollout")
describe("serving_requests_total", "Requests admitted per engine")
describe("serving_admission_duration_seconds", "Admission (prefill-to-slot) latency per engine")
describe("serving_decode_dispatch_duration_seconds", "Decode dispatch latency per engine")
describe("serving_spec_verify_duration_seconds", "Speculative verify dispatch latency")
describe("serving_spec_tokens_total",
         "Speculative draft tokens verified (kind=drafted) vs model-accepted (kind=accepted), per engine")
describe("serving_active_slots", "Active decode slots per engine")
describe("serving_inflight_dispatches", "Dispatched-but-unconsumed decode chunks in the engine's pipeline ring")
describe("serving_host_blocked_seconds", "Seconds the serving loop spent on host-side scheduling with no device work in flight")
describe("serving_kv_handoff_bytes_total", "KV bundle bytes shipped prefill -> decode")
describe("serving_kv_handoffs_total", "KV bundles handed off prefill -> decode")
# --- streamed KV handoff wire accounting (serving/kv_transport.py) ---------
describe("serving_kv_transfer_bytes_total",
         "KV handoff payload bytes moved over the wire, per transfer leg "
         "(role=prefill send / role=decode receive)")
describe("serving_kv_transfer_seconds",
         "Wall-clock of one KV handoff transfer (monolithic send, or "
         "stream BEGIN through END), per leg")
describe("serving_kv_stream_inflight_chunks",
         "Stream chunks produced by prefill compute but not yet acked by "
         "a decode puller")
describe("serving_kv_copy_bytes_total",
         "Payload bytes that paid an extra host copy (the arrays_to_bytes "
         "join); the streamed KV path is budgeted to keep this flat")
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
# --- goodput ledger (core/slo.py; consumed by lws_tpu/loadgen/) ------------
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
# --- fleet aggregation (runtime/fleet.py) ----------------------------------
describe("lws_fleet_instances",
         "Ready workers the fleet scraper merged on the last pass (unlabeled "
         "= merged total, the historical series; state=scraped/failed/backoff "
         "breaks the discovered fleet down by scrape outcome)")
describe("lws_fleet_scrape_errors_total", "Worker telemetry scrapes (/metrics or /debug/profile) that failed, per instance")
describe(
    "lws_fleet_shard_scrape_seconds",
    "Wall-clock of one shard collector's scrape pass (fan-out + per-shard "
    "merge) in the two-tier fleet scrape tree, per shard — the tree keeps "
    "this near-constant as the fleet widens",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
)
describe("lws_fleet_shards_dropped_total",
         "Shard expositions dropped whole by the streaming fleet merge "
         "because the shard text failed validation (one bad shard never "
         "poisons /metrics/fleet)")
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
# --- resilience + fault injection (core/resilience.py, core/faults.py) -----
describe("serving_retries_total", "Retry events per call site and outcome (retry / recovered / exhausted / budget_exhausted)")
describe("serving_deadline_expirations_total", "Calls aborted (or work dropped) at a blocking point because the request deadline had expired, per site")
describe("serving_circuit_state", "Circuit-breaker state per endpoint (0 closed, 1 half-open, 2 open)")
describe("serving_circuit_transitions_total", "Circuit-breaker state transitions per endpoint, labeled with the state entered")
describe("serving_draining", "1 while this process is draining (admitting nothing new, finishing in-flight work)")
describe("serving_replays_deduped_total", "Replayed at-least-once deliveries skipped by the bounded seen-id dedup guard")
describe("serving_kv_connection_errors_total", "KV handoff connections that died mid-request (client retries cover them)")
describe("lws_fault_trips_total", "Injected-fault firings per fault point and mode (chaos runs only; zero in production)")
describe("lws_fault_points_armed", "Fault points currently armed in this process")
describe("lws_fleet_scrape_skipped_total", "Fleet scrapes skipped because the instance is in failure backoff")
# --- time-series history plane + scale recommender (lws_tpu/obs/) ----------
describe("lws_history_samples_total",
         "Exposition sampling passes folded into the process history ring")
describe("lws_history_series_dropped_total",
         "New series refused by the history ring's cardinality cap (retained series keep accruing points)")
describe("serving_slo_burn_rate",
         "Error-budget burn of the short window per tier (window=fast/slow), per engine and workload class — burn 1.0 exhausts the budget exactly at the SLO horizon; the fast tier pages at 14.4")
describe("serving_scale_recommendation",
         "Desired replica count per DS role from the burn/occupancy signals (lws_tpu/obs/recommend.py) — actuated by default through the stock annotation-adapter chain, recorded on the decision ledger; LWS_TPU_ACTUATION_DISABLE=scale makes it record-only")
# --- request-journey forensics (lws_tpu/obs/journey.py) --------------------
describe("serving_journeys_retained_total",
         "Request journeys kept by the tail-sampling vault, per retention outcome (breached/errored/deadline_expired/retried/fault kept 100%; slowest = the slow-K window; sampled = the healthy reservoir)")
describe("serving_journeys_dropped_total",
         "Journey records lost, per reason (not_sampled healthy drops, budget/aged/displaced evictions, open_evicted in-flight trace buffers, journey_span_cap/journey_event_cap truncations) — every loss is accounted")
# --- rollout intelligence plane (lws_tpu/obs/rollout.py) -------------------
describe("lws_rollout_ledger_events_total",
         "Control-plane transitions recorded on the rollout timeline ledger, per kind (revision flips, partition moves, pod churn, drains, alerts)")
describe("lws_rollout_ledger_dropped_total",
         "Ledger entries evicted before retention expiry, per kind — by the "
         "global capacity ring or the per-kind budget (a churn-noisy kind at "
         "fleet scale must not push revision flips off the timeline)")
describe("lws_rollout_canary_verdict",
         "Canary verdict per (lws, revision): +1 promote, 0 hold, -1 rollback — insufficient data holds, never promotes; a fresh rollback actuates by default (LWS_TPU_ACTUATION_DISABLE=rollout makes it record-only)")
describe("serving_slo_burn_rate_by_revision",
         "Revision-scoped twin of serving_slo_burn_rate: the worst instance's short-window burn per (engine, revision, window) — the baseline-vs-canary divergence signal")
# --- decision provenance + closed-loop actuation (lws_tpu/obs/decisions.py) -
# Emitted through the DecisionLedger's registry handle; declared here so the
# catalogue check anchors the names (same pattern as the ring's own drops).
describe("serving_actuations_total",
         "Decision-plane actuations per (plane, action, outcome): applied moved the fleet, suppressed = the kill switch, skipped = a failed guard, failed = an adapter error")
describe("serving_actuation_flaps_total",
         "Applied actuations that reversed the previous applied direction on the same plane within LWS_TPU_FLAP_WINDOW_S — the control-loop oscillation signal")
describe("serving_convergence_seconds",
         "Actuation-to-settled latency per plane: adapter call to the store reflecting the desired state (replicas ready / every pod on the restored revision)")
# --- device-runtime observability (lws_tpu/obs/device.py) -------------------
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
