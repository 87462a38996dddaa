"""Fleet metric aggregation: one scrape surface for every worker.

The control plane already knows where the workers are — pod records carry
a published address and the pod spec declares the telemetry port
(LWS_TPU_METRICS_PORT, the containerPort analog — same discovery contract
as the KV endpoint's LWS_TPU_KV_PORT). The FleetCollector walks READY pods
with a declared port, scrapes each `http://addr:port/metrics`, injects
`instance` (pod name) plus `role`/`revision` labels where the pod carries
them, and merges everything — control-plane registries included, as
instance "control-plane" — into ONE parser-valid exposition served at
`GET /metrics/fleet` (runtime/server.py).

Operators get fleet-level latency distributions instead of per-process
averages (the serving-at-scale case PAPERS.md makes): a PromQL quantile
over the merged `serving_ttft_seconds` IS the fleet TTFT distribution, and
`lws-tpu top` renders the same surface live. Scrapes are bounded (short
per-worker timeout, cached for `cache_ttl` so a dashboard refresh loop
can't DOS the data plane) and failures degrade per instance:
`lws_fleet_scrape_errors_total{instance}` counts them, the merged view
carries whatever answered.

The port's copy of lws_tpu/runtime/fleet.py, whole. It reads
LWS_TPU_METRICS_PORT and LWS_TPU_METRICS_TOKEN through the port's own
runtime/telemetry.py and scrapes the port's workers; nothing of it touches
a device.
"""

from __future__ import annotations

import os
import threading
import time
import urllib.request
from http.client import HTTPException
from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.core import metrics, trace
from lws_tpu_torch.runtime.telemetry import METRICS_PORT_ENV, METRICS_TOKEN_ENV


def pod_metrics_endpoint(pod) -> Optional[tuple[str, int]]:
    """(host, port) when the pod declares a telemetry port, else None.
    Mirrors kv_transport.discover_role_endpoint: the published address is
    used VERBATIM (LocalBackend publishes 127.0.0.1; a rendezvous FQDN
    resolves through cluster DNS). An unresolvable address fails that one
    instance's scrape — never silently rewritten to loopback, which off
    this host would scrape the wrong process under the pod's label.
    Public: the scale actuator (obs/decisions.py) resolves the same
    endpoint to drain a scale-in victim's worker before the pod goes."""
    for container in pod.spec.containers:
        for env in container.env:
            if env.name == METRICS_PORT_ENV and env.value:
                return pod.status.address or "127.0.0.1", int(env.value)
    return None


def _pod_scrape_labels(pod) -> dict[str, str]:
    from lws_tpu_torch.api import disagg

    labels = {"instance": pod.meta.name}
    role = pod.meta.labels.get(disagg.DS_ROLE_LABEL_KEY)
    if role:
        labels["role"] = role
    revision = pod.meta.labels.get(disagg.DS_REVISION_LABEL_KEY) or \
        pod.meta.labels.get(contract.REVISION_LABEL_KEY)
    if revision:
        labels["revision"] = revision
    return labels


class FleetCollector:
    def __init__(
        self,
        store,
        control_registries: tuple = (),
        timeout_s: float = 2.0,
        cache_ttl_s: float = 1.0,
        max_label_sets: int = 512,
        metrics_registry=None,
        backoff_base_s: float = 2.0,
        backoff_cap_s: float = 60.0,
        shard_size: int = 64,
    ) -> None:
        """`control_registries` join the merge as instance "control-plane";
        `metrics_registry` receives the collector's own health metrics
        (defaults to the first control registry, else the process one).
        `backoff_base_s`/`backoff_cap_s` shape the per-instance scrape
        backoff: a failing instance doubles its skip window per consecutive
        miss up to the cap — the collector's circuit-breaker-lite.
        `shard_size` bounds one shard collector's member count in the
        two-tier scrape tree (one shard per role-slice of at most this many
        instances): scrape wall-clock then grows with shard depth, not
        fleet width."""
        self.store = store
        self.control_registries = control_registries
        self.timeout_s = timeout_s
        self.cache_ttl_s = cache_ttl_s
        self.max_label_sets = max_label_sets
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.shard_size = max(1, shard_size)
        self._own_metrics = (
            metrics_registry if metrics_registry is not None
            else (control_registries[0] if control_registries else metrics.REGISTRY)
        )
        self._lock = threading.Lock()
        self._refill_lock = threading.Lock()
        # Per-shard merged expositions, shard_id -> {"text", "at" (monotonic),
        # "members" (instance-name tuple, so membership churn invalidates),
        # "scraped"/"failed"/"skipped" counts}: the TTL cache now lives at
        # shard granularity — a dashboard refresh re-renders the fleet view
        # from cached shard texts without re-dialing anyone, and the fleet
        # text itself is never cached whole (streaming bound).
        self._shard_cache: dict[str, dict] = {}  # guarded-by: _lock
        # Instances currently failing to scrape, with per-instance backoff
        # state ({"failures": n, "until": monotonic}): a down worker is
        # SKIPPED until its backoff expires instead of being re-dialed (and
        # re-timed-out) on every cache refill. Ring events fire on the
        # healthy->failing edge only (the counter still counts every real
        # miss). Mutated from the scrape pool's threads, so it shares
        # _lock: two concurrent misses for one instance must produce ONE
        # edge event, and lock-free mutation under churn can corrupt it.
        self._failing: dict[str, dict] = {}  # guarded-by: _lock

    # ---- discovery + scrape ----------------------------------------------
    def targets(self) -> list[tuple[dict, tuple[str, int]]]:
        """[(labels, (host, port))] for every READY pod declaring a
        telemetry port — k8s Endpoints semantics, same readiness gate as
        the KV endpoint discovery."""
        out = []
        for pod in self.store.list("Pod"):
            if not getattr(pod.status, "ready", False):
                continue
            endpoint = pod_metrics_endpoint(pod)
            if endpoint is None:
                continue
            out.append((_pod_scrape_labels(pod), endpoint))
        return out

    @staticmethod
    def _scrape_headers(accept: Optional[str] = None) -> dict:
        """Shared worker-scrape headers: optional Accept negotiation plus
        the same-deployment bearer token (one token, CP + workers)."""
        headers = {"Accept": accept} if accept else {}
        token = os.environ.get(METRICS_TOKEN_ENV)
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return headers

    def _scrape_one(self, host: str, port: int) -> str:
        from lws_tpu_torch.core import faults

        faults.fire("fleet.scrape")
        # Negotiate OpenMetrics: the merge must carry the workers' trace
        # exemplars (classic text-format responses have them stripped).
        req = urllib.request.Request(
            f"http://{host}:{port}/metrics",
            headers=self._scrape_headers(metrics.OPENMETRICS_CONTENT_TYPE),
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read().decode()

    def _backoff_s(self, failures: int) -> float:  # holds-lock: _lock
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** max(0, failures - 1)))

    def in_backoff(self, instance: str, now: float) -> bool:
        with self._lock:
            state = self._failing.get(instance)
            return state is not None and now < state["until"]

    def _scrape_target(self, labels: dict, host: str, port: int,
                       now: Optional[float] = None) -> Optional[str]:
        instance = labels["instance"]
        if now is None:
            now = time.monotonic()
        started = time.perf_counter()
        try:
            text = self._scrape_one(host, port)
            # Validate HERE, inside the per-instance guard: one worker
            # answering with garbage (port reused mid-restart, truncated
            # body) must not blank the whole fleet view when the merge
            # parses it later.
            metrics.parse_exposition(text)
            with self._lock:
                recovered = self._failing.pop(instance, None) is not None
            if recovered:
                from lws_tpu_torch.core import flightrecorder

                flightrecorder.record("fleet_scrape_recovered",
                                      instance=instance)
            return text
        except (OSError, ValueError, HTTPException) as e:
            self._own_metrics.inc(
                "lws_fleet_scrape_errors_total", {"instance": instance},
            )
            # The failure is also a flight-recorder event — but only on the
            # healthy->failing EDGE: a dead worker re-scraped every cache
            # TTL would otherwise flood the bounded ring and evict the rare
            # notable events the black box exists to retain. The test-and-
            # set runs under _lock: this method executes on the scrape
            # pool's threads, and two lock-free concurrent misses could
            # both pass the membership test and double-record the edge.
            # Each consecutive miss doubles the instance's backoff window
            # (collect() skips it until `until` passes).
            # Anchor the window at the FAILURE time, not collect-start: a
            # timing-out scrape otherwise consumes its own backoff window
            # (timeout_s ~= backoff_base_s) and gets re-dialed every cache
            # refill anyway. `now` stays the injected base so tests remain
            # deterministic; the elapsed scrape time rides on top.
            failed_at = now + (time.perf_counter() - started)
            with self._lock:
                state = self._failing.get(instance)
                newly_failing = state is None
                failures = 1 if newly_failing else state["failures"] + 1
                self._failing[instance] = {
                    "failures": failures,
                    "until": failed_at + self._backoff_s(failures),
                }
            if newly_failing:
                from lws_tpu_torch.core import flightrecorder

                flightrecorder.record(
                    "fleet_scrape_error",
                    instance=instance, error=repr(e)[:200],
                )
            return None

    # ---- two-tier scrape tree --------------------------------------------
    def _shards(self, discovered) -> list[tuple[str, list]]:
        """Partition discovered targets into shard collectors: role-major,
        then slices of at most `shard_size` instances, members name-sorted
        so a stable fleet yields stable shard membership (and the per-shard
        cache actually hits). Shard ids are `{role}-{slice_index}`."""
        by_role: dict[str, list] = {}
        for labels, endpoint in discovered:
            by_role.setdefault(labels.get("role") or "default", []).append(
                (labels, endpoint)
            )
        shards: list[tuple[str, list]] = []
        for role in sorted(by_role):
            members = sorted(by_role[role], key=lambda t: t[0]["instance"])
            for i in range(0, len(members), self.shard_size):
                shards.append(
                    (f"{role}-{i // self.shard_size}",
                     members[i:i + self.shard_size])
                )
        return shards

    def _prune_backoff(self, discovered) -> None:
        """Prune backoff state for instances that LEFT the ready set: a pod
        that restarted under the same name re-enters with a clean slate
        (it went unready in between), and names that never return must
        not accumulate in _failing forever."""
        live_names = {labels["instance"] for labels, _ in discovered}
        with self._lock:
            for stale in [i for i in self._failing if i not in live_names]:
                del self._failing[stale]

    def _scrape_shard(self, shard_id: str, members: list,
                      now: float) -> tuple[list, int, int]:
        """One shard collector's pass: backoff-filter its members, scrape
        the rest concurrently, time the whole thing. Returns
        ([(labels, text)], n_failed, n_skipped). Failure isolation stays
        per shard: a shard of timing-out instances burns ITS wall-clock
        budget while its siblings proceed on the root pool."""
        live = []
        skipped = 0
        for labels, endpoint in members:
            if self.in_backoff(labels["instance"], now):
                self._own_metrics.inc(
                    "lws_fleet_scrape_skipped_total",
                    {"instance": labels["instance"]},
                )
                skipped += 1
                continue
            live.append((labels, endpoint))
        sources: list[tuple[dict, str]] = []
        started = time.perf_counter()
        if live:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(live))) as pool:
                scraped = pool.map(
                    lambda t: self._scrape_target(t[0], *t[1], now=now),
                    live,
                )
                sources = [
                    (labels, text)
                    for (labels, _), text in zip(live, scraped)
                    if text is not None
                ]
        self._own_metrics.observe(
            "lws_fleet_shard_scrape_seconds",
            time.perf_counter() - started,
            {"shard": shard_id},
        )
        return sources, len(live) - len(sources), skipped

    def _scrape_tree(self, now: float) -> list[tuple[str, list]]:
        """The full two-tier pass: discovery, backoff pruning, shard
        fan-out on a root pool (each shard fans out to its members on its
        own pool), fleet gauges. Returns [(shard_id, [(labels, text)])]."""
        discovered = self.targets()
        self._prune_backoff(discovered)
        shards = self._shards(discovered)
        results: list[tuple[str, list]] = []
        n_scraped = n_failed = n_backoff = 0
        with trace.span("fleet.scrape", instances=len(discovered),
                        shards=len(shards)):
            if shards:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=min(8, len(shards))) as root:
                    out = root.map(
                        lambda s: self._scrape_shard(s[0], s[1], now), shards,
                    )
                    for (shard_id, _), (sources, failed, skipped) in zip(shards, out):
                        results.append((shard_id, sources))
                        n_scraped += len(sources)
                        n_failed += failed
                        n_backoff += skipped
        self._set_fleet_gauges(n_scraped, n_failed, n_backoff)
        return results

    def _set_fleet_gauges(self, n_scraped: int, n_failed: int,
                          n_backoff: int) -> None:
        # Unlabeled total = merged instance count (the historical series
        # dashboards already watch); the state breakdown rides alongside,
        # zeros included so a recovering fleet visibly drains failed/backoff.
        self._own_metrics.set("lws_fleet_instances", float(n_scraped))
        self._own_metrics.set("lws_fleet_instances", float(n_scraped),
                              {"state": "scraped"})
        self._own_metrics.set("lws_fleet_instances", float(n_failed),
                              {"state": "failed"})
        self._own_metrics.set("lws_fleet_instances", float(n_backoff),
                              {"state": "backoff"})

    def collect(self, now: Optional[float] = None) -> list[tuple[dict, str]]:
        """One scrape pass over the ready fleet: [(labels, exposition)].
        Control-plane registries ride along as instance "control-plane" so
        the fleet view is genuinely ONE surface. Per-instance failures are
        counted and skipped — a dead worker must not blank the fleet — and
        a KNOWN-failing instance is not even dialed until its backoff
        expires (each consecutive miss doubles the window up to the cap),
        so a dead pod costs one timeout per backoff window, not one per
        cache refill. `now` (monotonic seconds) is injectable so the
        backoff regression tests drive time deterministically. The pass
        runs the two-tier shard tree under the hood (a partitioned worker
        costs one timeout of SHARD wall clock, overlapped with its sibling
        shards) and flattens the result for callers that want per-instance
        sources."""
        if now is None:
            now = time.monotonic()
        sources: list[tuple[dict, str]] = [
            src
            for _, shard_sources in self._scrape_tree(now)
            for src in shard_sources
        ]
        # Render the control plane LAST: this pass's own health metrics
        # (instance gauge, scrape-error counts) must appear in THIS pass's
        # merged view, not trail one scrape behind.
        if self.control_registries:
            sources.insert(0, (
                {"instance": "control-plane"},
                metrics.render_exposition(*self.control_registries),
            ))
        return sources

    # ---- continuous-profiling fan-in (GET /debug/profile/fleet) ----------
    def _scrape_profile(self, labels: dict, host: str, port: int,
                        limit: int) -> Optional[dict]:
        """One worker's /debug/profile snapshot, or None on failure (counted
        under the same per-instance scrape-error counter as /metrics; no
        flight-recorder edge event — profile scrapes are operator-driven
        one-shots, not the periodic refresh whose re-fire flood the
        _failing edge logic exists to suppress). The generic debug-JSON
        scrape plus the profile shape check."""
        snap = self._scrape_debug_json(
            labels, host, port, f"/debug/profile?limit={int(limit)}",
            missing_ok=False,
        )
        if snap is not None and (not isinstance(snap, dict)
                                 or "stacks" not in snap):
            self._own_metrics.inc(
                "lws_fleet_scrape_errors_total", {"instance": labels["instance"]},
            )
            return None
        return snap

    def collect_profiles(self, limit: int = 512) -> list[tuple[dict, dict]]:
        """[(labels, profile snapshot)] over the ready fleet plus this
        process as instance "control-plane" — the /debug/profile analog of
        collect(). Operator-driven (no cache: `lws-tpu profile` polls at
        human rates, and snapshots are cumulative anyway)."""
        from lws_tpu_torch.core import profile as profmod

        sources: list[tuple[dict, dict]] = [
            ({"instance": "control-plane"}, profmod.PROFILER.snapshot(limit))
        ]
        targets = self.targets()
        if targets:
            from concurrent.futures import ThreadPoolExecutor

            with profmod.phase("fleet.profile_scrape"):
                with ThreadPoolExecutor(max_workers=min(8, len(targets))) as pool:
                    scraped = pool.map(
                        lambda t: self._scrape_profile(t[0], *t[1], limit),
                        targets,
                    )
                    sources.extend(
                        (labels, snap)
                        for (labels, _), snap in zip(targets, scraped)
                        if snap is not None
                    )
        return sources

    # ---- request-journey fan-in (GET /debug/request[s]) ------------------
    def _scrape_debug_json(self, labels: dict, host: str, port: int,
                           path: str, missing_ok: bool = True):
        """One worker's JSON debug body, or None when the worker has
        nothing for it (with `missing_ok`, a 404 — a request that never
        touched that instance — is an answer, not an error; real failures
        count under the usual per-instance scrape-error counter)."""
        import json
        import urllib.error

        req = urllib.request.Request(
            f"http://{host}:{port}{path}", headers=self._scrape_headers(),
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if missing_ok and e.code == 404:
                return None
            self._own_metrics.inc(
                "lws_fleet_scrape_errors_total", {"instance": labels["instance"]},
            )
            return None
        except (OSError, ValueError, HTTPException):
            self._own_metrics.inc(
                "lws_fleet_scrape_errors_total", {"instance": labels["instance"]},
            )
            return None

    def collect_journeys(self, request_id: str) -> Optional[dict]:
        """Fleet-join one request's journey legs: every ready worker's
        `GET /debug/request/{id}` plus this process's local leg (the
        client/reconcile spans live HERE), merged into one record whose
        span set should form one connected tree — the trace ctx rode the
        KV frame meta, so prefill's and decode's subtrees share the
        client's trace id. None when no instance knows the id."""
        from urllib.parse import quote

        from lws_tpu_torch.core import trace
        from lws_tpu_torch.core.trace import connected_tree
        from lws_tpu_torch.obs import journey as journeymod

        legs: list[tuple[dict, dict]] = []
        local = journeymod.local_journey(request_id)
        if local is not None:
            legs.append(({"instance": "control-plane"}, local))
        targets = self.targets()
        if targets:
            from concurrent.futures import ThreadPoolExecutor

            path = f"/debug/request/{quote(str(request_id), safe='')}"
            with trace.span("fleet.journey_scrape", instances=len(targets)):
                with ThreadPoolExecutor(max_workers=min(8, len(targets))) as pool:
                    scraped = pool.map(
                        lambda t: self._scrape_debug_json(t[0], *t[1], path),
                        targets,
                    )
                    legs.extend(
                        (labels, leg)
                        for (labels, _), leg in zip(targets, scraped)
                        if isinstance(leg, dict)
                    )
        if not legs:
            return None
        trace_id = next(
            (leg.get("trace_id") for _, leg in legs if leg.get("trace_id")),
            None,
        )
        if local is None and trace_id:
            # The workers named the trace: pull this process's leg of it
            # (the request root + reconcile spans the client opened here).
            extra = journeymod.VAULT.spans_for_trace(trace_id) or [
                s for s in trace.TRACER.spans()
                if s.get("trace_id") == trace_id
            ]
            if extra:
                legs.insert(0, ({"instance": "control-plane"}, {
                    "id": request_id, "trace_id": trace_id,
                    "outcome": "open", "completed": False, "flags": [],
                    "timeline": {}, "events": [], "annotations": {},
                    "spans": extra,
                }))
        spans: list[dict] = []
        seen_spans: set = set()
        events: list[dict] = []
        annotations: dict = {}
        flags: set = set()
        for labels, leg in legs:
            for s in leg.get("spans") or []:
                sid = s.get("span_id")
                if sid in seen_spans:
                    continue
                seen_spans.add(sid)
                spans.append({**s, "instance": labels.get("instance", "-")})
            events.extend(leg.get("events") or [])
            annotations.update(leg.get("annotations") or {})
            flags.update(leg.get("flags") or [])
        # Worst leg verdict wins the joined outcome label (a breached
        # decode leg must not be masked by a healthy prefill leg).
        outcome = "open"
        for want in ("errored", "deadline_expired", "breached", "retried",
                     "fault", "slowest", "sampled"):
            if any(leg.get("outcome") == want for _, leg in legs):
                outcome = want
                break
        return {
            "id": request_id,
            "trace_id": trace_id,
            "outcome": outcome,
            "flags": sorted(flags),
            "spans": spans,
            "events": sorted(events, key=lambda e: e.get("ts", 0.0)),
            "annotations": annotations,
            "legs": [
                {"labels": labels,
                 "journey": {k: v for k, v in leg.items() if k != "spans"}}
                for labels, leg in legs
            ],
            "connected": connected_tree(spans) if spans else False,
        }

    def collect_request_index(self, outcome: str = "all", klass: str = "",
                              limit: int = 32,
                              revision: str = "") -> list[dict]:
        """Fleet-joined `/debug/requests` index: every ready worker's
        retained-journey digests plus this process's, instance-labelled and
        merged worst-first. Unknown outcomes raise ValueError BEFORE any
        scrape (the caller answers 400). `revision` narrows every leg to
        journeys that completed under that serving revision."""
        from lws_tpu_torch.obs import journey as journeymod

        rows = [
            {**row, "instance": "control-plane"}
            for row in journeymod.VAULT.index(outcome=outcome, klass=klass,
                                              limit=limit, revision=revision)
        ]
        targets = self.targets()
        if targets:
            from concurrent.futures import ThreadPoolExecutor
            from urllib.parse import urlencode

            query = urlencode({"outcome": outcome, "klass": klass,
                               "limit": int(limit), "revision": revision})
            path = f"/debug/requests?{query}"
            with ThreadPoolExecutor(max_workers=min(8, len(targets))) as pool:
                scraped = pool.map(
                    lambda t: self._scrape_debug_json(t[0], *t[1], path),
                    targets,
                )
                for (labels, _), got in zip(targets, scraped):
                    if isinstance(got, list):
                        rows.extend(
                            {**row, "instance": labels.get("instance", "-")}
                            for row in got if isinstance(row, dict)
                        )
        if outcome == "slowest":
            rows.sort(key=lambda r: -(r.get("latency_s") or 0.0))
        else:
            rows.sort(key=lambda r: -(r.get("completed_unix") or 0.0))
        if limit >= 0:
            rows = rows[:limit] if limit else []
        return rows

    def collect_prefix_index(self, limit: int = 512) -> dict:
        """Fleet-merged prefix-cache digest index (ISSUE 18, the remote
        tier's discovery half): every ready worker's `GET /debug/prefixes`
        advertisement folded into digest-hex -> {instance, host, port,
        tier}, where (host, port) is the sibling's KV wire endpoint a
        `fetch_prefix` should dial. Arena-backed entries win over
        HBM-resident ones for the same digest: the default fetch provider
        serves the host arena, so those are the fetchable copies. Instances
        that advertise no KV port contribute nothing fetchable and are
        skipped."""
        from lws_tpu_torch.core import trace

        index: dict[str, dict] = {}
        targets = self.targets()
        if not targets:
            return {"digests": {}, "instances": 0}
        from concurrent.futures import ThreadPoolExecutor

        path = f"/debug/prefixes?limit={int(limit)}"
        answered = 0
        with trace.span("fleet.prefix_scrape", instances=len(targets)):
            with ThreadPoolExecutor(max_workers=min(8, len(targets))) as pool:
                scraped = pool.map(
                    lambda t: self._scrape_debug_json(
                        t[0], *t[1], path, missing_ok=False
                    ),
                    targets,
                )
                for (labels, (host, _mport)), got in zip(targets, scraped):
                    if not isinstance(got, dict):
                        continue
                    answered += 1
                    kv_port = got.get("kv_port")
                    if not kv_port:
                        continue
                    for tier, key in (("hbm", "digests"),
                                      ("host", "arena_digests")):
                        for hexd in got.get(key) or []:
                            have = index.get(hexd)
                            if have is None or (
                                tier == "host" and have["tier"] == "hbm"
                            ):
                                index[hexd] = {
                                    "instance": labels.get("instance", "-"),
                                    "host": host,
                                    "port": int(kv_port),
                                    "tier": tier,
                                }
        return {"digests": index, "instances": answered}

    def prefix_lookup(self, limit: int = 512):
        """A `RemotePrefixSource`-shaped lookup closure over a fresh
        digest index snapshot: digest_hex -> (host, kv_port) | None."""
        snapshot = self.collect_prefix_index(limit)["digests"]

        def lookup(digest_hex: str):
            entry = snapshot.get(digest_hex)
            if entry is None:
                return None
            return entry["host"], entry["port"]

        return lookup

    # ---- compile-ledger fan-in (GET /debug/compile/fleet) ----------------
    def collect_compiles(self, limit: int = 256) -> dict:
        """Fleet-merged compile-ledger view: every ready worker's
        `GET /debug/compile` plus this process's own ledger as instance
        "control-plane", each under its instance labels, with a cross-fleet
        `executables` fold (per-executable first/recompile/seconds summed
        over instances — the "which executable storms fleet-wide" answer).
        Operator-driven like collect_profiles (no cache: `lws-tpu devices`
        polls at human rates, and ledger counters are cumulative anyway)."""
        from lws_tpu_torch.core import trace
        from lws_tpu_torch.obs import device as devicemod

        instances: list[dict] = [{
            "labels": {"instance": "control-plane"},
            "compile": devicemod.debug_compile(limit),
        }]
        targets = self.targets()
        if targets:
            from concurrent.futures import ThreadPoolExecutor

            path = f"/debug/compile?limit={int(limit)}"
            with trace.span("fleet.compile_scrape", instances=len(targets)):
                with ThreadPoolExecutor(max_workers=min(8, len(targets))) as pool:
                    scraped = pool.map(
                        lambda t: self._scrape_debug_json(
                            t[0], *t[1], path, missing_ok=False
                        ),
                        targets,
                    )
                    instances.extend(
                        {"labels": labels, "compile": got}
                        for (labels, _), got in zip(targets, scraped)
                        if isinstance(got, dict)
                    )
        executables: dict[str, dict] = {}
        for entry in instances:
            for name, counts in (entry["compile"].get("executables")
                                 or {}).items():
                agg = executables.setdefault(
                    name, {"first": 0, "recompiles": 0, "seconds": 0.0,
                           "instances": 0})
                agg["first"] += int(counts.get("first") or 0)
                agg["recompiles"] += int(counts.get("recompiles") or 0)
                agg["seconds"] = round(
                    agg["seconds"] + float(counts.get("seconds") or 0.0), 6)
                agg["instances"] += 1
        return {"instances": instances, "executables": executables}

    def collect_shard_texts(self, force: bool = False,
                            now: Optional[float] = None) -> list[tuple[str, str]]:
        """[(shard_id, merged shard exposition)] over the ready fleet, the
        control plane first as pseudo-shard "control-plane" (rendered fresh
        every call: this pass's own health metrics must appear in this
        pass's view). Shard texts are cached for `cache_ttl_s` keyed by
        shard membership, and refills are single-flight: concurrent cache
        misses wait for the one in-progress pass instead of each launching
        their own scrape storm. Only STALE shards are re-scraped. The
        per-family cardinality cap applies HERE, per shard — the root
        streaming merge runs uncapped, because a fleet-wide cap would need
        fleet-wide seen-label-set memory and void the O(largest shard)
        streaming bound."""
        if now is None:
            now = time.monotonic()
        with self._refill_lock:
            discovered = self.targets()  # vet: ignore[lock-held-blocking]: single-flight by design — _refill_lock exists so ONE scrape pass runs while concurrent misses wait on it
            self._prune_backoff(discovered)
            shards = self._shards(discovered)
            wall = time.monotonic()
            stale: list[tuple[str, list]] = []
            with self._lock:
                live_ids = {shard_id for shard_id, _ in shards}
                for gone in [s for s in self._shard_cache if s not in live_ids]:
                    del self._shard_cache[gone]
                for shard_id, members in shards:
                    names = tuple(labels["instance"] for labels, _ in members)
                    entry = self._shard_cache.get(shard_id)
                    if (force or entry is None or entry["members"] != names
                            or wall - entry["at"] >= self.cache_ttl_s):
                        stale.append((shard_id, members))
            if stale:
                from concurrent.futures import ThreadPoolExecutor

                with trace.span("fleet.scrape", instances=sum(
                        len(m) for _, m in stale), shards=len(stale)):
                    with ThreadPoolExecutor(
                            max_workers=min(8, len(stale))) as root:
                        out = root.map(  # vet: ignore[lock-held-blocking]: same single-flight refill — the scrape tree runs once under _refill_lock
                            lambda s: self._scrape_shard(s[0], s[1], now),
                            stale,
                        )
                        refreshed = {
                            shard_id: (sources, failed, skipped)
                            for (shard_id, _), (sources, failed, skipped)
                            in zip(stale, out)
                        }
                refreshed_at = time.monotonic()
                with self._lock:
                    for (shard_id, members) in stale:
                        sources, failed, skipped = refreshed[shard_id]
                        self._shard_cache[shard_id] = {
                            "text": metrics.merge_expositions(
                                sources, max_label_sets=self.max_label_sets),
                            "at": refreshed_at,
                            "members": tuple(
                                labels["instance"] for labels, _ in members),
                            "scraped": len(sources),
                            "failed": failed,
                            "skipped": skipped,
                        }
            with self._lock:
                entries = [(shard_id, self._shard_cache[shard_id])
                           for shard_id, _ in shards
                           if shard_id in self._shard_cache]
                texts = [(shard_id, e["text"]) for shard_id, e in entries]
                counts = [(e["scraped"], e["failed"], e["skipped"])
                          for _, e in entries]
            # Gauges reflect the whole tree — cached shards included —
            # so a partial refresh never under-reports fleet size.
            totals = [sum(c) for c in zip(*counts)] if counts else [0, 0, 0]
            self._set_fleet_gauges(*totals)
        if self.control_registries:
            # The pseudo-shard goes through the same per-shard merge as a
            # real one so its samples carry instance="control-plane" (the
            # root streaming merge injects nothing).
            texts.insert(0, ("control-plane", metrics.merge_expositions(
                [({"instance": "control-plane"},
                  metrics.render_exposition(*self.control_registries))],
                max_label_sets=self.max_label_sets,
            )))
        return texts

    def render_fleet_chunks(self, force: bool = False):
        """The fleet exposition as a chunk generator: shard texts (cached,
        single-flight — collect_shard_texts) fed through an UNCAPPED
        streaming merge, so /metrics/fleet writes to the wire with peak
        merge memory O(largest shard) and the whole-fleet text never
        materializes. A shard whose cached text fails validation is dropped
        whole (counted) instead of poisoning the view."""
        shard_texts = self.collect_shard_texts(force=force)
        merger = metrics.StreamingMerger(drop_malformed=True)
        yield from merger.merge([({}, text) for _, text in shard_texts])
        if merger.dropped_sources:
            self._own_metrics.inc(
                "lws_fleet_shards_dropped_total",
                value=float(len(merger.dropped_sources)),
            )

    def render_fleet(self, force: bool = False) -> str:
        """The merged exposition as ONE string — the convenience join of
        render_fleet_chunks for callers that genuinely need the whole text
        (history-ring ingest, CLI one-shots, tests). The serving path
        (runtime/server.py /metrics/fleet) streams the chunks instead."""
        return "".join(self.render_fleet_chunks(force=force))
