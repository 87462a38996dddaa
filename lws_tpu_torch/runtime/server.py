"""HTTP API server: the remote face of the control plane
(≈ the apiserver+webhook endpoint + healthz/readyz + metrics of
cmd/main.go:252-262,336-348 rolled into one in-process server).

The port's copy of lws_tpu/runtime/server.py. Left out, each waiting for
its ROADMAP Queue 1 item: TLS and bearer-token auth (`tls=`, `auth=`
raise, item (c)); `POST /cordon` and `POST /drain` (item (d)). A left-out
route answers 404 "unknown path", as any unknown path does.

Endpoints:
  GET  /healthz | /readyz             liveness/readiness
  GET  /metrics                       Prometheus text (control plane +
                                      process serving registry, one valid
                                      exposition)
  GET  /metrics/fleet                 the AGGREGATED fleet exposition: every
                                      ready worker's /metrics scraped and
                                      merged with instance/role/revision
                                      labels (runtime/fleet.py)
  GET  /debug/traces[?limit=N]        recent spans from the process tracer
                                      (reconcile -> serving trace spine)
  GET  /debug/flightrecorder[?limit=N] flight-recorder snapshot: event ring,
                                      heartbeats, active watchdog alerts,
                                      and the last alert's diagnostics dump
  GET  /debug/profile[?limit=N&format=json|collapsed]
                                      this process's collapsed-stack profile
                                      (core/profile.py; collapsed = raw
                                      flamegraph.pl input)
  GET  /debug/profile/fleet           every ready worker's /debug/profile,
                                      merged with instance/role labels
                                      (runtime/fleet.py)
  GET  /debug/history[?limit=N]       the process history ring: retained
                                      per-series time series sampled from
                                      the /metrics and /metrics/fleet
                                      surfaces (lws_tpu_torch/obs/history.py)
  GET  /debug/decisions[?limit=N]     the decision ledger: provenance
                                      records for every recommender/canary
                                      evaluation with guards, actuation
                                      outcome, and convergence timing
                                      (lws_tpu_torch/obs/decisions.py)
  GET  /debug/compile[?limit=N]       this process's compile ledger:
                                      backend-compile provenance records,
                                      per-executable counters, active storm
                                      windows (lws_tpu_torch/obs/device.py)
  GET  /debug/compile/fleet           every ready worker's /debug/compile
                                      plus the control-plane leg, instance-
                                      labelled, with a cross-fleet
                                      executables fold (runtime/fleet.py)
  GET  /debug/faults                  armed fault points + hit/trip counters
  POST /debug/faults                  arm/disarm deterministic fault
                                      schedules in this process
                                      (core/faults.py; bearer-gated like
                                      every other mutating endpoint)
  POST /apply                         YAML/JSON manifest (create-or-update)
  POST /apis/{kind}/{ns}/{name}/apply server-side apply of a partial field
                                      tree (?fieldManager=&force=)
  GET  /apis/{kind}                   list (JSON manifests)
  GET  /apis/{kind}/{ns}/{name}       get
  DELETE /apis/{kind}/{ns}/{name}     delete
  POST /scale/{ns}/{name}             {"replicas": N} on a LeaderWorkerSet
  POST /report-metric/{ns}/{pod}      {"metric": value} -> pod annotation (autoscaler)
  GET  /watch?since=N[&timeout=S]     long-poll of store events (since=-1:
                                      a bookmark; {"expired": true}: relist)
  GET  /logs/{ns}/{pod}               captured pod stdout/stderr
  GET  /events[?namespace=&name=]     controller decision trace (k8s Events)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from lws_tpu_torch.core.store import (
    AdmissionError,
    AlreadyExistsError,
    ConflictError,
    FieldManagerConflict,
    NotFoundError,
)
from lws_tpu_torch.manifest import from_manifest, to_manifest


_CANONICAL_KINDS = (
    "LeaderWorkerSet", "DisaggregatedSet", "GroupSet", "Pod", "Node",
    "Service", "PodGroup", "ControllerRevision", "PersistentVolumeClaim",
    "Autoscaler", "Lease",
)
_KIND_ALIASES = {
    **{k.lower(): k for k in _CANONICAL_KINDS},
    **{k.lower() + "s": k for k in _CANONICAL_KINDS},
    "lws": "LeaderWorkerSet",
    "ds": "DisaggregatedSet",
    "pvc": "PersistentVolumeClaim",
    "pvcs": "PersistentVolumeClaim",
    "revision": "ControllerRevision",
    "revisions": "ControllerRevision",
}


def _kind(raw: str) -> str:
    """kubectl-style kind resolution: `pods`, `Pod`, `lws`, ... all work."""
    kind = _KIND_ALIASES.get(raw.lower())
    if kind is None:
        raise ValueError(
            f"unknown kind {raw!r}; one of {', '.join(sorted(_KIND_ALIASES))}"
        )
    return kind


def _retry_conflicts(attempt_fn, what: str):
    """Run a read-modify-update attempt up to 5 times across optimistic-
    concurrency races with background controllers; returns the attempt's
    result. Persistent losers surface as ConflictError → HTTP 409."""
    for _ in range(4):
        try:
            return attempt_fn()
        except (ConflictError, AlreadyExistsError):
            # AlreadyExists: a create lost a create-vs-create race; the next
            # attempt re-reads and takes the update path.
            continue
    try:
        return attempt_fn()  # last try: conflict propagates to the 409 path
    except ConflictError as e:
        raise ConflictError(f"{what}: {e}") from e


class ApiServer:
    def __init__(
        self,
        control_plane,
        port: int = 9443,
        host: str = "127.0.0.1",
        tls=None,
        watch_buffer: int = 4096,
        auth=None,
    ) -> None:
        """`watch_buffer`: events retained for /watch replay; clients that
        fall further behind are told to relist (k8s "410 Gone" semantics).
        `tls` and `auth` (the JAX package's CertManager and TokenAuth) are
        not ported yet: passing either raises."""
        import collections

        if tls is not None or auth is not None:
            raise NotImplementedError(
                "TLS and token auth (core/certs.CertManager, core/auth.py) "
                "are not ported yet: ROADMAP Queue 1 (c), durability and HA"
            )
        self.control_plane = control_plane
        cp = control_plane

        # Journey-vault feeds for THIS process (span buffering, resilience
        # events, SLO completions): the API server's local leg of the
        # cross-process /debug/request assembly. Idempotent; off with
        # LWS_TPU_JOURNEYS=0.
        from lws_tpu_torch.obs import journey as journeymod

        journeymod.install()

        # Watch plumbing (≈ the apiserver's watch cache): every store event
        # gets a server-local sequence number; /watch long-polls on it.
        events = collections.deque(maxlen=watch_buffer)
        events_cond = threading.Condition()
        seq_box = {"seq": 0}

        def _record_event(ev) -> None:
            # Store-watch observer on the committing writer's thread: a
            # manifest-encoding bug must cost one watch event, not the
            # writer. Long-pollers resync from a LIST on reconnect anyway.
            try:
                with events_cond:
                    seq_box["seq"] += 1
                    events.append(
                        {"seq": seq_box["seq"], "type": ev.type, "object": to_manifest(ev.obj)}
                    )
                    events_cond.notify_all()
            except Exception:  # vet: ignore[hazard-exception-swallow]: a broken watch-cache append must not kill the committing writer (purity-observer-raise)
                pass

        self._unwatch = cp.store.watch(_record_event)
        self._events, self._events_cond, self._seq_box = events, events_cond, seq_box

        from lws_tpu_torch.version import user_agent

        class Handler(BaseHTTPRequestHandler):
            server_version = user_agent()  # identifies the control plane
            sys_version = ""

            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, body: str, ctype: str = "application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code: int, obj):
                self._send(code, json.dumps(obj, indent=1, default=str))

            def _send_exposition(self, text: str) -> None:
                from lws_tpu_torch.core import metrics as metricsmod

                body, ctype = metricsmod.negotiate_exposition(
                    text, self.headers.get("Accept")
                )
                self._send(200, body, ctype)

            def _stream_exposition(self, chunks) -> None:
                """The streaming twin of _send_exposition: write exposition
                chunks to the wire as they merge, close-delimited (HTTP/1.0,
                no Content-Length) — the whole fleet text never exists
                server-side. Per-chunk exemplar stripping and the trailing
                `# EOF` replicate negotiate_exposition byte-for-byte (chunks
                hold whole lines, so the line-anchored strip regex composes)."""
                from lws_tpu_torch.core import metrics as metricsmod

                om = metricsmod.wants_openmetrics(self.headers.get("Accept"))
                chunks = iter(chunks)
                # Pull the first chunk BEFORE committing headers: a scrape
                # pass that dies whole must 500, not truncate a 200.
                try:
                    first = next(chunks)
                except StopIteration:
                    first = "\n"
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    metricsmod.OPENMETRICS_CONTENT_TYPE if om else "text/plain",
                )
                self.end_headers()
                import itertools

                for chunk in itertools.chain((first,), chunks):
                    if not om:
                        chunk = metricsmod.strip_exemplars(chunk)
                    if chunk:
                        self.wfile.write(chunk.encode())
                if om:
                    self.wfile.write(b"# EOF\n")

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                parts = [p for p in path.split("/") if p]
                if self.path in ("/healthz", "/readyz"):
                    self._send(200, "ok", "text/plain")
                elif path == "/metrics":
                    # One merged exposition: the control plane's registry
                    # plus the process-default registry the serving engines
                    # report into (a live worker embedding both is
                    # inspectable from one scrape).
                    from lws_tpu_torch.core import metrics as metricsmod
                    from lws_tpu_torch.core import profile as profmod
                    from lws_tpu_torch.core import slo as slomod

                    # Device-memory gauges refresh per scrape (CPU-safe
                    # no-op without allocator stats) via the shared helper
                    # — per-device + per-pool + peak/fragmentation + the
                    # hbm_pressure heartbeat, same call the worker
                    # telemetry server makes; SLO attainment windows
                    # age-evict the same way (stale-attainment guard,
                    # core/slo.py).
                    from lws_tpu_torch.obs import device as devicemod

                    devicemod.refresh_device_memory()
                    slomod.RECORDER.refresh()
                    regs = (cp.metrics,) if cp.metrics is metricsmod.REGISTRY \
                        else (cp.metrics, metricsmod.REGISTRY)
                    text = metricsmod.render_exposition(*regs)
                    # Feed the process history ring ONLY when no fleet
                    # collector is wired (the fleet handler below is the
                    # richer source then, and two sources racing one
                    # interval gate would starve each other and flap the
                    # ring's live-series flags between shapes).
                    if getattr(cp, "fleet", None) is None:
                        from lws_tpu_torch.obs import history as historymod

                        historymod.HISTORY.ingest_if_due(text)
                    self._send_exposition(text)
                elif path == "/metrics/fleet":
                    # The aggregated fleet view: every ready worker's
                    # /metrics merged with instance/role/revision labels
                    # under the cardinality cap (runtime/fleet.py).
                    fleet = getattr(cp, "fleet", None)
                    if fleet is None:
                        self._json(404, {"error": "fleet collector not wired"})
                        return
                    from lws_tpu_torch.obs import history as historymod

                    # The instance-labelled fleet view is the control
                    # plane's history source: per-worker series ride the
                    # process ring (interval-gated). The thunk keeps the
                    # streaming bound honest: the whole-fleet text
                    # materializes only when an ingest interval is actually
                    # due (at most once per interval), never per scrape.
                    # Each fresh ingest also evaluates the process-default
                    # recommender, so
                    # `serving_scale_recommendation`/`serving_slo_burn_rate`
                    # and the `burn_rate` alert feed exist on every live
                    # deployment — published on the NEXT scrape, like every
                    # refresh-per-scrape gauge.
                    if historymod.HISTORY.ingest_if_due(
                            lambda: fleet.render_fleet()):
                        from lws_tpu_torch.obs import decisions as decisionsmod

                        try:
                            # The closed-loop decision step: evaluate the
                            # recommender (`current` re-synced from the
                            # store's DS roles) and the canary analyzer,
                            # actuate both planes through the defaults
                            # (kill-switched by LWS_TPU_ACTUATION_DISABLE),
                            # and sweep convergence. Every verdict lands in
                            # the decision ledger either way.
                            decisionsmod.evaluate_and_actuate(cp.store)
                        except Exception:  # vet: ignore[hazard-exception-swallow]: a decision-plane hiccup must never 500 the fleet scrape (BLE001 intended)
                            pass
                    self._stream_exposition(fleet.render_fleet_chunks())
                elif path == "/debug/traces":
                    from urllib.parse import parse_qs, urlparse

                    from lws_tpu_torch.core import trace as tracemod
                    from lws_tpu_torch.runtime.telemetry import parse_limit

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        limit = parse_limit(q)
                    except ValueError as e:
                        # 400, never a 500: non-integer AND negative limits
                        # are both caller errors.
                        self._json(400, {"error": f"bad limit: {e}"})
                        return
                    self._json(200, tracemod.TRACER.spans(limit))
                elif path == "/debug/flightrecorder":
                    from urllib.parse import parse_qs, urlparse

                    from lws_tpu_torch.core import flightrecorder as frmod
                    from lws_tpu_torch.runtime.telemetry import parse_limit

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        limit = parse_limit(q)
                    except ValueError as e:
                        self._json(400, {"error": f"bad limit: {e}"})
                        return
                    self._json(200, frmod.debug_snapshot(
                        limit, getattr(cp, "watchdog", None)
                    ))
                elif path in ("/debug/profile", "/debug/profile/fleet"):
                    from urllib.parse import parse_qs, urlparse

                    from lws_tpu_torch.core import profile as profmod
                    from lws_tpu_torch.runtime.telemetry import (
                        parse_limit,
                        parse_profile_format,
                    )

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        limit = parse_limit(q, default=512)
                        fmt = parse_profile_format(q)
                    except ValueError as e:
                        self._json(400, {"error": f"bad query: {e}"})
                        return
                    if path == "/debug/profile":
                        if fmt == "collapsed":
                            self._send(200, profmod.PROFILER.collapsed(limit),
                                       "text/plain")
                        else:
                            self._json(200, profmod.PROFILER.snapshot(limit))
                        return
                    # Fleet-merged: every ready worker's /debug/profile,
                    # instance/role-labelled like /metrics/fleet.
                    fleet = getattr(cp, "fleet", None)
                    if fleet is None:
                        self._json(404, {"error": "fleet collector not wired"})
                        return
                    sources = fleet.collect_profiles(limit)
                    if fmt == "collapsed":
                        self._send(200, profmod.merge_collapsed(sources),
                                   "text/plain")
                    else:
                        self._json(200, {"instances": [
                            {"labels": labels, "profile": snap}
                            for labels, snap in sources
                        ]})
                elif path in ("/debug/compile", "/debug/compile/fleet"):
                    from urllib.parse import parse_qs, urlparse

                    from lws_tpu_torch.obs import device as devicemod
                    from lws_tpu_torch.runtime.telemetry import parse_limit

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        limit = parse_limit(q)
                    except ValueError as e:
                        self._json(400, {"error": f"bad limit: {e}"})
                        return
                    if path == "/debug/compile":
                        self._json(200, devicemod.debug_compile(limit))
                        return
                    # Fleet-merged: every ready worker's /debug/compile
                    # plus the control plane's own leg, instance-labelled
                    # like /metrics/fleet, with a cross-fleet executables
                    # fold (runtime/fleet.py).
                    fleet = getattr(cp, "fleet", None)
                    if fleet is None:
                        self._json(404, {"error": "fleet collector not wired"})
                        return
                    self._json(200, fleet.collect_compiles(limit))
                elif path == "/debug/history":
                    from urllib.parse import parse_qs, urlparse

                    from lws_tpu_torch.obs import history as historymod
                    from lws_tpu_torch.runtime.telemetry import parse_limit

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        limit = parse_limit(q)
                    except ValueError as e:
                        self._json(400, {"error": f"bad limit: {e}"})
                        return
                    self._json(200, historymod.HISTORY.snapshot(limit))
                elif path == "/debug/rollout":
                    from urllib.parse import parse_qs, urlparse

                    from lws_tpu_torch.obs import rollout as rolloutmod
                    from lws_tpu_torch.runtime.telemetry import parse_limit

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        limit = parse_limit(q)
                    except ValueError as e:
                        self._json(400, {"error": f"bad limit: {e}"})
                        return
                    self._json(200, rolloutmod.LEDGER.snapshot(limit))
                elif path == "/debug/decisions":
                    from urllib.parse import parse_qs, urlparse

                    from lws_tpu_torch.obs import decisions as decisionsmod
                    from lws_tpu_torch.runtime.telemetry import parse_limit

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        limit = parse_limit(q)
                    except ValueError as e:
                        self._json(400, {"error": f"bad limit: {e}"})
                        return
                    self._json(200, decisionsmod.DECISIONS.snapshot(limit))
                elif path == "/debug/requests":
                    from urllib.parse import parse_qs, urlparse

                    from lws_tpu_torch.obs import journey as journeymod
                    from lws_tpu_torch.runtime.telemetry import parse_limit

                    q = parse_qs(urlparse(self.path).query)
                    outcome = q.get("outcome", ["all"])[0]
                    klass = q.get("klass", [""])[0]
                    revision = q.get("revision", [""])[0]
                    fleet = getattr(cp, "fleet", None)
                    try:
                        limit = parse_limit(q, default=32)
                        if fleet is not None:
                            # Fleet-joined index: every ready worker's
                            # retained journeys plus this process's, one
                            # worst-first table (runtime/fleet.py).
                            rows = fleet.collect_request_index(
                                outcome, klass, limit, revision=revision
                            )
                        else:
                            rows = journeymod.VAULT.index(
                                outcome=outcome, klass=klass, limit=limit,
                                revision=revision,
                            )
                    except ValueError as e:
                        # 400, never 500: bad limit/outcome are caller
                        # errors (parse_limit contract, both servers).
                        self._json(400, {"error": str(e)})
                        return
                    self._json(200, rows)
                elif path.startswith("/debug/request/"):
                    from urllib.parse import unquote

                    from lws_tpu_torch.obs import journey as journeymod

                    key = unquote(path[len("/debug/request/"):])
                    fleet = getattr(cp, "fleet", None)
                    if fleet is not None:
                        # Cross-process assembly: the trace ctx rode the KV
                        # frame meta, so every worker's local leg joins by
                        # request id into one connected tree.
                        body = fleet.collect_journeys(key)
                    else:
                        body = journeymod.local_journey(key)
                    if body is None:
                        self._json(404, {"error": f"no journey for {key!r}"})
                        return
                    self._json(200, body)
                elif path == "/debug/faults":
                    from lws_tpu_torch.core import faults as faultsmod

                    self._json(200, faultsmod.INJECTOR.snapshot())
                elif len(parts) == 2 and parts[0] == "apis":
                    try:
                        objs = cp.store.list(_kind(parts[1]))
                    except ValueError as e:
                        self._json(404, {"error": str(e)})
                        return
                    self._json(200, [to_manifest(o) for o in objs])
                elif len(parts) == 4 and parts[0] == "apis":
                    try:
                        obj = cp.store.try_get(_kind(parts[1]), parts[2], parts[3])
                    except ValueError as e:
                        self._json(404, {"error": str(e)})
                        return
                    if obj is None:
                        self._json(404, {"error": f"{parts[1]} {parts[2]}/{parts[3]} not found"})
                    else:
                        self._json(200, to_manifest(obj))
                elif parts[:1] == ["events"]:
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    ns = q.get("namespace", [None])[0]
                    name = q.get("name", [None])[0]
                    out = []
                    for ev in list(cp.recorder.events):  # snapshot: threads append
                        kind, ens, ename = ev.object_key
                        if ns is not None and ens != ns:
                            continue
                        if name is not None and ename != name:
                            continue
                        out.append({
                            "object": f"{kind}/{ens}/{ename}",
                            "type": ev.type,
                            "reason": ev.reason,
                            "message": ev.message,
                            "timestamp": ev.timestamp,
                        })
                    self._json(200, out)
                elif parts[:1] == ["watch"]:
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        since = int(q.get("since", ["0"])[0])
                        timeout = min(float(q.get("timeout", ["30"])[0]), 60.0)
                    except ValueError as e:
                        self._json(400, {"error": f"bad watch params: {e}"})
                        return
                    with events_cond:
                        if since < 0:  # bookmark request: where is "now"?
                            self._json(200, {"events": [], "next": seq_box["seq"]})
                            return
                        oldest = events[0]["seq"] if events else seq_box["seq"] + 1
                        if since > seq_box["seq"] or (
                            since + 1 < oldest and seq_box["seq"] > since
                        ):
                            # Bookmark from the future (server restarted) or
                            # fallen out of the ring: client must relist
                            # (k8s 410 Gone on an unknown resourceVersion).
                            self._json(200, {"expired": True, "next": seq_box["seq"]})
                            return
                        if seq_box["seq"] <= since:
                            events_cond.wait(timeout)
                        batch = [e for e in events if e["seq"] > since]
                    nxt = batch[-1]["seq"] if batch else since
                    self._json(200, {"events": batch, "next": nxt})
                elif len(parts) == 3 and parts[0] == "logs":
                    provider = getattr(cp, "log_provider", None)
                    logs = provider(parts[1], parts[2]) if provider else None
                    if logs is None:
                        self._json(404, {"error": f"no logs for {parts[1]}/{parts[2]}"})
                    else:
                        self._send(200, logs, "text/plain")
                else:
                    self._json(404, {"error": "unknown path"})

            def do_DELETE(self):
                path = self.path.split("?", 1)[0]
                parts = [p for p in path.split("/") if p]
                if len(parts) == 4 and parts[0] == "apis":
                    try:
                        cp.store.delete(_kind(parts[1]), parts[2], parts[3])
                    except (ValueError, NotFoundError) as e:
                        self._json(404, {"error": str(e)})
                        return
                    self._json(200, {"deleted": f"{parts[1]}/{parts[2]}/{parts[3]}"})
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length).decode()
                path = self.path.split("?", 1)[0]
                parts = [p for p in path.split("/") if p]
                if path == "/debug/faults":
                    from lws_tpu_torch.core import faults as faultsmod

                    try:
                        payload = json.loads(body) if body else {}
                        result = faultsmod.apply_control(payload)
                    except ValueError as e:
                        # 400, never 500: bad specs/JSON are caller errors
                        # (same contract as the other debug surfaces).
                        self._json(400, {"error": str(e)})
                        return
                    self._json(200, result)
                    return
                try:
                    if (len(parts) == 5 and parts[0] == "apis"
                            and parts[4] == "apply"):
                        # Server-side apply (k8s PATCH application/apply-patch
                        # analog): body = partial plain field tree; query
                        # carries fieldManager + force. 409 on field
                        # conflicts so clients can distinguish them from rv
                        # races.
                        from urllib.parse import parse_qs

                        q = (parse_qs(self.path.split("?", 1)[1])
                             if "?" in self.path else {})
                        manager = (q.get("fieldManager") or ["default"])[0]
                        force = (q.get("force") or ["false"])[0].lower() == "true"
                        try:
                            stored = cp.store.apply(
                                _kind(parts[1]), parts[2], parts[3],
                                json.loads(body), field_manager=manager,
                                force=force,
                            )
                        except FieldManagerConflict as e:
                            self._json(409, {"error": str(e), "conflicts": [
                                {"field": ".".join(pth), "manager": owner}
                                for pth, owner in e.conflicts
                            ]})
                            return
                        self._json(200, to_manifest(stored))
                    elif parts[:1] == ["apply"]:
                        import yaml

                        applied = []
                        for doc in yaml.safe_load_all(body):
                            if not doc:
                                continue
                            obj = from_manifest(doc)

                            def attempt(obj=obj):
                                existing = cp.store.try_get(
                                    obj.kind, obj.meta.namespace, obj.meta.name
                                )
                                if existing is None:
                                    return cp.store.create(obj)
                                obj.meta.resource_version = existing.meta.resource_version
                                obj.meta.uid = existing.meta.uid
                                # Spec-only apply: never wipe live status.
                                if hasattr(existing, "status"):
                                    obj.status = existing.status
                                return cp.store.update(obj)

                            stored = _retry_conflicts(
                                attempt, f"apply of {obj.kind}/{obj.meta.name}"
                            )
                            applied.append(f"{stored.kind}/{stored.meta.name}")
                        self._json(200, {"applied": applied})
                    elif len(parts) == 3 and parts[0] == "scale":
                        replicas = int(json.loads(body)["replicas"])

                        def attempt():
                            lws = cp.store.get("LeaderWorkerSet", parts[1], parts[2])
                            lws.spec.replicas = replicas
                            cp.store.update(lws)

                        _retry_conflicts(attempt, f"scale of {parts[2]}")
                        self._json(200, {"scaled": parts[2], "replicas": replicas})
                    elif len(parts) == 3 and parts[0] == "report-metric":
                        # Workload-side metric push: annotates the pod so the
                        # autoscaler's HPA loop can read it.
                        from lws_tpu_torch.api.autoscaler import METRIC_ANNOTATION_PREFIX

                        payload = json.loads(body)
                        if not isinstance(payload, dict) or not all(
                            isinstance(v, (int, float)) for v in payload.values()
                        ):
                            raise ValueError(
                                "report-metric body must be a JSON object of numbers"
                            )
                        def attempt():
                            pod = cp.store.get("Pod", parts[1], parts[2])
                            for metric, value in payload.items():
                                pod.meta.annotations[METRIC_ANNOTATION_PREFIX + metric] = str(
                                    float(value)
                                )
                            cp.store.update(pod)

                        _retry_conflicts(attempt, "metric report")
                        self._json(200, {"reported": payload})
                    else:
                        self._json(404, {"error": "unknown path"})
                except (AdmissionError, ValueError) as e:
                    self._json(422, {"error": str(e)})
                except (ConflictError, AlreadyExistsError) as e:
                    self._json(409, {"error": str(e)})
                except NotFoundError as e:
                    self._json(404, {"error": str(e)})
                except (TypeError, KeyError, AttributeError) as e:
                    # Malformed manifest/payload shapes must come back as a
                    # JSON error, not a dropped connection.
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port

    def start(self) -> None:
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._unwatch()  # stop serializing store events into a dead buffer
