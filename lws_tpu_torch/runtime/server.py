"""HTTP API server: the remote face of the control plane
(≈ the apiserver+webhook endpoint + healthz/readyz + metrics of
cmd/main.go:252-262,336-348 rolled into one in-process server).

The port's copy of lws_tpu/runtime/server.py, trimmed. Left out, each
waiting for its ROADMAP Queue 1 item: `/metrics/fleet` and the `/debug/*`
routes (the fleet collector, item (a)); `POST /report-metric` (the
autoscaler, item (b)); TLS and bearer-token auth (`tls=`, `auth=` raise,
item (c)); `POST /cordon` and `POST /drain` (item (d)). A left-out route
answers 404 "unknown path", as any unknown path does.

Endpoints:
  GET  /healthz | /readyz             liveness/readiness
  GET  /metrics                       Prometheus text (control plane +
                                      process serving registry, one valid
                                      exposition)
  POST /apply                         YAML/JSON manifest (create-or-update)
  POST /apis/{kind}/{ns}/{name}/apply server-side apply of a partial field
                                      tree (?fieldManager=&force=)
  GET  /apis/{kind}                   list (JSON manifests)
  GET  /apis/{kind}/{ns}/{name}       get
  DELETE /apis/{kind}/{ns}/{name}     delete
  POST /scale/{ns}/{name}             {"replicas": N} on a LeaderWorkerSet
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


# Autoscaler stays a known kind, so listings and errors read as JAX's; the
# port never stores one (manifest.from_manifest refuses it).
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
                    self._send_exposition(text)
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
                    else:
                        self._json(404, {"error": "unknown path"})
                except NotImplementedError as e:
                    # A kind or route the port has not taken over yet.
                    self._json(501, {"error": str(e)})
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
