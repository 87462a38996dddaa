"""Worker telemetry server: the port of lws_tpu/runtime/telemetry.py, the
per-process /metrics and debug surface the control plane's fleet scraper
aggregates.

A serving worker (the disaggregated prefill and decode roles) exposes its
process-default registries over one small HTTP server, with the JAX
worker's routes, status codes and bodies:

  GET /metrics               process metrics.REGISTRY, Prometheus text
                             (OpenMetrics with exemplars when asked for);
                             the card's in-use/peak/limit bytes are read
                             per scrape (obs/device.refresh_device_memory)
  GET /debug/traces?limit=N  recent spans from the process trace.TRACER
  GET /debug/flightrecorder  the flight-recorder snapshot (ring, heartbeats,
                             the watchdog's alerts and last dump)
  GET /debug/profile         the process profiler's collapsed-stack table
                             (?format=collapsed for raw flamegraph input,
                             ?limit=N keeps the heaviest N stacks)
  GET /debug/history         the process history ring (obs/history.py)
  GET /debug/decisions       the process decision ledger window
                             (obs/decisions.py): provenance records of the
                             actuation planes; a worker records none unless
                             it runs an actuator itself
  GET /debug/requests        the journey index, worst first (obs/journey.py;
                             ?outcome=, ?klass=, ?revision=, ?limit=)
  GET /debug/request/<id>    one request's local journey leg, by request or
                             trace id (the vault first, the span ring second)
  GET /debug/prefixes        the prefix-cache digest advertisement
                             (serving/kv_host_arena.py)
  GET /debug/compile         the compile ledger (obs/device.py)
  GET  /debug/faults         armed fault points + hit/trip counters
  POST /debug/faults         arm/disarm fault schedules in this process
                             ({"arm": {point: spec}}, {"disarm": [...]},
                             {"clear": true} — core/faults.py grammar)
  POST /debug/drain          request graceful drain: the worker loop stops
                             admitting, finishes in-flight work, exits
                             clean (core/resilience.py DrainGate)
  GET /healthz               liveness

Every `?limit=N` must be an integer >= 0 (`parse_limit`): anything else,
an unknown profile format or journey outcome, or a bad fault spec answers
400 with a JSON error, never 500. An unknown path answers 404.

Workers declare the port via LWS_TPU_METRICS_PORT in their pod env (the
containerPort analog the fleet collector reads from the pod spec, like the
KV endpoint's LWS_TPU_KV_PORT); port 0 binds an ephemeral port. A declared
port that cannot be bound fails the worker at start. When
LWS_TPU_METRICS_TOKEN is set, everything except /healthz requires
`Authorization: Bearer <token>` (401 without it).

start_from_env also starts the journey vault's feeds, the history sampler,
the compile ledger, the continuous profiler (at LWS_TPU_PROFILE_HZ) and a
worker-side Watchdog over the process flight recorder, so a wedged decode
ring, a KV backlog or an open breaker in a worker trips `lws_watchdog_*`
(which ride the fleet scrape) and captures a dump. Left out: the JAX
server's `respond_delay_s`, a stand-in for network delay that only its
fleet simulation uses.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

from lws_tpu_torch.core import faults as faultsmod
from lws_tpu_torch.core import flightrecorder as frmod
from lws_tpu_torch.core import metrics as metricsmod
from lws_tpu_torch.core import profile as profmod
from lws_tpu_torch.core import resilience as resmod
from lws_tpu_torch.core import slo as slomod
from lws_tpu_torch.core import trace as tracemod
from lws_tpu_torch.obs import decisions as decisionsmod
from lws_tpu_torch.obs import device as devicemod
from lws_tpu_torch.obs import history as historymod
from lws_tpu_torch.obs import journey as journeymod

METRICS_PORT_ENV = "LWS_TPU_METRICS_PORT"
METRICS_TOKEN_ENV = "LWS_TPU_METRICS_TOKEN"


def parse_limit(query: dict, default: int = 256) -> int:
    """Parse a ?limit=N value: non-integer or negative raises ValueError
    (callers answer 400 — malformed input must never 500 a debug surface)."""
    raw = query.get("limit", [str(default)])[0]
    limit = int(raw)  # ValueError on non-integer
    if limit < 0:
        raise ValueError(f"limit must be >= 0, got {limit}")
    return limit


PROFILE_FORMATS = ("json", "collapsed")


def parse_profile_format(query: dict) -> str:
    """Parse a /debug/profile ?format= value; unknown formats raise
    ValueError (same 400-never-500 contract as parse_limit)."""
    fmt = query.get("format", ["json"])[0]
    if fmt not in PROFILE_FORMATS:
        raise ValueError(
            f"format must be one of {', '.join(PROFILE_FORMATS)}, got {fmt!r}"
        )
    return fmt


def _render_process_metrics() -> str:
    """The process exposition: device-memory gauges and the SLO attainment
    windows are state, refreshed per scrape (a quiet engine must not
    advertise stale attainment); the scrape also feeds the history ring
    (interval-gated), so history accrues at scrape cadence even without
    the sampling thread."""
    devicemod.refresh_device_memory()
    slomod.RECORDER.refresh()
    text = metricsmod.REGISTRY.render()
    historymod.HISTORY.ingest_if_due(text)
    return text


# GET routes whose body is one JSON document over a parsed ?limit=N (the
# 400 contract's shared shape): path -> (default limit, body of limit).
_LIMITED_ROUTES = {
    "/debug/traces": (256, lambda n: tracemod.TRACER.spans(n)),
    "/debug/history": (256, lambda n: historymod.HISTORY.snapshot(n)),
    "/debug/decisions": (256, lambda n: decisionsmod.DECISIONS.snapshot(n)),
    "/debug/compile": (256, lambda n: devicemod.debug_compile(n)),
}


class TelemetryServer:
    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 watchdog=None, token: Optional[str] = None,
                 registry=None) -> None:
        """`watchdog` (a flightrecorder.Watchdog) contributes alerts and the
        last diagnostics dump to /debug/flightrecorder; `token` gates every
        path except /healthz behind `Authorization: Bearer <token>`.
        `registry` overrides the process-default metrics surface: /metrics
        serves `registry.render()` and skips the process-global side effects
        (device-memory refresh, SLO window refresh, history-ring feed)."""
        self.watchdog = watchdog
        outer = self

        class Handler(BaseHTTPRequestHandler):
            sys_version = ""

            def log_message(self, *args):  # quiet
                pass

            def _authorized(self) -> bool:
                if token is None:
                    return True
                return self.headers.get("Authorization") == f"Bearer {token}"

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code: int, body, **kw) -> None:
                self._send(code, json.dumps(body, **kw), "application/json")

            def do_GET(self):  # noqa: N802 — the http.server hook
                parsed = urlparse(self.path)
                path, q = parsed.path, parse_qs(parsed.query)
                if path == "/healthz":
                    self._send(200, "ok", "text/plain")
                    return
                if not self._authorized():
                    self._json(401, {"error": "unauthorized"})
                    return
                if path == "/metrics":
                    text = registry.render() if registry is not None \
                        else _render_process_metrics()
                    body, ctype = metricsmod.negotiate_exposition(
                        text, self.headers.get("Accept"))
                    self._send(200, body, ctype)
                elif path == "/debug/profile":
                    try:
                        limit = parse_limit(q, default=512)
                        fmt = parse_profile_format(q)
                    except ValueError as e:
                        self._json(400, {"error": f"bad query: {e}"})
                        return
                    if fmt == "collapsed":
                        self._send(200, profmod.PROFILER.collapsed(limit), "text/plain")
                    else:
                        self._json(200, profmod.PROFILER.snapshot(limit))
                elif path in _LIMITED_ROUTES or path in ("/debug/flightrecorder",
                                                         "/debug/prefixes"):
                    try:
                        limit = parse_limit(q)
                    except ValueError as e:
                        self._json(400, {"error": f"bad limit: {e}"})
                        return
                    if path == "/debug/flightrecorder":
                        body = frmod.debug_snapshot(limit, outer.watchdog)
                    elif path == "/debug/prefixes":
                        # Lazy: the serving stack (and torch) loads only in
                        # a process that serves prefixes.
                        from lws_tpu_torch.serving import kv_host_arena

                        body = kv_host_arena.debug_prefixes(limit)
                    else:
                        body = _LIMITED_ROUTES[path][1](limit)
                    self._json(200, body, default=str)
                elif path == "/debug/requests":
                    # The journey index: tail-retained requests by outcome
                    # (breached / slowest / errored / ...), worst first.
                    try:
                        limit = parse_limit(q, default=32)
                        rows = journeymod.VAULT.index(
                            outcome=q.get("outcome", ["all"])[0],
                            klass=q.get("klass", [""])[0],
                            limit=limit,
                            revision=q.get("revision", [""])[0],
                        )
                    except ValueError as e:
                        self._json(400, {"error": str(e)})
                        return
                    self._json(200, rows, default=str)
                elif path.startswith("/debug/request/"):
                    key = unquote(path[len("/debug/request/"):])
                    body = journeymod.local_journey(key)
                    if body is None:
                        self._json(404, {"error": f"no journey for {key!r}"})
                        return
                    self._json(200, body, default=str)
                elif path == "/debug/faults":
                    self._json(200, faultsmod.INJECTOR.snapshot())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):  # noqa: N802 — the http.server hook
                path = urlparse(self.path).path
                if not self._authorized():
                    self._json(401, {"error": "unauthorized"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length).decode() if length else ""
                if path == "/debug/faults":
                    try:
                        payload = json.loads(body) if body else {}
                        result = faultsmod.apply_control(payload)
                    except ValueError as e:
                        # 400, never 500: bad specs/JSON are caller errors.
                        self._json(400, {"error": str(e)})
                        return
                    self._json(200, result)
                elif path == "/debug/drain":
                    accepted = resmod.DRAIN.request("debug-endpoint")
                    self._json(200, {"draining": accepted})
                else:
                    self._json(404, {"error": "unknown path"})

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # The default backlog (5) drops SYNs when a fleet scraper's burst
            # lands while the accept loop waits on the GIL; the kernel's
            # 1s/2s/4s retransmit ladder then turns a 50ms scrape into
            # seconds. Queue the burst instead.
            request_queue_size = 128

            def handle_error(self, request, client_address):
                # A scraper hanging up mid-response (its timeout fired) is
                # the client's failure accounting, not a server traceback;
                # everything else keeps the stock stderr report.
                if isinstance(sys.exc_info()[1], (BrokenPipeError, ConnectionResetError)):
                    return
                super().handle_error(request, client_address)

        self._httpd = _Server((host, port), Handler)
        self.port = self._httpd.server_port

    def start(self) -> None:
        # 0.1s poll (not serve_forever's 0.5s default): shutdown() blocks
        # until the serve loop's next poll.
        threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.1),
            daemon=True,
        ).start()
        if self.watchdog is not None:
            self.watchdog.start()

    def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        self._httpd.shutdown()
        self._httpd.server_close()


def start_from_env() -> Optional[TelemetryServer]:
    """Start the telemetry server on the pod-declared port, with a
    worker-side Watchdog evaluating the default rules over this process's
    heartbeats; None when the env doesn't declare a port (telemetry is
    opt-in per pod spec). Before the server it starts the continuous
    profiler when LWS_TPU_PROFILE_HZ declares a rate, the journey vault's
    feeds (LWS_TPU_JOURNEYS=0 disables), the history ring's sampling thread
    (LWS_TPU_HISTORY_INTERVAL_S; 0 leaves only the per-scrape feed) and the
    compile ledger (LWS_TPU_COMPILE_LEDGER=0 disables). A port that cannot
    be bound raises."""
    raw = os.environ.get(METRICS_PORT_ENV)
    if not raw:
        return None
    profmod.start_from_env()
    journeymod.install()
    historymod.start_from_env()
    devicemod.arm_from_env()
    server = TelemetryServer(
        port=int(raw),
        watchdog=frmod.Watchdog(),
        token=os.environ.get(METRICS_TOKEN_ENV) or None,
    )
    server.start()
    return server
