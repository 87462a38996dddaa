"""The port's fleet plane (lws_tpu_torch: core/metrics.py's fleet merge,
runtime/fleet.py's FleetCollector, and the API server's /metrics/fleet,
/debug/* and /report-metric routes) against the JAX package's, on the CPU.

- `merge_expositions` and `StreamingMerger`: the sources of
  tests/test_streaming_merge.py (its seeds and caps), rendered by each
  package's registry, merge byte for byte alike, chunk for chunk.
- `FleetCollector`: port workers' telemetry servers registered as ready
  pods in a JAX store and in a port store; each package's collector
  scrapes the same servers. The merged text, the collector's own counters
  and gauges (its wall-clock `lws_fleet_shard_scrape_seconds` aside), a
  worker that stops answering (errors, then backoff), and a poisoned shard
  are equal.
- The API servers: a JAX ApiServer over a JAX ControlPlane and a port
  ApiServer over a port ControlPlane hold the same objects and equal
  process planes; every fleet and debug route and `/report-metric` answer
  with the same codes and bodies.

Normalized, and only these: `uid`, `resourceVersion` and
`last_transition_time` in manifests, and the wall stamps `unix`,
`completed_unix`, `captured_unix`, `start_unix` and `timestamp` (and the
monotonic `at` of rollout-ledger entries the store feeds), which no
injected clock reaches.

`port_planes_restored` puts back the port's process-global planes that an
ApiServer's /metrics/fleet and a ControlPlane mutate, as
`jax_planes_restored` (tests/test_torch_cli.py) does for the JAX
package's; every test here that runs a server takes both.
"""

from __future__ import annotations

import copy
import json
import random
import time
from types import SimpleNamespace

import pytest

from lws_tpu.api import pod as jpod
from lws_tpu.core import faults as jfaults
from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import store as jstore
from lws_tpu.obs import decisions as jdecisions
from lws_tpu.obs import device as jdevice
from lws_tpu.obs import history as jhistory
from lws_tpu.obs import journey as jjourney
from lws_tpu.obs import rollout as jrollout
from lws_tpu.runtime import fleet as jfleet
from lws_tpu_torch.api import pod as ppod
from lws_tpu_torch.core import faults as pfaults
from lws_tpu_torch.core import metrics as pmetrics
from lws_tpu_torch.core import store as pstore
from lws_tpu_torch.obs import decisions as pdecisions
from lws_tpu_torch.obs import device as pdevice
from lws_tpu_torch.obs import history as phistory
from lws_tpu_torch.obs import journey as pjourney
from lws_tpu_torch.obs import recommend as precommend
from lws_tpu_torch.obs import rollout as prollout
from lws_tpu_torch.runtime import fleet as pfleet
from lws_tpu_torch.runtime.telemetry import TelemetryServer
from tests.test_torch_cli import _guarded, _restore, jax_planes_restored  # noqa: F401

# Every test here leaves the port's process planes as it found them
# (tests/test_torch_fleet.py:port_planes_restored).
pytestmark = pytest.mark.usefixtures("port_planes_restored")

JAX = SimpleNamespace(name="jax", metrics=jmetrics, fleet=jfleet, pod=jpod, store=jstore,
                      history=jhistory, rollout=jrollout, decisions=jdecisions,
                      journey=jjourney, device=jdevice, faults=jfaults)
PORT = SimpleNamespace(name="port", metrics=pmetrics, fleet=pfleet, pod=ppod, store=pstore,
                       history=phistory, rollout=prollout, decisions=pdecisions,
                       journey=pjourney, device=pdevice, faults=pfaults)
WALL_KEYS = frozenset({"uid", "resourceVersion", "last_transition_time", "unix",
                       "completed_unix", "captured_unix", "start_unix", "timestamp"})


def normalize(x, keys=WALL_KEYS):
    if isinstance(x, dict):
        return {k: ("<normalized>" if k in keys else normalize(v, keys)) for k, v in x.items()}
    if isinstance(x, list):
        return [normalize(v, keys) for v in x]
    return x


def journey_feeds(journey, trace, fr, slo) -> dict:
    """Whether each of a package's journey VAULT feeds is wired onto its
    process tracer, flight recorder and SLO recorder, and `_INSTALLED`."""
    v = journey.VAULT
    return {"span": v.on_span in trace.TRACER._finish_listeners,
            "event": v.on_event in fr.RECORDER._observers,
            "timeline": v.on_timeline in slo.RECORDER.journey_sinks,
            "installed": journey._INSTALLED}


def restore_journey_feeds(found: dict, journey, trace, fr, slo) -> None:
    """Take off the feeds `found` (journey_feeds) did not hold, reset
    `_INSTALLED`, and clear the VAULT."""
    v = journey.VAULT
    if not found["span"]:
        trace.TRACER.remove_finish_listener(v.on_span)
    if not found["event"]:
        fr.RECORDER.remove_observer(v.on_event)
    if not found["timeline"]:
        while v.on_timeline in slo.RECORDER.journey_sinks:
            slo.RECORDER.journey_sinks.remove(v.on_timeline)
    journey._INSTALLED = found["installed"]
    v.clear()


@pytest.fixture
def port_planes_restored():
    """The port's process-global planes that an ApiServer's /metrics/fleet
    drives and a ControlPlane feeds are left as found: the process HISTORY
    (with its interval gate), the rollout LEDGER, the DECISIONS ledger, and
    the default ANALYZER, RECOMMENDER and actuators. So are the journey
    plane an ApiServer or TelemetryServer installs (the VAULT's feeds on the
    process tracer, flight recorder and SLO recorder, and
    `journey._INSTALLED`; the VAULT is cleared) and the fault INJECTOR
    (disarmed): left wired, the feeds open journeys for the spans of a
    later test in the same process."""
    from lws_tpu_torch.core import flightrecorder, slo, trace

    state = [(obj, _guarded(obj, names)) for obj, names in (
        (phistory.HISTORY, ("_series", "_per_source", "_last_ingest_t", "_last_ingest_keys",
                            "_dropped")),
        (prollout.LEDGER, ("_entries", "_per_kind", "_state")),
        (pdecisions.DECISIONS, ("_records", "_by_id", "_seq", "_last_direction",
                                "_last_sig")),
    )]
    defaults = [(m, n, getattr(m, n)) for m, n in (
        (prollout, "ANALYZER"), (precommend, "RECOMMENDER"), (pdecisions, "ACTUATOR"),
        (pdecisions, "ROLLOUT_ACTUATOR"))]
    planes = (pjourney, trace, flightrecorder, slo)
    feeds = journey_feeds(*planes)
    yield
    for obj, saved in state:
        _restore(obj, saved)
    for m, n, v in defaults:
        setattr(m, n, v)
    restore_journey_feeds(feeds, *planes)
    pfaults.INJECTOR.disarm()


# ---------------------------------------------------------------------------
# The merge, byte for byte (tests/test_streaming_merge.py's sources)

_FAMILIES = (
    ("serving_requests_total", "counter"),
    ("serving_active_slots", "gauge"),
    ("serving_ttft_seconds", "histogram"),
    ("zz_custom_total", "counter"),
    ("aa_first_total", "counter"),
)
_VALUES = ("paged", "a.b-c", "ns/pod-0", "rev:12", "w\\x", "chat", "")


def _random_source(m, rng: random.Random, i: int) -> tuple[dict, str]:
    reg = m.MetricsRegistry(max_label_sets=64)
    for _ in range(rng.randrange(1, 12)):
        fam, kind = _FAMILIES[rng.randrange(len(_FAMILIES))]
        labels = {}
        for k in ("engine", "klass", "path")[: rng.randrange(3)]:
            labels[k] = _VALUES[rng.randrange(len(_VALUES))]
        if kind == "counter":
            reg.inc(fam, labels, float(rng.randrange(1, 100)))
        elif kind == "gauge":
            reg.set(fam, rng.random() * 10, labels)
        else:
            exemplar = None
            if rng.random() < 0.5:
                exemplar = {"trace_id": f"t{i}-{rng.randrange(999)}"}
            reg.observe(fam, rng.random() * 2, labels, exemplar=exemplar)
    extra = {"instance": f"w{i}"}
    if rng.random() < 0.5:
        extra["role"] = "prefill" if rng.random() < 0.5 else "decode"
    return extra, reg.render()


def _sources(m, case: str) -> tuple[list, dict]:
    """One case of tests/test_streaming_merge.py: (sources, merge kwargs),
    drawn through package `m`'s registry."""
    kind, _, arg = case.partition(":")
    if kind == "oracle":
        rng = random.Random(f"merge:{arg}")
        return [_random_source(m, rng, i) for i in range(rng.randrange(1, 7))], {}
    if kind == "cap":
        seed, cap = arg.split("/")
        rng = random.Random(f"cap:{seed}")
        return ([_random_source(m, rng, i) for i in range(rng.randrange(2, 6))],
                {"max_label_sets": int(cap)})
    if kind == "tier":
        rng = random.Random(f"tier:{arg}")
        shards = []
        for s in range(3):
            members = [_random_source(m, rng, s * 10 + i) for i in range(3)]
            shards.append(({}, m.merge_expositions(members, max_label_sets=2)))
        return shards, {}
    if kind == "dedup":
        return [({"instance": f"w{i}"}, "# HELP zz_custom_total custom\n# TYPE zz_custom_total "
                 "counter\nzz_custom_total 1.0\n") for i in range(4)], {}
    if kind == "exemplar":
        reg = m.MetricsRegistry()
        reg.observe("serving_ttft_seconds", 0.07, {"engine": "paged", "path": "a\\b/c.d:e"},
                    exemplar={"trace_id": "abc123"})
        return [({"instance": "w0"}, reg.render())], {}
    if kind == "uncapped":
        return [({"instance": f"w{i:04d}"}, "serving_requests_total 1.0\n")
                for i in range(600)], {"max_label_sets": None}
    if kind == "empty":
        return [({}, "")], {}
    assert kind == "chunks", case
    rng = random.Random("chunks")
    return [_random_source(m, rng, i) for i in range(4)], {}


MERGE_CASES = ([f"oracle:{s}" for s in range(8)]
               + [f"cap:{s}/{c}" for s in range(8) for c in (1, 2, 512)]
               + [f"tier:{s}" for s in range(4)]
               + ["dedup", "exemplar", "uncapped", "empty", "chunks"])


@pytest.mark.parametrize("case", MERGE_CASES)
def test_the_fleet_merge_is_jax_s_byte_for_byte(case):
    (jsrc, kw), (psrc, _) = _sources(jmetrics, case), _sources(pmetrics, case)
    assert psrc == jsrc  # the two registries render alike
    want = jmetrics.merge_expositions(jsrc, **kw)
    assert pmetrics.merge_expositions(psrc, **kw) == want
    # The streaming merger: uncapped by default (the fleet root), the
    # oracle's cap given.
    skw = {} if kw.get("max_label_sets", 512) is None else {
        "max_label_sets": kw.get("max_label_sets", 512)}
    jchunks = list(jmetrics.StreamingMerger(**skw).merge(jsrc))
    pchunks = list(pmetrics.StreamingMerger(**skw).merge(psrc))
    assert pchunks == jchunks and "".join(pchunks) == want


@pytest.mark.parametrize("drop", [True, False])
def test_a_malformed_shard_is_dropped_or_refused_as_jax_s(drop):
    bad = ({"instance": "w-broken"}, "serving_requests_total{ 1.0\ntotal garbage }{\n")
    out = {}
    for side in (JAX, PORT):
        rng = random.Random("broken")
        good = [_random_source(side.metrics, rng, i) for i in range(3)]
        merger = side.metrics.StreamingMerger(drop_malformed=drop)
        try:
            text = "".join(merger.merge([good[0], bad, good[1], good[2]]))
            out[side.name] = (text, merger.dropped_sources)
        except ValueError as e:
            out[side.name] = ("ValueError", str(e))
    assert out["port"] == out["jax"]
    assert (out["port"][1] == [1]) is drop


# ---------------------------------------------------------------------------
# FleetCollector over the port's workers' telemetry servers

ROLES = ("prefill", "decode", "decode")


def worker_registry(i: int):
    """Worker i's exposition (no exemplars: a scrape consumes them, and
    both packages' collectors scrape the same servers)."""
    reg = pmetrics.MetricsRegistry()
    reg.inc("serving_requests_total", {"engine": "disagg"}, 3.0 + i)
    reg.inc("serving_kv_transfer_bytes_total", {"role": ROLES[i]}, 1000.0 * (i + 1))
    reg.set("serving_active_slots", float(i), {"engine": "disagg"})
    reg.observe("serving_ttft_seconds", 0.01 * (i + 1), {"engine": "disagg"})
    return reg


def control_registry(m):
    reg = m.MetricsRegistry()
    reg.inc("lws_reconcile_total", {"controller": "leaderworkerset"}, 7.0)
    return reg


def add_worker_pod(side, store, name: str, role: str, port: int, ready: bool = True) -> None:
    from lws_tpu_torch.api.disagg import DS_REVISION_LABEL_KEY, DS_ROLE_LABEL_KEY

    p = side.pod
    pod = p.Pod(meta=side.store.new_meta(name), spec=p.PodSpec(containers=[p.Container(
        name="w", command=["sleep", "1"], env=[p.EnvVar("LWS_TPU_METRICS_PORT", str(port))])]))
    pod.meta.labels.update({DS_ROLE_LABEL_KEY: role, DS_REVISION_LABEL_KEY: "r1"})
    pod.status.phase = p.PodPhase.RUNNING
    pod.status.ready = ready
    pod.status.address = "127.0.0.1"
    store.create(pod)


@pytest.fixture
def workers(port_planes_restored):
    servers = []
    for i in range(len(ROLES)):
        srv = TelemetryServer(port=0, host="127.0.0.1", registry=worker_registry(i))
        srv.start()
        servers.append(srv)
    yield servers
    for srv in servers:
        try:
            srv.stop()
        except OSError:
            pass


def collectors(servers) -> dict:
    """{side: (collector, its own registry)} over one store per package
    holding the workers as ready pods (and one unready pod, never scraped)."""
    out = {}
    for side in (JAX, PORT):
        store = side.store.Store()
        for i, srv in enumerate(servers):
            add_worker_pod(side, store, f"w{i}", ROLES[i], srv.port)
        add_worker_pod(side, store, "w-unready", "decode", 1, ready=False)
        own = side.metrics.MetricsRegistry()
        out[side.name] = (side.fleet.FleetCollector(
            store, control_registries=(control_registry(side.metrics),),
            metrics_registry=own, cache_ttl_s=0.0, timeout_s=2.0), own)
    return out


def own_state(reg) -> dict:
    """The collector's own families, its wall-clock shard timing aside."""
    fams = pmetrics.parse_exposition(reg.render())
    fams.pop("lws_fleet_shard_scrape_seconds", None)
    return fams


def test_the_collector_merges_the_workers_as_jax_s_does(workers):
    cs = collectors(workers)
    texts = {name: fc.render_fleet() for name, (fc, _) in cs.items()}
    assert texts["port"] == texts["jax"]
    fams = pmetrics.parse_exposition(texts["port"])
    instances = {lb.get("instance") for f in fams.values() for _, lb, _, _ in f["samples"]}
    assert instances == {"w0", "w1", "w2", "control-plane"}
    assert own_state(cs["port"][1]) == own_state(cs["jax"][1])
    assert {n: [(lb, src) for lb, src in fc.collect(now=10.0)] for n, (fc, _) in cs.items()
            }["port"] == [(lb, src) for lb, src in cs["jax"][0].collect(now=10.0)]
    assert (cs["port"][0].targets() == [(lb, ep) for lb, ep in cs["jax"][0].targets()])


def test_a_dead_worker_fails_alone_then_backs_off_as_jax_s(workers):
    cs = collectors(workers)
    workers[1].stop()
    passes = {}
    for name, (fc, own) in cs.items():
        got = []
        for now in (100.0, 100.5, 103.0):  # miss, skipped in backoff, redial past 2 s
            sources = fc.collect(now=now)
            got.append(([lb["instance"] for lb, _ in sources], fc.in_backoff("w1", now + 0.1),
                        own_state(own)))
        passes[name] = got
    assert passes["port"] == passes["jax"]
    first, skipped, redial = passes["port"]
    assert "w1" not in first[0] and {"w0", "w2"} <= set(first[0])
    assert skipped[1] is True
    errors = first[2]["lws_fleet_scrape_errors_total"]["samples"]
    assert [(lb, v) for _, lb, v, _ in errors] == [({"instance": "w1"}, 1.0)]
    assert skipped[2]["lws_fleet_scrape_skipped_total"]["samples"][0][2] == 1.0
    assert redial[2]["lws_fleet_scrape_errors_total"]["samples"][0][2] == 2.0


def test_a_poisoned_shard_is_dropped_and_counted_as_jax_s(workers):
    out = {}
    for name, (fc, own) in collectors(workers[:1]).items():
        fc.cache_ttl_s = 3600.0
        fc._shard_cache["prefill-0"] = {
            "text": "garbage { text\n", "at": time.monotonic(), "members": ("w0",),
            "scraped": 1, "failed": 0, "skipped": 0}
        text = fc.render_fleet()
        out[name] = (text, own_state(own)["lws_fleet_shards_dropped_total"])
    assert out["port"] == out["jax"]
    assert "lws_reconcile_total" in out["port"][0] and "w0" not in out["port"][0]


# ---------------------------------------------------------------------------
# The API servers' fleet, debug and report-metric routes

T0 = 1000.0
DECISION_CLOCK = frozenset({"at", "last_at", "acted_at", "converged_at"})


def seed_planes(side) -> None:
    """Equal contents in one package's process planes (cleared first)."""
    side.history.HISTORY.clear()
    side.rollout.LEDGER.clear()
    side.decisions.DECISIONS.clear()
    side.device.LEDGER.clear()
    side.faults.INJECTOR.disarm()
    side.journey.VAULT.clear()
    reg = side.metrics.MetricsRegistry()
    for k, t in enumerate((T0, T0 + 5.0)):
        reg.inc("serving_tokens_total", {"engine": "disagg"}, 10.0 * (k + 1))
        side.history.HISTORY.ingest(reg.render(), now=t)
    rec = side.decisions.DECISIONS.open(
        "scale", "decode", "scale_out", inputs={"reason": "burn", "current": 1, "desired": 2},
        guards=[{"name": "evidence", "passed": True, "detail": "burn"}], now=T0)
    side.decisions.DECISIONS.actuate(rec.id, "scale_out", "applied", now=T0,
                                     namespace="default", lws="web", desired=2)
    side.rollout.LEDGER.record("revision_flip", obj="default/web", revision="r2", now=T0)


class Servers:
    """tests/test_torch_api_server.Servers, with the workers' telemetry
    servers registered as ready pods in both stores."""

    def __init__(self, servers) -> None:
        from tests.test_torch_api_server import Servers as Base

        self.base = Base()
        for (side, cp), s in zip(self.base.both.sides, (JAX, PORT)):
            for i, srv in enumerate(servers):
                add_worker_pod(s, cp.store, f"w{i}", ROLES[i], srv.port)
        self.urls = self.base.urls

    def answers(self, method: str, path: str, body: bytes | None = None,
                keys=WALL_KEYS) -> list:
        from tests.test_torch_api_server import call

        out = []
        for url in self.urls:
            code, ctype, text = call(url, method, path, body)
            if ctype == "application/json":
                text = normalize(json.loads(text), keys)
            out.append((code, ctype, text))
        return out

    def same(self, method: str, path: str, body: bytes | None = None, keys=WALL_KEYS):
        want, got = self.answers(method, path, body, keys)
        assert got == want, (method, path)
        return got


@pytest.fixture
def servers(workers, jax_planes_restored, port_planes_restored):  # noqa: F811
    s = Servers(workers)
    for side in (JAX, PORT):
        seed_planes(side)
    yield s
    s.base.close()
    for side in (JAX, PORT):
        side.faults.INJECTOR.disarm()
        side.journey.VAULT.clear()


def worker_samples(text: str) -> list:
    """The workers' samples of a fleet exposition (the control plane's own
    registries are each package's process registries, which differ)."""
    fams = pmetrics.parse_exposition(text)
    return sorted((n, sorted(lb.items()), v) for f in fams.values()
                  for n, lb, v, _ in f["samples"]
                  if lb.get("instance", "control-plane") != "control-plane")


def test_the_fleet_and_debug_routes_answer_as_jax_s(servers):
    s = servers
    # The process history ring, before a fleet scrape ingests into it.
    assert s.same("GET", "/debug/history?limit=2")[0] == 200
    s.same("GET", "/debug/history?limit=no")
    (jcode, _, jtext), (pcode, pctype, ptext) = s.answers("GET", "/metrics/fleet")
    assert pcode == jcode == 200 and pctype == "text/plain"
    assert worker_samples(ptext) == worker_samples(jtext)
    assert {"w0", "w1", "w2"} <= {lb["instance"] for _, lb, _, _ in
                                  pmetrics.parse_exposition(ptext)["serving_requests_total"][
                                      "samples"]}
    # The fleet ingest's decision step wrote the same records on both, at
    # each server's monotonic clock (its ingest time: no injected clock).
    decided = s.same("GET", "/debug/decisions", keys=WALL_KEYS | DECISION_CLOCK)[2]
    assert decided[0]["id"] == "scale-000001" and len(decided) > 1
    s.same("GET", "/debug/decisions?limit=-1")
    assert s.same("GET", "/debug/rollout?limit=1")[2][0]["kind"] == "revision_flip"
    s.same("GET", "/debug/rollout?limit=x")
    for path in ("/debug/traces?limit=x", "/debug/traces?limit=-1",
                 "/debug/flightrecorder?limit=x", "/debug/profile?format=svg",
                 "/debug/profile?limit=x", "/debug/compile?limit=1.5",
                 "/debug/compile/fleet?limit=q", "/debug/requests?outcome=bogus",
                 "/debug/requests?limit=z", "/debug/request/unknown", "/debug/faults"):
        assert s.same("GET", path)[0] in (200, 400, 404), path
    # Spans and flight-recorder events are each process's own (random ids,
    # wall stamps): the shapes must match.
    for path in ("/debug/traces", "/debug/flightrecorder?limit=0"):
        (jcode, _, jbody), (pcode, _, pbody) = s.answers("GET", path)
        assert pcode == jcode == 200 and type(pbody) is type(jbody), path
    (_, _, jfr_body), (_, _, pfr_body) = s.answers("GET", "/debug/flightrecorder?limit=0")
    assert set(pfr_body) == set(jfr_body)
    # Fleet folds over the workers (each control-plane leg is its own
    # process's, both empty here).
    profiles = s.same("GET", "/debug/profile/fleet")[2]
    assert [e["labels"]["instance"] for e in profiles["instances"]] == [
        "control-plane", "w0", "w1", "w2"]
    compiles = s.same("GET", "/debug/compile/fleet")[2]
    assert {e["labels"]["instance"] for e in compiles["instances"]} == {
        "control-plane", "w0", "w1", "w2"}
    assert s.same("GET", "/debug/profile?format=collapsed")[:2] == (200, "text/plain")


def test_journeys_join_across_the_workers_as_jax_s(servers):
    now = time.monotonic()  # the vaults sweep aged journeys on the real clock when read
    for side in (JAX, PORT):
        side.journey.VAULT.complete("req1", trace={"trace_id": "tq", "span_id": "sq"},
                                    engine="disagg", outcome="errored", error="boom", now=now)
    joined = servers.same("GET", "/debug/request/req1")[2]
    # Each worker's leg is this process's port vault; the control plane's
    # leg its own package's vault.
    assert [leg["labels"]["instance"] for leg in joined["legs"]] == [
        "control-plane", "w0", "w1", "w2"]
    assert joined["outcome"] == "errored"
    # Rows of one journey tie on every grade; their order then follows the
    # wall stamps, so the instances are compared as a set.
    (jcode, _, jrows), (pcode, _, prows) = servers.answers("GET", "/debug/requests?outcome=errored")
    key = lambda r: r["instance"]  # noqa: E731
    assert pcode == jcode == 200 and sorted(prows, key=key) == sorted(jrows, key=key)
    assert [r["id"] for r in prows] == ["req1"] * 4


def test_faults_and_report_metric_answer_as_jax_s(servers):
    s = servers
    armed = s.same("POST", "/debug/faults", b'{"arm": {"kv.ack": "fail_n_times:1"}}')
    assert armed[0] == 200 and armed[2]["armed"] == {"kv.ack": "fail_n_times:1"}
    for body in (b'{"arm": {"kv.ack": "nope"}}', b"{not json", b'{"disarm": ["kv.ack"]}', b""):
        s.same("POST", "/debug/faults", body)
    assert s.same("GET", "/debug/faults")[2]["armed"] == {}
    assert s.same("POST", "/report-metric/default/w0", b'{"inflight": 3}')[2] == {
        "reported": {"inflight": 3}}
    for path, body in (("/report-metric/default/w0", b'{"inflight": "x"}'),
                       ("/report-metric/default/w0", b"[1]"),
                       ("/report-metric/default/nope", b'{"inflight": 1}'),
                       ("/report-metric/default", b'{"inflight": 1}')):
        s.same("POST", path, body)
    pod = s.same("GET", "/apis/pods/default/w0")[2]
    assert pod["metadata"]["annotations"]["metrics.lws.tpu/inflight"] == "3.0"


def test_the_port_client_reports_a_metric(servers):
    from lws_tpu_torch.client import ApiError, RemoteClient

    client = RemoteClient(servers.urls[1])
    assert client.report_metric("default", "w1", {"inflight": 2.5}) == {
        "reported": {"inflight": 2.5}}
    with pytest.raises(ApiError) as e:
        client.report_metric("default", "nope", {"inflight": 1.0})
    assert e.value.code == 404
    annotations = copy.deepcopy(client.get("Pod", "default", "w1")["metadata"]["annotations"])
    assert annotations["metrics.lws.tpu/inflight"] == "2.5"
