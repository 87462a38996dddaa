"""The port's typed clients (lws_tpu_torch/client.py: `Client`,
`RemoteClient`, `Informer`) against the JAX package's (lws_tpu/client.py),
on the CPU.

- `Client`: the same scripted steps on a JAX and a port control plane
  (tests/test_torch_control_plane.py:Both); after every step the stores
  are equal, and so is what each call returned, under `to_manifest`.
- `RemoteClient`: every method sends JAX's request (method, path, body)
  byte for byte, and answers the same against one port ApiServer.
- `Informer`: one JAX and one port Informer over one port ApiServer, through
  tests/test_watch_informer.py's scenarios: their caches are equal after
  every step, and equal to a fresh list, including the relist after an
  expired window and after a bookmark from the future.

Normalized, where two control planes are compared, and only these: `uid`,
`resourceVersion` and `last_transition_time`.
"""

from __future__ import annotations

import copy
import os
import threading
import time

import pytest

from lws_tpu import client as jclient
from lws_tpu import testing as jtesting
from lws_tpu_torch import client as pclient
from lws_tpu_torch import testing as ptesting
from lws_tpu_torch.runtime import ControlPlane as PControlPlane
from lws_tpu_torch.runtime.server import ApiServer as PApiServer
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_control_plane import ROOT, Both, load_docs, normalize
from tests.test_torch_fleet import port_planes_restored  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_planes_restored", "port_planes_restored")

CLIENTS = {"jax": jclient, "port": pclient}
TESTING = {"jax": jtesting, "port": ptesting}
DS_DOC = load_docs(os.path.join(ROOT, "lws_tpu_torch", "examples", "disaggregated-cpu.yaml"))[0]


# ---------------------------------------------------------------------------
# Client over each package's own control plane


def _plain(side, out):
    """What a Client call returned, as comparable data."""
    if out is None:
        return None
    if isinstance(out, list):
        return sorted((_plain(side, o) for o in out), key=lambda m: m["metadata"]["name"])
    return normalize(side.manifest.to_manifest(out))


def _step(both: Both, call) -> object:
    """`call(client, side)` on each plane's Client, both driven to a fixed
    point and held equal (stores and events); the returned values must be
    equal too."""
    got = {}

    def fn(side, cp):
        client = CLIENTS[side.name].Client(cp.store)
        got[side.name] = _plain(side, call(client, side))

    both.do(fn)
    assert got["port"] == got["jax"]
    return got["port"]


def test_client_scripted_steps_equal_jax():
    both = Both()
    builder = lambda side: TESTING[side.name].LWSBuilder("web").replicas(2).size(3)  # noqa: E731
    _step(both, lambda c, side: c.create_lws(builder(side).build()))
    assert [m["metadata"]["name"] for m in _step(both, lambda c, side: c.list_lws())] == ["web"]
    assert len(_step(both, lambda c, side: c.pods_of("web"))) == 6
    assert [m["metadata"]["name"] for m in _step(both, lambda c, side: c.leader_pods_of("web"))] \
        == ["web-0", "web-1"]
    _step(both, lambda c, side: c.scale_lws("web", 3))
    assert len(_step(both, lambda c, side: c.leader_pods_of("web"))) == 3

    def new_image(c, side):
        lws = c.get_lws("web")
        for ct in lws.spec.leader_worker_template.worker_template.spec.containers:
            ct.image = "worker:v2"
        return c.update_lws(lws)

    _step(both, new_image)
    assert _step(both, lambda c, side: c.get_lws("ghost")) is None
    _step(both, lambda c, side: c.create_ds(side.manifest.from_manifest(copy.deepcopy(DS_DOC))))
    assert len(_step(both, lambda c, side: c.pods_of(
        c.store.list("LeaderWorkerSet", labels=None)[0].meta.name))) >= 1

    def annotate_ds(c, side):
        ds = c.get_ds("port-demo")
        ds.meta.annotations["note"] = "x"
        return c.update_ds(ds)

    assert _step(both, annotate_ds)["metadata"]["annotations"] == {"note": "x"}
    _step(both, lambda c, side: c.delete_ds("port-demo"))
    assert _step(both, lambda c, side: c.get_ds("port-demo")) is None
    _step(both, lambda c, side: c.delete_lws("web"))
    assert _step(both, lambda c, side: c.list_lws()) == []
    assert _step(both, lambda c, side: c.pods_of("web")) == []


# ---------------------------------------------------------------------------
# RemoteClient: the same requests, the same answers


def _requests(make) -> dict:
    """{package: [(method, path, body)]} each RemoteClient sends for the
    calls `make(client, side)` makes, nothing sent over the wire."""
    sent = {}
    for name, mod in CLIENTS.items():
        client = mod.RemoteClient("http://127.0.0.1:1")
        log = sent[name] = []
        client._request = lambda method, path, body=None, log=log: log.append(
            (method, path, body)) or {"next": 7}
        make(client, name)
    return sent


def test_remote_client_sends_jax_requests():
    def calls(c, name):
        c.list("pods")
        c.get("lws", "default", "web")
        c.delete("lws", "default", "web")
        c.apply("kind: LeaderWorkerSet\n")
        c.apply_object(TESTING[name].LWSBuilder("web").replicas(1).size(2)
                       .annotation("a/b", "c").exclusive_topology().build())
        c.server_side_apply("lws", "default", "web", {"spec": {"replicas": 3}},
                            field_manager="hpa ctl", force=True)
        c.server_side_apply("lws", "default", "web", {"meta": {"labels": {"x": "y"}}},
                            field_manager="m")
        c.scale("default", "web", 4)
        c.cordon("node-a")
        c.cordon("node-a", unschedulable=False)
        c.drain("node-a")
        c.report_metric("default", "web-0", {"inflight": 2.5})
        c.events()
        c.events(namespace="default", name="web")
        c.watch(5, timeout=0.5)
        assert c.current_seq() == 7

    sent = _requests(calls)
    assert sent["port"] == sent["jax"]
    assert len(sent["port"]) == 16


@pytest.fixture
def served():
    """A port ApiServer over a port ControlPlane (auto_ready), and a JAX
    and a port RemoteClient pointed at it."""
    servers = []

    def start(**kw):
        cp = PControlPlane(auto_ready=True)
        server = PApiServer(cp, port=0, **kw)
        server.start()
        servers.append(server)
        url = f"http://127.0.0.1:{server.port}"
        return cp, server, {name: mod.RemoteClient(url) for name, mod in CLIENTS.items()}

    yield start
    for server in servers:
        server.stop()


def _same(clients: dict, call):
    """`call(client)` through both packages' clients against one server:
    both answer alike, or both raise ApiError with the same code."""
    out = {}
    for name, client in clients.items():
        try:
            out[name] = ("ok", call(client))
        except (jclient.ApiError, pclient.ApiError) as e:
            out[name] = ("error", e.code)
    assert out["port"] == out["jax"]
    return out["port"]


def test_remote_client_answers_like_jax_against_one_server(served):
    cp, _, clients = served()
    lws = ptesting.LWSBuilder().replicas(1).size(2).build()
    assert clients["port"].apply_object(lws) == {"applied": ["LeaderWorkerSet/sample"]}
    cp.run_until_stable()
    assert _same(clients, lambda c: c.get("lws", "default", "sample")["spec"]["replicas"]) \
        == ("ok", 1)
    assert _same(clients, lambda c: len(c.list("pods"))) == ("ok", 2)
    clients["port"].scale("default", "sample", 2)
    cp.run_until_stable()
    assert _same(clients, lambda c: len(c.list("pods"))) == ("ok", 4)
    assert _same(clients, lambda c: c.get("lws", "default", "ghost")) == ("error", 404)
    applied = clients["port"].server_side_apply(
        "lws", "default", "sample", {"meta": {"annotations": {"owner": "me"}}},
        field_manager="mgr")
    assert applied["metadata"]["annotations"]["owner"] == "me"
    # Another manager's claim on the same field conflicts (409) unless forced.
    assert _same(clients, lambda c: c.server_side_apply(
        "lws", "default", "sample", {"meta": {"annotations": {"owner": "you"}}},
        field_manager="other")) == ("error", 409)
    assert _same(clients, lambda c: c.events(name="sample")[:1] != []) == ("ok", True)
    assert _same(clients, lambda c: c.current_seq() > 0) == ("ok", True)
    assert clients["port"].delete("lws", "default", "sample") == {
        "deleted": "lws/default/sample"}
    cp.run_until_stable()
    assert _same(clients, lambda c: c.list("lws")) == ("ok", [])


# ---------------------------------------------------------------------------
# Informer: tests/test_watch_informer.py's scenarios, both packages at once


def _informers(clients: dict, **kw) -> dict:
    return {"jax": jclient.Informer(clients["jax"], **kw),
            "port": pclient.Informer(clients["port"], **kw)}


def _fresh(client, kinds) -> dict:
    """A fresh list of `kinds`, keyed as an Informer keys its cache."""
    return {(m["kind"], m["metadata"]["namespace"], m["metadata"]["name"]): m
            for kind in kinds for m in client.list(kind)}


def _held(informers: dict, client, kinds) -> None:
    assert informers["port"].cache == informers["jax"].cache == _fresh(client, kinds)


def test_watch_replays_and_long_polls_like_jax(served):
    cp, _, clients = served()
    cp.create(ptesting.LWSBuilder().replicas(1).size(2).build())
    cp.run_until_stable()
    out = _same(clients, lambda c: c.watch(since=0, timeout=0.1))[1]
    types = {(e["object"]["kind"], e["type"]) for e in out["events"]}
    assert {("LeaderWorkerSet", "ADDED"), ("Pod", "ADDED")} <= types
    assert out["next"] == out["events"][-1]["seq"]
    assert _same(clients, lambda c: c.watch(since=out["next"], timeout=0.1)) == (
        "ok", {"events": [], "next": out["next"]})
    # A long poll of each package blocks until the next event.
    start = clients["port"].current_seq()
    got = {}
    threads = [threading.Thread(target=lambda n=n, c=c: got.__setitem__(
        n, c.watch(since=start, timeout=10))) for n, c in clients.items()]
    for t in threads:
        t.start()
    time.sleep(0.1)
    cp.create(ptesting.LWSBuilder("late").replicas(1).size(1).build())
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    assert all("LeaderWorkerSet" in {e["object"]["kind"] for e in v["events"]}
               for v in got.values())
    assert _same(clients, lambda c: c._request("GET", "/watch?since=abc")) == ("error", 400)


def test_informers_track_cluster_state_alike(served):
    cp, _, clients = served()
    kinds = ("LeaderWorkerSet", "Pod")
    informers = _informers(clients, kinds=kinds)
    seen = {name: [] for name in informers}
    for name, inf in informers.items():
        inf.on_event = lambda t, m, name=name: seen[name].append((t, m["kind"],
                                                                 m["metadata"]["name"]))
        inf.relist()
    _held(informers, clients["port"], kinds)
    assert informers["port"].list("Pod") == []

    cp.create(ptesting.LWSBuilder().replicas(1).size(2).build())
    cp.run_until_stable()
    for inf in informers.values():
        inf.sync()
    _held(informers, clients["port"], kinds)
    assert len(informers["port"].list("Pod")) == 2
    assert informers["port"].get("LeaderWorkerSet", "default", "sample") is not None

    cp.store.delete("LeaderWorkerSet", "default", "sample")
    cp.run_until_stable()
    for inf in informers.values():
        inf.sync()
    _held(informers, clients["port"], kinds)
    assert informers["port"].list("Pod") == []  # cascade delete observed
    assert seen["port"] == seen["jax"] and seen["port"]


@pytest.mark.parametrize("how", ["window", "future"])
def test_informers_relist_on_expired_alike(served, how):
    """An expired window (a 4-event ring flooded) and a bookmark from the
    future (a restarted server's sequence started afresh) both answer
    `expired`, and both Informers relist to the same cache."""
    cp, _, clients = served(**({"watch_buffer": 4} if how == "window" else {}))
    kinds = ("Pod",)
    informers = _informers(clients, kinds=kinds)
    for inf in informers.values():
        inf.relist()
        if how == "future":
            inf._seq = 10_000
    if how == "future":
        assert _same(clients, lambda c: c.watch(since=10_000, timeout=0.1)[
            "expired"]) == ("ok", True)
    cp.create(ptesting.LWSBuilder().replicas(2 if how == "window" else 1).size(2).build())
    cp.run_until_stable()
    applied = {name: inf.sync() for name, inf in informers.items()}
    assert applied == {"jax": 0, "port": 0}  # relisted, nothing replayed
    _held(informers, clients["port"], kinds)
    assert len(informers["port"].list("Pod")) == (4 if how == "window" else 2)


def test_informers_skip_a_stale_event_alike(served):
    """The per-object staleness guard: an event older than the cached
    object (a relist that raced the watch) never moves the cache back."""
    cp, _, clients = served()
    cp.create(ptesting.LWSBuilder().replicas(1).size(1).build())
    cp.run_until_stable()
    informers = _informers(clients, kinds=("LeaderWorkerSet",))
    for inf in informers.values():
        inf._seq = 0  # replay every event onto a cache that a relist filled
        inf.cache = _fresh(clients["port"], ("LeaderWorkerSet",))
        inf.sync()
    _held(informers, clients["port"], ("LeaderWorkerSet",))


def test_informers_start_and_stop_alike(served):
    cp, _, clients = served()
    kinds = ("LeaderWorkerSet", "Pod")
    informers = _informers(clients, kinds=kinds)
    for inf in informers.values():
        inf.start(poll_timeout=0.2)
    try:
        cp.create(ptesting.LWSBuilder().replicas(1).size(2).build())
        cp.run_until_stable()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            want = _fresh(clients["port"], kinds)
            if informers["port"].cache == informers["jax"].cache == want:
                break
            time.sleep(0.05)
        _held(informers, clients["port"], kinds)
    finally:
        for inf in informers.values():
            inf.stop()
    assert all(inf._thread is None for inf in informers.values())


def _pad(cp, client, upto: int) -> None:
    """Writes of a kind no Informer here watches (a Node's label) until the
    server's sequence reaches `upto`: one event each."""
    from lws_tpu_torch.sched import make_slice_nodes

    node = make_slice_nodes("pad", topology="1x1")[0]
    cp.add_nodes([node])
    while client.current_seq() < upto:
        node = cp.store.get("Node", node.meta.namespace, node.meta.name)
        node.meta.labels["pad"] = str(client.current_seq())
        cp.store.update(node)


def test_a_restarted_server_past_the_bookmark_leaves_both_caches_stale(served):
    """A fault shared with the JAX package (ROADMAP Queue 3): a bookmark
    carries no server identity, so when a restarted API server's fresh
    sequence has already passed the Informer's bookmark, `/watch` answers
    with its events after the bookmark instead of `expired`, and the events
    up to it are never seen: the cache keeps an object the new server does
    not hold and misses one it does. Both packages' Informers end in the
    same stale cache. Only a bookmark ahead of the new sequence (as after
    path 17's takeover on the card) makes them relist."""
    cp_a, _, clients_a = served()
    kinds = ("LeaderWorkerSet",)
    informers = _informers(clients_a, kinds=kinds)
    cp_a.create(ptesting.LWSBuilder("gone").replicas(1).size(1).build())
    cp_a.run_until_stable()
    _pad(cp_a, clients_a["port"], clients_a["port"].current_seq() + 40)
    for inf in informers.values():
        inf.relist()
    bookmark = informers["port"]._seq
    assert bookmark == informers["jax"]._seq > 40
    # The restarted server: another store. Its "missed" LWS lands at or
    # before the bookmark, its "late" one after.
    cp_b, _, clients_b = served()
    cp_b.create(ptesting.LWSBuilder("missed").replicas(1).size(1).build())
    cp_b.run_until_stable()
    assert clients_b["port"].current_seq() < bookmark
    _pad(cp_b, clients_b["port"], bookmark)
    cp_b.create(ptesting.LWSBuilder("late").replicas(1).size(1).build())
    cp_b.run_until_stable()
    for name, inf in informers.items():
        inf.client = clients_b[name]
        assert inf.sync() > 0  # events after the bookmark, no `expired`
    assert informers["port"].cache == informers["jax"].cache
    assert {k[2] for k in informers["port"].cache} == {"gone", "late"}
    assert {k[2] for k in _fresh(clients_b["port"], kinds)} == {"missed", "late"}
