"""The port's simulated fleet (lws_tpu_torch/runtime/simfleet.py) and
closed-loop sweep (lws_tpu_torch/loadgen/closedloop.py) against the JAX
package's, on the CPU.

- SimFleet: tests/test_fleet_scale.py's harness cases on both packages with
  the same seeds. The instances' expositions are equal byte for byte; the
  fleet collectors over each package's store merge the same text; and a
  SimFleet behind each package's ControlPlane and ApiServer serves the same
  worker samples on `/metrics/fleet`.
- run_sweep: `run_sweep(seed=7)` plain, with the kill switch
  (`disable="scale,rollout"`, tests/test_decision_plane.py:174) and with the
  flash crowd's chaos overlay (a decode pod deleted at tick 5,
  tests/test_decision_plane.py:687) returns the JAX sweep's JSON, every key
  of it, on the sweep's injected clock.
"""

from __future__ import annotations

import json
import urllib.request
from types import SimpleNamespace

import pytest

from lws_tpu import manifest as jmanifest
from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import store as jstore
from lws_tpu.loadgen import closedloop as jclosedloop
from lws_tpu.runtime import ControlPlane as JControlPlane
from lws_tpu.runtime import fleet as jfleet
from lws_tpu.runtime import simfleet as jsimfleet
from lws_tpu.runtime.server import ApiServer as JApiServer
from lws_tpu_torch import manifest as pmanifest
from lws_tpu_torch.core import metrics as pmetrics
from lws_tpu_torch.core import store as pstore
from lws_tpu_torch.loadgen import closedloop as pclosedloop
from lws_tpu_torch.runtime import ControlPlane as PControlPlane
from lws_tpu_torch.runtime import fleet as pfleet
from lws_tpu_torch.runtime import simfleet as psimfleet
from lws_tpu_torch.runtime.server import ApiServer as PApiServer
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_fleet import port_planes_restored, worker_samples  # noqa: F401
from tests.test_torch_wal import normalize

# Every test here leaves both packages' process planes as it found them.
pytestmark = pytest.mark.usefixtures("jax_planes_restored", "port_planes_restored")

JAX = SimpleNamespace(name="jax", sim=jsimfleet, manifest=jmanifest, metrics=jmetrics, store=jstore,
                      fleet=jfleet, ControlPlane=JControlPlane, ApiServer=JApiServer,
                      closedloop=jclosedloop)
PORT = SimpleNamespace(name="port", sim=psimfleet, manifest=pmanifest, metrics=pmetrics, store=pstore,
                       fleet=pfleet, ControlPlane=PControlPlane, ApiServer=PApiServer,
                       closedloop=pclosedloop)
SIDES = (JAX, PORT)


# ---------------------------------------------------------------------------
# The simulation harness: tests/test_fleet_scale.py's cases


def test_sim_instance_series_are_deterministic_and_schema_faithful():
    renders = {}
    for side in SIDES:
        insts = [side.sim.SimInstance("sim-0000", "prefill", "rev-a", seed=s)
                 for s in (42, 42, 43)]
        for inst in insts:
            inst.start()  # so that stop() can close its server
        try:
            for inst in insts:
                inst.tick(5)
            a, b, other = (i.registry.render() for i in insts)
        finally:
            for inst in insts:
                inst.stop()
        assert a == b and a != other
        renders[side.name] = (a, other)
    assert renders["port"] == renders["jax"]
    fams = pmetrics.parse_exposition(renders["port"][0])
    assert fams["serving_tokens_total"]["type"] == "counter"
    labels = dict(fams["serving_tokens_total"]["samples"][0][1])
    assert labels == {"engine": "prefill", "klass": "chat", "revision": "rev-a"}
    assert "serving_ttft_seconds" in fams and "serving_slo_attainment" in fams


def test_sim_fleet_serves_real_telemetry_over_http():
    texts = {}
    for side in SIDES:
        with side.sim.SimFleet(n_instances=2, seed=7) as fleet:
            fleet.tick(2)
            texts[side.name] = []
            for inst in fleet.instances:
                with urllib.request.urlopen(f"http://127.0.0.1:{inst.port}/metrics",
                                            timeout=5) as resp:
                    texts[side.name].append(resp.read().decode())
    assert texts["port"] == texts["jax"]
    assert pmetrics.parse_exposition(texts["port"][0])["serving_requests_total"]["samples"]


def test_sim_fleet_pods_discovered_and_sharded_by_tree_scrape():
    got = {}
    for side in SIDES:
        store = side.store.Store()
        own = side.metrics.MetricsRegistry()
        with side.sim.SimFleet(store=store, n_instances=10, seed=3) as fleet:
            fleet.tick(1)
            fc = side.fleet.FleetCollector(store, shard_size=4, metrics_registry=own,
                                           cache_ttl_s=0.0)
            targets = [lb for lb, _ in fc.targets()]
            text = fc.render_fleet(force=True)
            names = {i.name for i in fleet.instances}
            pods = sorted(p.meta.name for p in store.list("Pod"))
        fams = pmetrics.parse_exposition(text)
        instances = {dict(s[1]).get("instance")
                     for s in fams["serving_requests_total"]["samples"]}
        assert instances == names and len(targets) == 10
        shards = sorted(dict(lb)["shard"] for n, lb, _, _ in pmetrics.parse_exposition(
            own.render()).get("lws_fleet_shard_scrape_seconds", {"samples": []})["samples"]
            if n == "lws_fleet_shard_scrape_seconds_count")
        assert shards == ["decode-0", "decode-1", "prefill-0", "prefill-1"]
        gauges = (own.gauge_value("lws_fleet_instances", {"state": "scraped"}),
                  own.gauge_value("lws_fleet_instances", {"state": "failed"}))
        assert gauges == (10.0, 0.0)
        got[side.name] = (targets, text, pods, shards, gauges)
    assert got["port"] == got["jax"]


def test_sim_fleet_target_speaks_the_loadgen_protocol():
    got = {}
    for side in SIDES:
        with side.sim.SimFleet(n_instances=3, seed=5) as fleet:
            target = side.sim.SimFleetTarget(fleet, seed=1)
            req = SimpleNamespace(index=0, klass="chat", prompt=[1, 2], max_new_tokens=8)
            handles = [target.submit(req, 0.0) for _ in range(6)]
            target.step()
            results = [target.poll(h) for h in handles]
            assert all(r is not None and r["n_tokens"] == 8 for r in results)
            assert all(target.poll(h) is None for h in handles)  # consumed
            got[side.name] = ([i.requests for i in fleet.instances],
                              [i.registry.render() for i in fleet.instances])
    assert got["port"] == got["jax"]
    assert sum(got["port"][0]) == 6


def test_seed_groups_totals_requested_group_count():
    got = {}
    for side in SIDES:
        store = side.store.Store()
        lwss = side.sim.seed_groups(store, 1001, replicas_per_lws=500)
        assert sum(lw.spec.replicas for lw in lwss) == 1001
        assert len(store.list("LeaderWorkerSet")) == 3
        got[side.name] = [normalize(side.manifest.to_manifest(o))
                          for o in store.list("LeaderWorkerSet")]
    assert got["port"] == got["jax"]


def test_a_sim_fleet_behind_the_control_plane_serves_jax_s_fleet_view():
    """A SimFleet registered in each package's ControlPlane store, behind
    its ApiServer: `/metrics/fleet` carries the same worker samples (the
    control plane's own rows are each package's process registries)."""
    texts, servers, fleets = {}, [], []
    try:
        for side in SIDES:
            cp = side.ControlPlane()
            fleet = side.sim.SimFleet(store=cp.store, n_instances=6, seed=11,
                                      revisions=("rev-a", "rev-b")).start()
            fleets.append(fleet)
            fleet.tick(3)
            srv = side.ApiServer(cp, port=0)
            srv.start()
            servers.append(srv)
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics/fleet",
                                        timeout=30) as resp:
                texts[side.name] = resp.read().decode()
    finally:
        for srv in servers:
            srv.stop()
        for fleet in fleets:
            fleet.stop()
    assert worker_samples(texts["port"]) == worker_samples(texts["jax"])
    fams = pmetrics.parse_exposition(texts["port"])
    rows = {(lb["instance"], lb.get("role"), lb.get("revision"))
            for _, lb, _, _ in fams["serving_tokens_total"]["samples"]
            if lb["instance"] != "control-plane"}
    assert len(rows) == 6 and {r[2] for r in rows} == {"rev-a", "rev-b"}


# ---------------------------------------------------------------------------
# The closed-loop sweep


def flash_crowd_chaos(deleted: list):
    """tests/test_decision_plane.py:679: a decode pod deleted mid-crowd."""
    def chaos(cp, now, tick):
        if tick == 5:
            pod = sorted(p.meta.name for p in cp.store.list("Pod", "default")
                         if "-decode" in p.meta.name)[0]
            cp.store.delete("Pod", "default", pod)
            deleted.append(pod)
    return chaos


@pytest.mark.parametrize("mode", ["closed", "kill-switch", "chaos"])
def test_the_sweep_returns_jax_s_json(mode):
    got, deleted = {}, {}
    for side in SIDES:
        kw = {}
        if mode == "kill-switch":
            kw["disable"] = "scale,rollout"
        if mode == "chaos":
            deleted[side.name] = []
            kw["chaos"] = flash_crowd_chaos(deleted[side.name])
        got[side.name] = json.dumps(side.closedloop.run_sweep(seed=7, **kw), sort_keys=True)
    assert got["port"] == got["jax"]
    res = json.loads(got["port"])
    if mode == "kill-switch":
        assert any(e["desired"] == 4 for e in res["evaluations"])
        assert res["max_replicas_seen"] == 1 and res["drains"] == []
        assert set(res["actuations"]) == {"scale_out/suppressed"} and res["flaps"] == 0
    else:
        assert res["max_replicas_seen"] == 4 and res["scale_in_steps"] == 1
        assert res["converged"] and res["flaps"] == 0
        assert res["drains"][0].endswith("-decode-3")
    if mode == "chaos":
        assert deleted["port"] == deleted["jax"] and deleted["port"]


def test_the_plant_and_the_crowd_are_jax_s():
    for density in (1.0, 10.0):
        assert (pclosedloop.densified_flash_crowd(density)
                == jclosedloop.densified_flash_crowd(density))
        for seed in (0, 7):
            assert (pclosedloop.crowd_arrivals(seed, density)
                    == jclosedloop.crowd_arrivals(seed, density))
    arrivals = jclosedloop.crowd_arrivals(7)
    plants = [side.closedloop.CapacityPlant(arrivals) for side in SIDES]
    for tick in range(1, 12):
        verdicts = [p.tick(tick * 15.0, 1 + tick % 3) for p in plants]
        assert verdicts[1] == verdicts[0]
        assert plants[1].render() == plants[0].render()
