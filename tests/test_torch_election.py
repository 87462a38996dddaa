"""The port's leader election (lws_tpu_torch/core/election.py and the
ControlPlane's `leader_election=True`) against the JAX package's, on the CPU.

Every case of tests/test_election.py runs on both packages under one
injected clock, and after every `tick` (and `release`) the two stores'
Lease (holder, acquire and renew times, duration, transitions) and each
candidate's `is_leader()` must be equal. The ControlPlane cases hold the
two planes' objects equal too (tests/test_torch_control_plane.py's
normalization).
"""

from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import pytest

from lws_tpu import manifest as jmanifest
from lws_tpu.api import contract as jcontract
from lws_tpu.core import election as jelection
from lws_tpu.core import store as jstore
from lws_tpu.runtime import ControlPlane as JControlPlane
from lws_tpu_torch import manifest as pmanifest
from lws_tpu_torch.api import contract as pcontract
from lws_tpu_torch.core import election as pelection
from lws_tpu_torch.core import store as pstore
from lws_tpu_torch.runtime import ControlPlane as PControlPlane
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_control_plane import KINDS, normalize
from tests.test_torch_fleet import port_planes_restored  # noqa: F401
from tests.test_torch_wal import lws_doc

# Every test here leaves both packages' process planes as it found them.
pytestmark = pytest.mark.usefixtures("jax_planes_restored", "port_planes_restored")

JAX = SimpleNamespace(name="jax", election=jelection, store=jstore,
                      ControlPlane=JControlPlane, manifest=jmanifest, contract=jcontract)
PORT = SimpleNamespace(name="port", election=pelection, store=pstore,
                       ControlPlane=PControlPlane, manifest=pmanifest, contract=pcontract)
LEASE = ("Lease", "_cluster", "lws-tpu-controller")


class FakeClock:
    def __init__(self) -> None:
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def make_elector(side, store, identity, clock, **kw):
    return side.election.LeaderElector(
        store, identity, lease_duration_s=15, renew_deadline_s=10,
        retry_period_s=2, clock=clock, **kw,
    )


def lease(store):
    """The Lease's spec and its resourceVersion, or None."""
    obj = store.try_get(*LEASE)
    if obj is None:
        return None
    s = obj.spec
    return (s.holder_identity, s.acquire_time, s.renew_time, s.lease_duration_s,
            s.lease_transitions, obj.meta.resource_version)


class Election:
    """One store per package, the same candidates on each, one clock."""

    def __init__(self, names=("a", "b"), **callbacks) -> None:
        self.clock = FakeClock()
        self.stores = {s.name: s.store.Store() for s in (JAX, PORT)}
        self.log = {"jax": [], "port": []}
        self.cands = {}
        for side in (JAX, PORT):
            for n in names:
                kw = {k: (lambda s=side.name, k=k, n=n: self.log[s].append((n, k)))
                      for k in callbacks.get(n, ())}
                self.cands[side.name, n] = make_elector(side, self.stores[side.name], n,
                                                        self.clock, **kw)

    def step(self, name: str, op: str = "tick"):
        """`op` on candidate `name` in both packages; the results, the
        leases and every candidate's leadership must be equal."""
        got = {s: getattr(self.cands[s, name], op)() for s in ("jax", "port")}
        assert got["port"] == got["jax"], (name, op)
        assert lease(self.stores["port"]) == lease(self.stores["jax"]), (name, op)
        for (s, n), c in self.cands.items():
            assert c.is_leader() == self.cands["jax", n].is_leader(), (s, n)
        assert self.log["port"] == self.log["jax"]
        return got["jax"]

    def leader_identity(self, name: str):
        got = {s: self.cands[s, name].leader_identity() for s in ("jax", "port")}
        assert got["port"] == got["jax"]
        return got["jax"]


# ---------------------------------------------------------------------------
# tests/test_election.py's cases, on both packages


def test_first_candidate_acquires_and_renews():
    e = Election(names=("a",))
    assert e.step("a") and e.cands["port", "a"].is_leader()
    first = lease(e.stores["port"])
    assert first[0] == "a"
    e.clock.now += 5
    assert e.step("a")
    assert lease(e.stores["port"])[2] > first[2]


def test_standby_waits_then_takes_over_on_expiry():
    e = Election(b=("on_started_leading",))
    assert e.step("a")
    assert not e.step("b")
    assert e.leader_identity("b") == "a"
    e.clock.now += 16  # the leader goes silent past the lease duration
    assert e.step("b")
    assert e.log["port"] == [("b", "on_started_leading")]
    held = lease(e.stores["port"])
    assert held[0] == "b" and held[4] == 1


def test_deposed_leader_steps_down():
    e = Election(a=("on_stopped_leading",))
    assert e.step("a")
    e.clock.now += 16
    assert e.step("b")
    e.clock.now += 11  # past the renew deadline: never two active controllers
    assert not e.step("a")
    assert e.log["port"] == [("a", "on_stopped_leading")]
    assert e.leader_identity("b") == "b"


def test_release_gives_instant_failover():
    e = Election()
    assert e.step("a") and not e.step("b")
    e.step("a", "release")
    assert not e.cands["port", "a"].is_leader()
    assert e.step("b")  # no expiry wait needed


def lws_pods(cp, side, name: str = "sample") -> list:
    return cp.store.list("Pod", "default", labels={side.contract.SET_NAME_LABEL_KEY: name})


def planes(side, clock):
    leader = side.ControlPlane(auto_ready=True, leader_election=True, identity="leader",
                               clock=clock)
    standby = side.ControlPlane(auto_ready=True, leader_election=True, identity="standby",
                                store=leader.store, clock=clock)
    return leader, standby


def state(side, cp) -> dict:
    return {kind: sorted((normalize(side.manifest.to_manifest(o)) for o in cp.store.list(kind)),
                         key=lambda m: (m["metadata"]["namespace"], m["metadata"]["name"]))
            for kind in (*KINDS, "Lease")}


def test_control_plane_standby_does_not_reconcile():
    clock = FakeClock()
    seen = {}
    for side in (JAX, PORT):
        leader, standby = planes(side, clock)
        trace = [leader.run_until_stable()]
        leader.create(side.manifest.from_manifest(copy.deepcopy(lws_doc(replicas=1))))
        leader.run_until_stable()
        assert len(lws_pods(leader, side)) == 2

        # The standby shares the store but must stay passive.
        standby.resync()
        trace.append(standby.run_until_stable())
        assert trace[-1] == 0 and not standby.elector.is_leader()
        trace.append(state(side, leader))

        # Leader dies (stops renewing): standby takes over and reconciles drift.
        leader.elector.release()
        leader.store.delete("GroupSet", "default", "sample-0")
        standby.resync()
        standby.run_until_stable()
        assert standby.elector.is_leader()
        assert standby.store.try_get("GroupSet", "default", "sample-0") is not None
        trace.append(state(side, standby))
        seen[side.name] = trace
    assert seen["port"] == seen["jax"]


def test_threaded_standby_workers_stay_passive():
    """Split-brain guard in threaded mode: a standby's worker threads hold
    queued work until the lease is theirs."""
    clock = FakeClock()
    seen = {}
    for side in (JAX, PORT):
        leader = side.ControlPlane(auto_ready=True, leader_election=True, identity="leader",
                                   clock=clock)
        leader.elector.tick()
        standby = side.ControlPlane(auto_ready=True, leader_election=True,
                                    identity="standby", store=leader.store, clock=clock)
        standby.manager.start(poll_interval=0.005)
        try:
            standby.elector.tick()
            leader.create(side.manifest.from_manifest(copy.deepcopy(lws_doc(replicas=1))))
            time.sleep(0.2)
            # Standby workers saw the events but must not have acted on them.
            assert not lws_pods(leader, side)

            # Leader releases; the standby's next tick elects it and workers drain.
            leader.elector.release()
            standby.elector.tick()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and len(lws_pods(leader, side)) < 2:
                time.sleep(0.05)
            assert len(lws_pods(leader, side)) == 2
        finally:
            standby.manager.stop()
        seen[side.name] = (lease(leader.store), sorted(p.meta.name for p in lws_pods(leader, side)))
    # The lease's resourceVersion counts the writes the workers made meanwhile.
    assert seen["port"][0][:5] == seen["jax"][0][:5] and seen["port"][1] == seen["jax"][1]
