"""The port's test utilities (lws_tpu_torch/testing.py) against the JAX
package's (lws_tpu/testing.py), on the CPU.

- Every `LWSBuilder` chain builds the same object in both packages
  (`to_plain`, with `uid` and `creation_timestamp` normalized).
- The readiness helpers drive a JAX and a port control plane alike
  (tests/test_torch_control_plane.py:Both holds the stores equal).
- The invariant checks: `assert_valid_lws` passes on the port's
  ControlPlane for every example tests/test_examples_apply.py deploys and
  for builder scenarios that reach each branch of `assert_valid_group`,
  and both packages' checks refuse the same broken group.
- The race harness: `guarded_fields` reads the port's Store as JAX's reads
  JAX's, `RaceDetector.assert_clean` passes over the port's Store under
  concurrent writers and readers, and the seeded lock removal is caught.
"""

from __future__ import annotations

import copy
import os
import threading

import pytest

from lws_tpu import testing as jtesting
from lws_tpu.api import meta as jmeta
from lws_tpu.api import types as jtypes
from lws_tpu.core import store as jstore
from lws_tpu_torch import testing as ptesting
from lws_tpu_torch.api import meta as pmeta
from lws_tpu_torch.api import types as ptypes
from lws_tpu_torch.core import store as pstore
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_control_plane import EXAMPLES, Both, add_fleet, apply_doc, load_docs
from tests.test_torch_fleet import port_planes_restored  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_planes_restored", "port_planes_restored")

SIDES = {"jax": (jtesting, jtypes, jmeta), "port": (ptesting, ptypes, pmeta)}
WALL = frozenset({"uid", "creation_timestamp"})

# name -> chain(builder, types): each of LWSBuilder's methods at least once.
CHAINS = {
    "default": lambda b, t: b,
    "replicas-size": lambda b, t: b.replicas(3).size(4),
    "image-leader": lambda b, t: b.leader_template(tpu_chips=4).image("x:v2"),
    "tpu-exclusive": lambda b, t: b.tpu_chips(4).exclusive_topology(),
    "exclusive-key": lambda b, t: b.exclusive_topology("cloud.google.com/gke-nodepool"),
    "policies": lambda b, t: b.restart_policy(t.RestartPolicy.NONE).startup_policy(
        t.StartupPolicy.LEADER_READY),
    "unique-subdomain": lambda b, t: b.subdomain_policy(t.SubdomainPolicy.UNIQUE_PER_REPLICA),
    "subgroup": lambda b, t: b.size(5).subgroup(2),
    "subgroup-excluded": lambda b, t: b.size(5).subgroup(2, t.SubGroupPolicyType.LEADER_EXCLUDED),
    "rollout": lambda b, t: b.rollout(max_unavailable=2, max_surge=1, partition=1),
    "annotation": lambda b, t: b.annotation("a/b", "c"),
}


def _normalized(x):
    if isinstance(x, dict):
        return {k: ("<normalized>" if k in WALL else _normalized(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [_normalized(v) for v in x]
    return x


def _build(name: str, chain: str, lws_name: str = "sample"):
    testing, types, _ = SIDES[name]
    return CHAINS[chain](testing.LWSBuilder(lws_name), types).build()


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_builder_chain_builds_jax_object(chain):
    got = {name: _normalized(SIDES[name][2].to_plain(_build(name, chain))) for name in SIDES}
    assert got["port"] == got["jax"]
    templates = {name: SIDES[name][2].to_plain(SIDES[name][0].make_worker_template("w:v3", 8))
                 for name in SIDES}
    assert templates["port"] == templates["jax"]


def test_readiness_helpers_drive_both_planes_alike():
    # Both() runs auto_ready control planes; these helpers play kubelet on
    # planes that do not, so each side is built here and compared the same way.
    from lws_tpu.runtime import ControlPlane as JControlPlane
    from lws_tpu_torch.runtime import ControlPlane as PControlPlane
    from tests.test_torch_control_plane import JAX, PORT, events, state

    planes = {"jax": (JAX, JControlPlane()), "port": (PORT, PControlPlane())}

    def same():
        (js, jcp), (ps, pcp) = planes["jax"], planes["port"]
        assert state(ps, pcp) == state(js, jcp)
        assert events(pcp) == events(jcp)

    for name, (_, cp) in planes.items():
        cp.create(_build(name, "policies", "web"))
        cp.run_until_stable()
    same()
    for name, (_, cp) in planes.items():
        testing = SIDES[name][0]
        assert testing.group_pod_names("web", 1, 3) == ["web-1", "web-1-1", "web-1-2"]
        testing.set_pod_ready(cp.store, "default", "web-0")  # LeaderReady gates the workers
        cp.run_until_stable()
        testing.make_group_ready(cp.store, "web", 0)
        cp.run_until_stable()
    same()
    for name, (_, cp) in planes.items():
        testing = SIDES[name][0]
        testing.make_all_groups_ready(cp, "web")
        testing.set_pod_not_ready(cp.store, "default", "web-1-2")
        testing.restart_pod_container(cp.store, "default", "web-0-1")
        cp.run_until_stable()
    same()
    answers = {}
    for name, (_, cp) in planes.items():
        testing = SIDES[name][0]
        testing.make_all_groups_ready(cp, "web")
        lws = cp.store.get("LeaderWorkerSet", "default", "web")
        answers[name] = (
            sorted(p.meta.name for p in testing.lws_pods(cp.store, "web")),
            testing.condition_status(lws, "Available"),
            testing.condition_status(lws, "no-such-condition"),
            SIDES[name][2].to_plain(testing.expect_valid_leader_groupset(cp.store, lws, 2).spec),
            sorted(g.meta.name for g in testing.expect_valid_worker_groupsets(cp.store, lws, 2)),
        )
        testing.assert_valid_lws(cp.store, "web")
    same()
    assert answers["port"] == answers["jax"]
    assert answers["port"][1] is True and len(answers["port"][0]) == 6


# Builder scenarios that reach each branch of assert_valid_group: exclusive
# topology (affinities), unique subdomains (per-group services), subgroups
# of both kinds, TPU requests (the TPU env), a leader template.
SCENARIOS = {
    "exclusive-tpu": lambda b, t: b.replicas(2).size(2).tpu_chips(4).exclusive_topology(),
    "unique-subdomain": lambda b, t: b.replicas(2).size(2).subdomain_policy(
        t.SubdomainPolicy.UNIQUE_PER_REPLICA),
    "subgroup": lambda b, t: b.replicas(1).size(5).subgroup(2),
    "subgroup-excluded": lambda b, t: b.replicas(1).size(5).subgroup(
        2, t.SubGroupPolicyType.LEADER_EXCLUDED),
    "leader-template": lambda b, t: b.replicas(2).size(3).leader_template(tpu_chips=4),
}


def _deploy(both: Both, docs: list) -> list:
    both.do(add_fleet)
    names = []
    for doc in docs:
        both.do(apply_doc(doc))
        if doc["kind"] == "LeaderWorkerSet":
            names.append((doc["metadata"].get("namespace", "default"), doc["metadata"]["name"]))
    return names


@pytest.mark.parametrize("path", EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_assert_valid_lws_passes_on_the_port_for_every_example(path):
    both = Both(enable_scheduler=True, scheduler_provider="gang")
    docs = load_docs(path)
    names = _deploy(both, docs)
    for side, cp in both.sides:
        testing = SIDES[side.name][0]
        for ns, name in names:
            testing.assert_valid_lws(cp.store, name, ns)
        # The DisaggregatedSets' role LWSs too.
        for lws in cp.store.list("LeaderWorkerSet"):
            testing.assert_valid_lws(cp.store, lws.meta.name, lws.meta.namespace)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_assert_valid_lws_passes_on_the_port_and_refuses_a_broken_group(scenario):
    both = Both(enable_scheduler=True, scheduler_provider="gang")
    both.do(add_fleet)

    def create(side, cp):
        testing, types, _ = SIDES[side.name]
        cp.create(SCENARIOS[scenario](testing.LWSBuilder("web"), types).build())

    both.do(create)
    refusals = {}
    for side, cp in both.sides:
        testing = SIDES[side.name][0]
        testing.make_all_groups_ready(cp, "web")
        testing.assert_valid_lws(cp.store, "web")
        # A worker whose revision label drifts from its leader's.
        pod = cp.store.get("Pod", "default", "web-0-1")
        pod.meta.labels[side_contract(side).REVISION_LABEL_KEY] = "drifted"
        cp.store.update(pod)
        with pytest.raises(AssertionError) as e:
            testing.assert_valid_lws(cp.store, "web")
        refusals[side.name] = str(e.value).split("\n")[0]
    assert refusals["port"] == refusals["jax"] and "drifted" in refusals["port"]


def side_contract(side):
    from lws_tpu.api import contract as jcontract
    from lws_tpu_torch.api import contract as pcontract

    return {"jax": jcontract, "port": pcontract}[side.name]


# ---------------------------------------------------------------------------
# The race harness over the port's Store


def test_guarded_by_grammar_is_shared_with_vet_and_reads_the_stores_alike():
    from tools.vet import core as vet_core

    assert ptesting.GUARDED_BY_RE.pattern == jtesting.GUARDED_BY_RE.pattern \
        == vet_core.GUARDED_BY_RE.pattern
    port = ptesting.guarded_fields(pstore.Store)
    assert port == jtesting.guarded_fields(jstore.Store)
    assert set(port.values()) == {"_lock"} and len(port) >= 7


def _churn(store, n: int = 40) -> list:
    """Writers create and update their own LWSs while readers list and get
    them, all released together; returns the exceptions raised."""
    errors: list = []
    barrier = threading.Barrier(4)

    def writer(w):
        def run():
            barrier.wait(timeout=10)
            try:
                for i in range(n):
                    lws = ptesting.LWSBuilder(f"w{w}-{i % 5}").replicas(1).size(1).build()
                    if store.try_get("LeaderWorkerSet", "default", lws.meta.name) is None:
                        store.create(lws)
                    else:
                        cur = store.get("LeaderWorkerSet", "default", lws.meta.name)
                        cur.spec.replicas = i % 3 + 1
                        store.update(cur)
            except Exception as e:  # noqa: BLE001 — collected for the caller
                errors.append(e)
        return run

    def reader():
        barrier.wait(timeout=10)
        try:
            for _ in range(n):
                store.list("LeaderWorkerSet")
                store.try_get("LeaderWorkerSet", "default", "w0-0")
        except Exception as e:  # noqa: BLE001 — collected for the caller
            errors.append(e)

    threads = [threading.Thread(target=fn, daemon=True)
               for fn in (writer(0), writer(1), reader, reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_race_detector_is_clean_over_the_port_store():
    det = ptesting.RaceDetector()
    store = pstore.Store()
    guarded = det.watch_guarded(store, name="Store")
    assert guarded and isinstance(store._lock, ptesting.InstrumentedLock)
    assert not _churn(store)
    det.assert_clean()
    assert len(store.list("LeaderWorkerSet")) == 10


def test_seeded_lock_removal_in_the_port_store_is_caught():
    det = ptesting.RaceDetector()
    store = pstore.Store()
    store._lock = ptesting.NullLock()
    guarded = det.watch_guarded(store, name="StoreMut")
    _churn(store)  # corruption is what the mutation invites; detection is under test
    assert {r["field"] for r in det.races()} & set(guarded), det.races()
    with pytest.raises(AssertionError, match="no common lock held"):
        det.assert_clean()


def test_detector_ignores_a_single_thread():
    det = ptesting.RaceDetector()
    store = pstore.Store()
    det.watch_guarded(store, name="StoreSingle")
    for i in range(20):
        store.create(copy.deepcopy(ptesting.LWSBuilder(f"s{i}").build()))
        store.list("LeaderWorkerSet")
    det.assert_clean()
