"""The port's control plane (lws_tpu_torch: store, webhooks, the LWS,
GroupSet, pod and DisaggregatedSet controllers, the scheduler, ControlPlane)
against the JAX package's, on the same scripted scenarios.

Both control planes run with `auto_ready=True` and are driven only by
`run_until_stable`. After every step the `to_manifest` of every object of
every kind must be equal, and so must the recorded events' (object, type,
reason, message). Normalized, and only these: `uid` (drawn at random by
the store), `resourceVersion`, and `last_transition_time` (wall-clock
stamps). Names carry revision hashes and are compared exactly.

Every test that builds a JAX ControlPlane puts JAX's process-global planes
back afterwards (`jax_planes_restored`, shared with tests/test_torch_cli.py).
"""

from __future__ import annotations

import copy
import glob
import os
from types import SimpleNamespace

import pytest
import yaml

from lws_tpu import manifest as jmanifest
from lws_tpu.api.pod import PodPhase as JPodPhase
from lws_tpu.core import store as jstore
from lws_tpu.runtime import ControlPlane as JControlPlane
from lws_tpu.sched import make_slice_nodes as jslice_nodes
from lws_tpu_torch import manifest as pmanifest
from lws_tpu_torch.api.pod import PodPhase as PPodPhase
from lws_tpu_torch.core import store as pstore
from lws_tpu_torch.runtime import ControlPlane as PControlPlane
from lws_tpu_torch.sched import make_slice_nodes as pslice_nodes
from tests.test_torch_cli import jax_planes_restored  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The repo's examples (the autoscaler's apart, below) and the port's own.
EXAMPLES = sorted(
    p for p in glob.glob(os.path.join(ROOT, "examples", "*.yaml"))
    if not p.endswith(("config.yaml", "autoscaler.yaml"))
) + [os.path.join(ROOT, "lws_tpu_torch", "examples", "disaggregated-cpu.yaml")]
KINDS = ("LeaderWorkerSet", "GroupSet", "Pod", "Service", "DisaggregatedSet",
         "ControllerRevision", "PodGroup", "Node", "PersistentVolumeClaim")
NORMALIZED = frozenset({"uid", "resourceVersion", "last_transition_time"})

JAX = SimpleNamespace(name="jax", ControlPlane=JControlPlane, manifest=jmanifest,
                      store=jstore, PodPhase=JPodPhase, slice_nodes=jslice_nodes)
PORT = SimpleNamespace(name="port", ControlPlane=PControlPlane, manifest=pmanifest,
                       store=pstore, PodPhase=PPodPhase, slice_nodes=pslice_nodes)


def normalize(x):
    if isinstance(x, dict):
        return {k: ("<normalized>" if k in NORMALIZED else normalize(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [normalize(v) for v in x]
    return x


def state(side, cp) -> dict:
    return {
        kind: sorted((normalize(side.manifest.to_manifest(o)) for o in cp.store.list(kind)),
                     key=lambda m: (m["metadata"]["namespace"], m["metadata"]["name"]))
        for kind in KINDS
    }


def events(cp) -> list:
    return [("/".join(e.object_key), e.type, e.reason, e.message) for e in cp.recorder.events]


def load_docs(path: str) -> list[dict]:
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d]


class Both:
    """One JAX and one port control plane, stepped in lockstep."""

    def __init__(self, **kw) -> None:
        self.sides = [(JAX, JAX.ControlPlane(auto_ready=True, **kw)),
                      (PORT, PORT.ControlPlane(auto_ready=True, **kw))]
        self.steps = 0

    def do(self, fn) -> None:
        """Apply `fn(side, cp)` to both planes, drive each to a fixed point,
        and hold them equal."""
        for side, cp in self.sides:
            fn(side, cp)
            cp.run_until_stable()
        self.steps += 1
        (_, jcp), (_, pcp) = self.sides
        want, got = state(JAX, jcp), state(PORT, pcp)
        for kind in KINDS:
            assert got[kind] == want[kind], (self.steps, kind)
        assert events(pcp) == events(jcp), self.steps

    def each(self, fn) -> list:
        """`fn(side, cp)` on each plane, answers in (JAX, port) order."""
        return [fn(side, cp) for side, cp in self.sides]

    def read(self, fn):
        """`fn(side, cp)` on both planes; the two answers must be equal."""
        (js, jcp), (ps, pcp) = self.sides
        want, got = fn(js, jcp), fn(ps, pcp)
        assert got == want
        return want


def add_fleet(side, cp, slices: int = 8) -> None:
    for i in range(slices):
        cp.add_nodes(side.slice_nodes(f"slice-{i}", topology="2x4"))


def apply_doc(doc: dict):
    """The API server's /apply, on one plane: create, or update the spec
    over the live object (status kept)."""
    def fn(side, cp):
        obj = side.manifest.from_manifest(copy.deepcopy(doc))
        existing = cp.store.try_get(obj.kind, obj.meta.namespace, obj.meta.name)
        if existing is None:
            cp.store.create(obj)
            return
        obj.meta.resource_version = existing.meta.resource_version
        obj.meta.uid = existing.meta.uid
        if hasattr(existing, "status"):
            obj.status = existing.status
        cp.store.update(obj)
    return fn


def fail_pod(name: str, namespace: str = "default"):
    """What LocalBackend reports for a process that exits non-zero."""
    def fn(side, cp):
        pod = cp.store.get("Pod", namespace, name)
        pod.status.phase = side.PodPhase.FAILED
        pod.status.ready = False
        pod.status.container_restarts += 1
        pod.status.message = "process exited with code 1"
        cp.store.update_status(pod)
    return fn


def delete(kind: str, name: str, namespace: str = "default"):
    return lambda side, cp: cp.store.delete(kind, namespace, name)


def pod_uids(side, cp) -> dict:
    return {p.meta.name: p.meta.uid for p in cp.store.list("Pod")}


# ---------------------------------------------------------------------------
# Every shipped example, as tests/test_examples_apply.py deploys it.


@pytest.mark.parametrize("path", EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_every_example_converges_to_the_same_state(path, jax_planes_restored):
    both = Both(enable_scheduler=True, scheduler_provider="gang")
    both.do(add_fleet)
    for doc in load_docs(path):
        both.do(apply_doc(doc))
    assert both.read(lambda side, cp: len(cp.store.list("Pod"))) > 0 or \
        "nodes" in os.path.basename(path)


def test_the_autoscaler_example_is_refused_by_the_port_alone():
    # Every document of the example, the Autoscaler among them, decodes as
    # JAX's does.
    docs = load_docs(os.path.join(ROOT, "examples", "autoscaler.yaml"))
    kinds = [d["kind"] for d in docs]
    assert "Autoscaler" in kinds
    for doc in docs:
        got = pmanifest.from_manifest(copy.deepcopy(doc))
        want = jmanifest.from_manifest(copy.deepcopy(doc))
        assert got.kind == want.kind
        assert normalize(pmanifest.to_manifest(got)) == normalize(jmanifest.to_manifest(want))


# ---------------------------------------------------------------------------
# An LWS through scale, a stepped rolling update and pod failures.


def lws_doc(name="web", replicas=3, size=2, restart="RecreateGroupOnPodRestart",
            image="v1", surge=1, unavailable=1, partition=None, startup=None) -> dict:
    rolling = {"maxSurge": surge, "maxUnavailable": unavailable}
    if partition is not None:
        rolling["partition"] = partition
    lwt = {
        "size": size, "restartPolicy": restart,
        "workerTemplate": {"spec": {"containers": [
            {"name": "w", "image": image, "command": ["python", "-c", "pass"]}]}},
    }
    if startup:
        lwt["startupPolicy"] = startup
    return {"apiVersion": "lws.tpu/v1", "kind": "LeaderWorkerSet",
            "metadata": {"name": name},
            "spec": {"replicas": replicas, "leaderWorkerTemplate": lwt,
                     "rolloutStrategy": {"type": "RollingUpdate",
                                         "rollingUpdateConfiguration": rolling}}}


@pytest.mark.parametrize("surge,unavailable", [(1, 1), (0, 2), (2, 0)])
def test_scale_and_a_stepped_rolling_update(surge, unavailable, jax_planes_restored):
    both = Both()
    both.do(apply_doc(lws_doc(replicas=3, surge=surge, unavailable=unavailable)))
    both.do(apply_doc(lws_doc(replicas=5, surge=surge, unavailable=unavailable)))
    both.do(apply_doc(lws_doc(replicas=4, surge=surge, unavailable=unavailable)))
    # A template change stepped by its partition, then let through whole.
    images = []
    for partition in (3, 1, 0):
        both.do(apply_doc(lws_doc(replicas=4, image="v2", surge=surge,
                                  unavailable=unavailable, partition=partition)))
        images.append(both.read(lambda side, cp: sorted(
            (p.meta.name, p.spec.containers[0].image) for p in cp.store.list("Pod")
            if p.meta.name.count("-") == 1)))
    # Groups at index >= partition move to the new template; with no
    # partition left every group runs it.
    assert any(img == "v1" for _, img in images[0])
    assert {img for _, img in images[-1]} == {"v2"}
    both.do(apply_doc(lws_doc(replicas=2, image="v2", surge=surge, unavailable=unavailable)))


@pytest.mark.parametrize("policy", ["RecreateGroupOnPodRestart", "RecreateGroupAfterStart",
                                    "None"])
def test_a_pod_failure_under_each_restart_policy(policy, jax_planes_restored):
    both = Both()
    both.do(apply_doc(lws_doc(replicas=2, size=3, restart=policy)))
    before = both.each(pod_uids)
    both.do(fail_pod("web-1-2"))
    after = both.each(pod_uids)
    jchanged, changed = (sorted(n for n in b if a.get(n) != b[n]) for b, a in zip(before, after))
    assert changed == jchanged
    if policy == "None":
        assert changed in ([], ["web-1-2"])
    else:
        assert changed == ["web-1", "web-1-1", "web-1-2"]
    both.do(fail_pod("web-0"))


def test_leader_ready_startup_and_subgroups(jax_planes_restored):
    both = Both()
    doc = lws_doc(name="sg", replicas=2, size=4, startup="LeaderReady")
    doc["spec"]["leaderWorkerTemplate"]["subGroupPolicy"] = {"subGroupSize": 2}
    both.do(apply_doc(doc))
    both.do(fail_pod("sg-0-3"))
    doc["spec"]["replicas"] = 3
    both.do(apply_doc(doc))


def test_exclusive_topology_with_the_v5e_fleet_and_the_gang_scheduler(jax_planes_restored):
    both = Both(enable_scheduler=True, scheduler_provider="gang")
    for doc in load_docs(os.path.join(ROOT, "examples", "nodes-v5e-fleet.yaml")):
        both.do(apply_doc(doc))
    for doc in load_docs(os.path.join(ROOT, "examples", "lws-tpu-serving.yaml")):
        both.do(apply_doc(doc))
    bound = both.read(lambda side, cp: sorted(
        (p.meta.name, p.spec.node_name) for p in cp.store.list("Pod")))
    assert all(node for _, node in bound), bound
    both.do(fail_pod("llama-serve-0"))
    # Scale past the fleet: the extra group stays pending on both.
    for doc in load_docs(os.path.join(ROOT, "examples", "lws-tpu-serving.yaml")):
        doc["spec"]["replicas"] = 3
        both.do(apply_doc(doc))


# ---------------------------------------------------------------------------
# A DisaggregatedSet: lockstep rollout, scale, cascade delete.


def test_ds_lockstep_rollout_scale_and_cascade_delete(jax_planes_restored):
    both = Both()
    docs = load_docs(os.path.join(ROOT, "examples", "disaggregated-llmd.yaml"))
    (doc,) = docs
    both.do(apply_doc(doc))
    prv = both.read(lambda side, cp: sorted(
        s.meta.name for s in cp.store.list("Service") if s.meta.name.endswith("-prv")))
    assert len(prv) == 2, prv
    # A template change of both roles: the N-dimensional lockstep rollout.
    for role in doc["spec"]["roles"]:
        c = role["template"]["spec"]["leaderWorkerTemplate"]["workerTemplate"]["spec"][
            "containers"][0]
        c["image"] = "my-jax-serving:v2"
    both.do(apply_doc(doc))
    lws = both.read(lambda side, cp: sorted(o.meta.name for o in cp.store.list("LeaderWorkerSet")))
    assert len(lws) == 2, lws
    # Scale one role, then the other down.
    doc["spec"]["roles"][0]["replicas"] = 3
    both.do(apply_doc(doc))
    doc["spec"]["roles"][1]["replicas"] = 1
    both.do(apply_doc(doc))
    both.do(delete("DisaggregatedSet", "llmd"))
    left = both.read(lambda side, cp: {k: len(cp.store.list(k)) for k in KINDS if k != "Node"})
    assert not any(left.values()), left


# ---------------------------------------------------------------------------
# Webhooks: the same invalid objects refused with the same messages.


def _lws_invalid_cases() -> dict:
    cases = {}
    d = lws_doc(name="Bad_Name")
    cases["dns1035 name"] = d
    d = lws_doc()
    d["spec"]["leaderWorkerTemplate"]["size"] = 0
    cases["size 0"] = d
    d = lws_doc()
    d["spec"]["replicas"] = -1
    cases["negative replicas"] = d
    d = lws_doc(size=5)
    d["spec"]["leaderWorkerTemplate"]["subGroupPolicy"] = {"subGroupSize": 3}
    cases["subgroup not dividing size"] = d
    d = lws_doc(size=2)
    d["spec"]["leaderWorkerTemplate"]["subGroupPolicy"] = {"subGroupSize": 3}
    cases["subgroup above size"] = d
    d = lws_doc(surge=0, unavailable=0)
    cases["surge and unavailable both 0"] = d
    d = lws_doc(surge="150%")
    cases["surge above 100%"] = d
    d = lws_doc(partition=-1)
    cases["negative partition"] = d
    d = lws_doc(replicas=2**31 - 1, size=2)
    cases["replicas times size overflow"] = d
    ds = load_docs(os.path.join(ROOT, "examples", "disaggregated-llmd.yaml"))[0]
    one = copy.deepcopy(ds)
    one["spec"]["roles"] = one["spec"]["roles"][:1]
    cases["ds with one role"] = one
    dup = copy.deepcopy(ds)
    dup["spec"]["roles"][1]["name"] = dup["spec"]["roles"][0]["name"]
    cases["ds duplicate roles"] = dup
    part = copy.deepcopy(ds)
    part["spec"]["roles"][0]["template"]["spec"]["rolloutStrategy"] = {
        "type": "RollingUpdate", "rollingUpdateConfiguration": {"partition": 1}}
    cases["ds role partition"] = part
    many = copy.deepcopy(ds)
    many["spec"]["slices"] = 1000
    cases["ds too many slices"] = many
    return cases


LWS_INVALID = _lws_invalid_cases()


@pytest.mark.parametrize("case", sorted(LWS_INVALID))
def test_webhooks_refuse_the_same_objects_with_the_same_messages(case, jax_planes_restored):
    doc = LWS_INVALID[case]
    messages = []
    for side in (JAX, PORT):
        cp = side.ControlPlane(auto_ready=True)
        with pytest.raises(side.store.AdmissionError) as err:
            cp.store.create(side.manifest.from_manifest(copy.deepcopy(doc)))
        messages.append(str(err.value))
        assert not cp.store.list(doc["kind"])
    assert messages[1] == messages[0]


def test_an_update_refused_by_validation_leaves_the_same_object(jax_planes_restored):
    both = Both()
    doc = lws_doc(name="sg", size=4)
    doc["spec"]["leaderWorkerTemplate"]["subGroupPolicy"] = {"subGroupSize": 2}
    both.do(apply_doc(doc))
    bad = copy.deepcopy(doc)
    bad["spec"]["leaderWorkerTemplate"]["subGroupPolicy"] = {"subGroupSize": 4}

    def refused(side, cp):
        with pytest.raises(side.store.AdmissionError) as err:
            apply_doc(bad)(side, cp)
        return str(err.value)

    both.read(refused)
    both.do(lambda side, cp: None)


# ---------------------------------------------------------------------------
# The store: one scripted sequence, the same watch feed and conflicts.


def test_store_watch_feed_and_conflicts_are_the_same():
    from lws_tpu.api.meta import ObjectMeta as JMeta
    from lws_tpu.api.node import Node as JNode, NodeSpec as JNodeSpec
    from lws_tpu.api.service import Service as JService, ServiceSpec as JServiceSpec
    from lws_tpu_torch.api.meta import ObjectMeta as PMeta
    from lws_tpu_torch.api.node import Node as PNode, NodeSpec as PNodeSpec
    from lws_tpu_torch.api.service import Service as PService, ServiceSpec as PServiceSpec

    def script(side, Meta, Node, NodeSpec, Service, ServiceSpec):
        s = side.store.Store()
        feed, outcomes = [], []
        s.watch(lambda ev: feed.append(
            (ev.type, ev.obj.kind, ev.obj.meta.name, ev.obj.meta.resource_version,
             ev.obj.meta.generation, normalize(side.manifest.to_manifest(ev.obj)))))

        def attempt(label, fn):
            try:
                fn()
                outcomes.append((label, "ok"))
            except (side.store.ConflictError, side.store.AlreadyExistsError,
                    side.store.NotFoundError, side.store.FieldManagerConflict) as e:
                outcomes.append((label, type(e).__name__, str(e)))

        a = s.create(Node(meta=Meta(name="n1", namespace="cluster", labels={"r": "a"}),
                          spec=NodeSpec(capacity={"google.com/tpu": 4})))
        attempt("dup", lambda: s.create(Node(meta=Meta(name="n1", namespace="cluster"))))
        b = s.get("Node", "cluster", "n1")
        b.spec.unschedulable = True
        s.update(b)
        a.spec.capacity = {"google.com/tpu": 8}
        attempt("stale update", lambda: s.update(a))
        c = s.get("Node", "cluster", "n1")
        c.meta.labels["r"] = "b"
        c.status.ready = False
        s.update_status(c)
        attempt("stale status", lambda: s.update_status(b))
        owner = s.create(Service(meta=Meta(name="svc", namespace="default"),
                                 spec=ServiceSpec(selector={"x": "1"})))
        dep = Service(meta=Meta(name="dep", namespace="default"), spec=ServiceSpec())
        dep.meta.owner_references.append(side.store.owner_ref(owner))
        s.create(dep)
        s.apply("Service", "default", "svc", {"spec": {"selector": {"x": "2"}}},
                field_manager="m1")
        attempt("ssa conflict", lambda: s.apply(
            "Service", "default", "svc", {"spec": {"selector": {"x": "3"}}}, field_manager="m2"))
        s.apply("Service", "default", "svc", {"spec": {"selector": {"x": "3"}}},
                field_manager="m2", force=True)
        s.delete("Service", "default", "svc")
        attempt("gone", lambda: s.delete("Service", "default", "dep"))
        attempt("missing get", lambda: s.get("Node", "cluster", "nope"))
        return feed, outcomes

    want = script(JAX, JMeta, JNode, JNodeSpec, JService, JServiceSpec)
    got = script(PORT, PMeta, PNode, PNodeSpec, PService, PServiceSpec)
    assert [o[:2] for o in want[1]] == [o[:2] for o in got[1]]
    assert got == want
    assert {o[1] for o in want[1]} >= {"ConflictError", "FieldManagerConflict",
                                       "AlreadyExistsError", "NotFoundError"}
