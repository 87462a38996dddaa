"""Test utilities: fluent LWS builders, status manipulation, validators
(≈ test/wrappers/wrappers.go + test/testutils/{util,validators}.go).

The port's copy of lws_tpu/testing.py, over the port's types, Store and
ControlPlane, with the same names: the builders, the readiness helpers,
the invariant checks and the instrumented-lock race harness.

Status setters simulate node-agent behavior the same way the reference's
envtest utilities do (SURVEY §4.2) — but here the GroupSet controller and
scheduler are real, so tests only flip *pod* status, never groupset status.
"""

from __future__ import annotations

from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.groupset import GroupSet
from lws_tpu_torch.api.pod import Container, Pod, PodPhase, PodSpec, PodTemplateSpec, TemplateMeta
from lws_tpu_torch.api.types import (
    LeaderWorkerSet,
    LeaderWorkerSetSpec,
    LeaderWorkerTemplate,
    NetworkConfig,
    RestartPolicy,
    RollingUpdateConfiguration,
    RolloutStrategy,
    StartupPolicy,
    SubdomainPolicy,
    SubGroupPolicy,
    SubGroupPolicyType,
)
from lws_tpu_torch.core.store import Store, new_meta


def make_worker_template(image: str = "worker:v1", tpu_chips: int = 0) -> PodTemplateSpec:
    resources = {contract.TPU_RESOURCE_NAME: tpu_chips} if tpu_chips else {}
    return PodTemplateSpec(
        metadata=TemplateMeta(),
        spec=PodSpec(containers=[Container(name="worker", image=image, resources=dict(resources))]),
    )


class LWSBuilder:
    """Fluent builder (≈ wrappers.go LeaderWorkerSetWrapper)."""

    def __init__(self, name: str = "sample", namespace: str = "default") -> None:
        self._lws = LeaderWorkerSet(
            meta=new_meta(name, namespace),
            spec=LeaderWorkerSetSpec(
                replicas=2,
                leader_worker_template=LeaderWorkerTemplate(
                    worker_template=make_worker_template(), size=3
                ),
            ),
        )

    def replicas(self, n: int) -> "LWSBuilder":
        self._lws.spec.replicas = n
        return self

    def size(self, n: int) -> "LWSBuilder":
        self._lws.spec.leader_worker_template.size = n
        return self

    def image(self, image: str) -> "LWSBuilder":
        for c in self._lws.spec.leader_worker_template.worker_template.spec.containers:
            c.image = image
        if self._lws.spec.leader_worker_template.leader_template is not None:
            for c in self._lws.spec.leader_worker_template.leader_template.spec.containers:
                c.image = image
        return self

    def leader_template(self, template: Optional[PodTemplateSpec] = None, tpu_chips: int = 0) -> "LWSBuilder":
        self._lws.spec.leader_worker_template.leader_template = template or make_worker_template(
            "leader:v1", tpu_chips
        )
        return self

    def tpu_chips(self, chips: int) -> "LWSBuilder":
        for c in self._lws.spec.leader_worker_template.worker_template.spec.containers:
            c.resources[contract.TPU_RESOURCE_NAME] = chips
        return self

    def restart_policy(self, policy: RestartPolicy) -> "LWSBuilder":
        self._lws.spec.leader_worker_template.restart_policy = policy
        return self

    def startup_policy(self, policy: StartupPolicy) -> "LWSBuilder":
        self._lws.spec.startup_policy = policy
        return self

    def subdomain_policy(self, policy: SubdomainPolicy) -> "LWSBuilder":
        self._lws.spec.network_config = NetworkConfig(subdomain_policy=policy)
        return self

    def subgroup(self, size: int, type_: SubGroupPolicyType = SubGroupPolicyType.LEADER_WORKER) -> "LWSBuilder":
        self._lws.spec.leader_worker_template.sub_group_policy = SubGroupPolicy(
            type=type_, sub_group_size=size
        )
        return self

    def rollout(self, max_unavailable=1, max_surge=0, partition=0) -> "LWSBuilder":
        self._lws.spec.rollout_strategy = RolloutStrategy(
            rolling_update_configuration=RollingUpdateConfiguration(
                partition=partition, max_unavailable=max_unavailable, max_surge=max_surge
            )
        )
        return self

    def annotation(self, key: str, value: str) -> "LWSBuilder":
        self._lws.meta.annotations[key] = value
        return self

    def exclusive_topology(self, key: str = contract.NODE_TPU_SLICE_LABEL) -> "LWSBuilder":
        return self.annotation(contract.EXCLUSIVE_KEY_ANNOTATION_KEY, key)

    def build(self) -> LeaderWorkerSet:
        return self._lws


# ---- status manipulation (the "play kubelet" helpers) ----------------------


def set_pod_ready(store: Store, namespace: str, name: str) -> None:
    pod = store.get("Pod", namespace, name)
    pod.status.phase = PodPhase.RUNNING
    pod.status.ready = True
    pod.status.address = f"{name}.{pod.spec.subdomain}.{namespace}"
    store.update_status(pod)


def set_pod_not_ready(store: Store, namespace: str, name: str) -> None:
    pod = store.get("Pod", namespace, name)
    pod.status.ready = False
    store.update_status(pod)


def restart_pod_container(store: Store, namespace: str, name: str) -> None:
    pod = store.get("Pod", namespace, name)
    pod.status.container_restarts += 1
    store.update_status(pod)


def group_pod_names(lws_name: str, group: int, size: int) -> list[str]:
    names = [f"{lws_name}-{group}"]
    names += [f"{lws_name}-{group}-{i}" for i in range(1, size)]
    return names


def make_group_ready(store: Store, lws_name: str, group: int, namespace: str = "default") -> None:
    lws = store.get("LeaderWorkerSet", namespace, lws_name)
    for name in group_pod_names(lws_name, group, lws.spec.leader_worker_template.size):
        if store.try_get("Pod", namespace, name) is not None:
            set_pod_ready(store, namespace, name)


def make_all_groups_ready(cp, lws_name: str, namespace: str = "default", max_rounds: int = 10) -> None:
    """Flip every existing pod of the LWS ready, settling between passes —
    drives multi-step flows (LeaderReady gates, rolling updates) to completion
    with the test playing kubelet."""
    for _ in range(max_rounds):
        cp.run_until_stable()
        pods = cp.store.list("Pod", namespace, labels={contract.SET_NAME_LABEL_KEY: lws_name})
        flipped = False
        for pod in pods:
            if not pod.status.ready:
                set_pod_ready(cp.store, namespace, pod.meta.name)
                flipped = True
        if not flipped:
            return
    raise AssertionError(f"{lws_name} never settled after {max_rounds} rounds")


# ---- validators (≈ test/testutils/validators.go) ---------------------------


def expect_valid_leader_groupset(store: Store, lws: LeaderWorkerSet, replicas: Optional[int] = None) -> GroupSet:
    gs = store.get("GroupSet", lws.meta.namespace, lws.meta.name)
    assert gs.spec.selector == {
        contract.SET_NAME_LABEL_KEY: lws.meta.name,
        contract.WORKER_INDEX_LABEL_KEY: "0",
    }
    tmpl = gs.spec.template.metadata
    assert tmpl.labels[contract.WORKER_INDEX_LABEL_KEY] == "0"
    assert tmpl.labels[contract.SET_NAME_LABEL_KEY] == lws.meta.name
    assert tmpl.labels[contract.REVISION_LABEL_KEY]
    assert tmpl.annotations[contract.SIZE_ANNOTATION_KEY] == str(lws.spec.leader_worker_template.size)
    assert gs.meta.annotations[contract.REPLICAS_ANNOTATION_KEY] == str(lws.spec.replicas)
    assert gs.spec.service_name == lws.meta.name
    if replicas is not None:
        assert gs.spec.replicas == replicas, f"leader groupset replicas {gs.spec.replicas} != {replicas}"
    return gs


def expect_valid_worker_groupsets(store: Store, lws: LeaderWorkerSet, count: Optional[int] = None) -> list[GroupSet]:
    size = lws.spec.leader_worker_template.size
    out = []
    groupsets = [
        g
        for g in store.list("GroupSet", lws.meta.namespace, labels={contract.SET_NAME_LABEL_KEY: lws.meta.name})
        if g.meta.name != lws.meta.name
    ]
    for gs in groupsets:
        assert gs.spec.replicas == size - 1
        assert gs.spec.start_ordinal == 1
        assert gs.meta.labels[contract.GROUP_INDEX_LABEL_KEY] == gs.spec.template.metadata.labels[contract.GROUP_INDEX_LABEL_KEY]
        assert gs.spec.template.metadata.annotations[contract.SIZE_ANNOTATION_KEY] == str(size)
        assert gs.spec.template.metadata.annotations[contract.LEADER_POD_NAME_ANNOTATION_KEY] == gs.meta.name
        out.append(gs)
    if count is not None:
        assert len(out) == count, f"worker groupsets {len(out)} != {count}"
    return out


def lws_pods(store: Store, lws_name: str, namespace: str = "default") -> list[Pod]:
    return store.list("Pod", namespace, labels={contract.SET_NAME_LABEL_KEY: lws_name})


def condition_status(lws: LeaderWorkerSet, ctype: str) -> Optional[bool]:
    for c in lws.status.conditions:
        if c.type == ctype:
            return c.status
    return None


def assert_valid_group(store: Store, lws: LeaderWorkerSet, group: int) -> None:
    """Validate EVERY field the controllers promise for one group — labels,
    annotations, env contract, affinities, subdomain, revision links, worker
    groupset wiring (≈ validators.go ExpectValidLeaderStatefulSet +
    ExpectValidWorkerStatefulSets + pod-webhook postconditions rolled into
    one call, the reference's test/testutils/validators.go:45-367). Checks
    only pods that exist — callers assert counts separately (groups mid-
    recreate legitimately have missing pods)."""
    ns = lws.meta.namespace
    size = lws.spec.leader_worker_template.size
    tmpl = lws.spec.leader_worker_template
    leader_name = f"{lws.meta.name}-{group}"
    leader = store.try_get("Pod", ns, leader_name)
    assert leader is not None, f"leader pod {leader_name} missing"

    # ---- leader labels -----------------------------------------------------
    labels = leader.meta.labels
    assert labels[contract.SET_NAME_LABEL_KEY] == lws.meta.name
    assert labels[contract.GROUP_INDEX_LABEL_KEY] == str(group)
    assert labels[contract.WORKER_INDEX_LABEL_KEY] == "0"
    group_key = labels.get(contract.GROUP_UNIQUE_HASH_LABEL_KEY)
    assert group_key, "leader missing group unique key"
    revision = labels.get(contract.REVISION_LABEL_KEY)
    assert revision, "leader missing template revision label"

    # ---- revision link: the label resolves to a stored ControllerRevision --
    revs = [
        r for r in store.list("ControllerRevision", ns)
        if r.meta.labels.get(contract.SET_NAME_LABEL_KEY) == lws.meta.name
        and revision in r.meta.name
    ]
    assert revs, f"no ControllerRevision for hash {revision}"

    # ---- leader annotations ------------------------------------------------
    assert leader.meta.annotations[contract.SIZE_ANNOTATION_KEY] == str(size)
    exclusive = lws.meta.annotations.get(contract.EXCLUSIVE_KEY_ANNOTATION_KEY)
    if exclusive:
        aff = leader.spec.affinity
        assert aff is not None, "exclusive topology promised but no affinity"
        assert any(
            t.topology_key == exclusive
            and t.selector_matches({contract.GROUP_UNIQUE_HASH_LABEL_KEY: group_key})
            for t in aff.required_affinity
        ), "missing same-topology affinity on the group key"
        assert any(
            t.topology_key == exclusive
            and not t.selector_matches({contract.GROUP_UNIQUE_HASH_LABEL_KEY: group_key})
            for t in aff.required_anti_affinity
        ), "missing anti-affinity against other groups' keys"

    # ---- subdomain / DNS identity -----------------------------------------
    unique = (
        lws.spec.network_config is not None
        and lws.spec.network_config.subdomain_policy == SubdomainPolicy.UNIQUE_PER_REPLICA
    )
    want_subdomain = leader_name if unique else lws.meta.name
    assert leader.spec.subdomain == want_subdomain, (
        f"leader subdomain {leader.spec.subdomain!r} != {want_subdomain!r}"
    )

    # ---- env contract (every container, leader first) ----------------------
    leader_addr = f"{leader_name}.{want_subdomain}.{ns}"

    def check_env(pod, worker_index: int) -> None:
        for container in pod.spec.containers + pod.spec.init_containers:
            env = {e.name: e.value for e in container.env}
            assert container.env and container.env[0].name == contract.LWS_LEADER_ADDRESS, (
                f"{pod.meta.name}: LWS_LEADER_ADDRESS must be the FIRST env var"
            )
            assert env[contract.LWS_LEADER_ADDRESS] == leader_addr
            assert env[contract.LWS_GROUP_SIZE] == str(size)
            assert env[contract.LWS_WORKER_INDEX] == str(worker_index)
            assert env[contract.JAX_COORDINATOR_ADDRESS] == (
                f"{leader_addr}:{contract.JAX_COORDINATOR_PORT_DEFAULT}"
            )
            assert env[contract.JAX_PROCESS_ID] == str(worker_index)
        # TPU bootstrap rides any container that requests chips.
        for container in pod.spec.containers:
            if int(container.resources.get(contract.TPU_RESOURCE_NAME, 0) or 0) > 0:
                env = {e.name: e.value for e in container.env}
                assert contract.TPU_WORKER_HOSTNAMES in env, (
                    f"{pod.meta.name}: requests TPUs but no TPU_WORKER_HOSTNAMES"
                )
                assert contract.TPU_WORKER_ID in env
                n_hosts = len(env[contract.TPU_WORKER_HOSTNAMES].split(","))
                assert 0 <= int(env[contract.TPU_WORKER_ID]) < n_hosts

    check_env(leader, 0)

    # ---- workers -----------------------------------------------------------
    for i in range(1, size):
        wname = f"{leader_name}-{i}"
        worker = store.try_get("Pod", ns, wname)
        if worker is None:
            continue  # group mid-materialization; counts asserted by callers
        wl = worker.meta.labels
        assert wl[contract.SET_NAME_LABEL_KEY] == lws.meta.name
        assert wl[contract.GROUP_INDEX_LABEL_KEY] == str(group)
        assert wl[contract.WORKER_INDEX_LABEL_KEY] == str(i)
        assert wl[contract.GROUP_UNIQUE_HASH_LABEL_KEY] == group_key, (
            "worker group key differs from leader's"
        )
        assert wl[contract.REVISION_LABEL_KEY] == revision, (
            f"{wname}: revision {wl[contract.REVISION_LABEL_KEY]} != leader's {revision}"
        )
        assert worker.meta.annotations[contract.SIZE_ANNOTATION_KEY] == str(size)
        assert worker.meta.annotations[contract.LEADER_POD_NAME_ANNOTATION_KEY] == leader_name
        if tmpl.sub_group_policy is not None and tmpl.sub_group_policy.sub_group_size:
            from lws_tpu_torch.utils.tpu import get_subgroup_index

            # get_subgroup_index owns the leader-fold rule ((size-1) % sgs
            # == 0 folds the leader into subgroup 0 and shifts workers) for
            # BOTH policies — recomputing it here diverged once already.
            want_sub = get_subgroup_index(size, tmpl.sub_group_policy.sub_group_size, i)
            assert wl[contract.SUBGROUP_INDEX_LABEL_KEY] == str(want_sub), (
                f"{wname}: subgroup index {wl.get(contract.SUBGROUP_INDEX_LABEL_KEY)} != {want_sub}"
            )
        check_env(worker, i)

    # ---- worker groupset wiring -------------------------------------------
    if size > 1:
        gs = store.try_get("GroupSet", ns, leader_name)
        if gs is not None:
            assert gs.spec.replicas == size - 1
            assert gs.spec.start_ordinal == 1
            assert gs.spec.template.metadata.labels[contract.REVISION_LABEL_KEY] == revision
            assert gs.spec.template.metadata.annotations[contract.LEADER_POD_NAME_ANNOTATION_KEY] == leader_name
            assert gs.spec.service_name == (leader_name if unique else lws.meta.name)

    # ---- services: the rendezvous plane ------------------------------------
    svc_name = leader_name if unique else lws.meta.name
    svc = store.try_get("Service", ns, svc_name)
    assert svc is not None, f"headless service {svc_name} missing"
    assert svc.spec.headless and svc.spec.publish_not_ready_addresses, (
        "rendezvous service must be headless and publish not-ready addresses"
    )
    assert svc.spec.selector.get(contract.SET_NAME_LABEL_KEY) == lws.meta.name
    if unique:
        assert svc.spec.selector.get(contract.GROUP_INDEX_LABEL_KEY) == str(group)


def assert_valid_lws(store: Store, lws_name: str, namespace: str = "default") -> None:
    """assert_valid_group over every group of the CURRENT stored LWS, plus
    the leader groupset checks — one call validating the whole promised
    surface (adopt in any test that reaches a stable state)."""
    lws = store.get("LeaderWorkerSet", namespace, lws_name)
    expect_valid_leader_groupset(store, lws)
    for g in range(lws.spec.replicas):
        if store.try_get("Pod", namespace, f"{lws_name}-{g}") is not None:
            assert_valid_group(store, lws, g)


# ---------------------------------------------------------------------------
# Instrumented-lock race harness: the runtime counterpart of `make vet`'s
# lock-discipline pass (≈ the reference repo's `go test -race`).
#
# The vet pass proves LEXICAL discipline (guarded attrs touched under their
# lock); this harness proves the discipline holds at RUNTIME, including
# paths the static pass cannot see (cross-object access, callbacks,
# socket-spawned threads). It implements the Eraser lockset algorithm:
#
#   * `InstrumentedLock` wraps a real Lock/RLock and maintains a
#     thread-local set of locks currently held;
#   * `RaceDetector.watch(obj, fields)` swaps the object's class for a
#     subclass whose `__getattribute__`/`__setattr__` record every access
#     to the named fields along with the caller's held-lock set;
#   * per (object, field) a candidate lockset is intersected across
#     accesses once a SECOND thread shows up (first-thread accesses are
#     the init phase, exempt — Eraser's shared-exclusive transition). An
#     empty intersection means no common lock protects the field: a race,
#     reported deterministically WITHOUT needing the racy interleaving to
#     actually strike.
#
# Register only genuinely-mutated shared state: the harness treats every
# access to a watched field as part of the conflict set (a deque mutated
# in place never shows an attribute WRITE, so reads count too).
#
# `NullLock` is the seeded-mutation aid: swapping an instance's lock for
# it simulates deleting the `with self._lock:` discipline from the source
# (tests/test_race_harness.py seeds exactly that mutation against
# serving/pipeline.py and asserts the detector catches it;
# tests/test_torch_testing.py does the same against the port's Store).


import ast as _ast
import inspect as _inspect
import re as _re
import textwrap as _textwrap
import threading as _threading

# The ONE annotation grammar shared with the static pass: this regex must
# stay byte-identical to tools/vet/core.py GUARDED_BY_RE (tests/
# test_torch_testing.py pins them equal). The shipped package cannot
# depend on dev tooling, so the pattern is restated here and the equality
# is enforced by test instead.
GUARDED_BY_RE = _re.compile(r"#.*?\bguarded-by:\s*([A-Za-z_]\w*)")


def guarded_fields(obj_or_cls) -> dict[str, str]:
    """attr -> lock-attr name for a class, read from the `# guarded-by:`
    comments on its attribute initializers — the SAME source annotations
    `make vet`'s lock pass enforces lexically. The static pass proves the
    discipline where it can see it; this reader hands the identical field
    set to the runtime detector (`RaceDetector.watch_guarded`) so the two
    checkers can never watch different state.

    Walks the MRO (subclass annotations win); classes without retrievable
    source (dynamically created, e.g. the detector's own Watched*
    wrappers) are skipped."""
    cls = obj_or_cls if isinstance(obj_or_cls, type) else type(obj_or_cls)
    out: dict[str, str] = {}
    for klass in reversed(cls.__mro__):
        if klass is object:
            continue
        try:
            src = _textwrap.dedent(_inspect.getsource(klass))
        except (OSError, TypeError):
            continue
        try:
            tree = _ast.parse(src)
        except SyntaxError:
            continue
        lines = src.splitlines()
        node = tree.body[0]
        if not isinstance(node, _ast.ClassDef):
            continue
        for fn in node.body:
            if not isinstance(fn, (_ast.FunctionDef, _ast.AsyncFunctionDef)):
                continue
            for stmt in _ast.walk(fn):
                if not isinstance(stmt, (_ast.Assign, _ast.AnnAssign)):
                    continue
                targets = (
                    stmt.targets if isinstance(stmt, _ast.Assign)
                    else [stmt.target]
                )
                for tgt in targets:
                    if (
                        isinstance(tgt, _ast.Attribute)
                        and isinstance(tgt.value, _ast.Name)
                        and tgt.value.id == "self"
                    ):
                        m = GUARDED_BY_RE.search(lines[stmt.lineno - 1])
                        if m:
                            out[tgt.attr] = m.group(1)
    return out


_HELD = _threading.local()


def _held_locks() -> list:
    locks = getattr(_HELD, "locks", None)
    if locks is None:
        locks = _HELD.locks = []
    return locks


class InstrumentedLock:
    """Drop-in Lock/RLock replacement feeding the detector's locksets."""

    def __init__(self, name: str = "lock", lock=None) -> None:
        self.name = name
        self._lock = lock if lock is not None else _threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _held_locks().append(self)
        return ok

    def release(self) -> None:
        held = _held_locks()
        if self in held:
            # Remove ONE entry: an RLock held re-entrantly stays held.
            held.reverse()
            held.remove(self)
            held.reverse()
        self._lock.release()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class NullLock:
    """A lock that locks nothing: the seeded `lock-removal` mutation.
    Swapping it in for an instance's real lock simulates deleting the
    `with self._lock:` discipline from the source under test."""

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return True

    def release(self) -> None:
        pass

    def __enter__(self) -> "NullLock":
        return self

    def __exit__(self, *exc) -> bool:
        return False


class RaceDetector:
    """Happens-before-via-locksets checker for registered shared objects."""

    def __init__(self) -> None:
        self._mutex = _threading.Lock()
        # (name, field) -> {"threads": set, "lockset": None|frozenset}
        self._state: dict[tuple[str, str], dict] = {}
        self._races: list[dict] = []

    # ---- instrumentation --------------------------------------------------
    def watch(self, obj, fields, name: Optional[str] = None):
        """Instrument `obj` so every access to `fields` is recorded. The
        object's class is swapped for a recording subclass (objects using
        __slots__ are not supported); returns `obj` for chaining."""
        label = name or type(obj).__name__
        watched = frozenset(fields)
        detector = self
        cls = type(obj)

        class _Watched(cls):  # type: ignore[misc, valid-type]
            def __getattribute__(self, attr):
                if attr in watched:
                    detector._note(label, attr, is_write=False)
                return super().__getattribute__(attr)

            def __setattr__(self, attr, value):
                if attr in watched:
                    detector._note(label, attr, is_write=True)
                object.__setattr__(self, attr, value)

        _Watched.__name__ = f"Watched{cls.__name__}"
        obj.__class__ = _Watched
        return obj

    def watch_guarded(self, obj, name: Optional[str] = None) -> dict[str, str]:
        """The static↔dynamic bridge: watch() exactly the fields the
        object's class annotates `# guarded-by:` in source — no hand-kept
        field list to drift from the vet pass — and swap each named lock
        attribute for an InstrumentedLock wrapping the original so the
        lockset feed needs no further wiring. Returns the attr -> lock map
        (callers assert it is non-empty: watching nothing is a test bug).

        Caveat: the lock swap rebinds the ATTRIBUTE; anything that
        captured the raw lock object at init (e.g. a Condition built on
        it) keeps the uninstrumented original."""
        guarded = guarded_fields(obj)
        for lock_attr in sorted(set(guarded.values())):
            lk = getattr(obj, lock_attr, None)
            if lk is not None and not isinstance(lk, (InstrumentedLock, NullLock)):
                setattr(obj, lock_attr, InstrumentedLock(lock_attr, lk))
        self.watch(obj, sorted(guarded), name=name)
        return guarded

    def _note(self, name: str, field: str, is_write: bool) -> None:
        tid = _threading.get_ident()
        held = frozenset(id(lk) for lk in _held_locks())
        names = {id(lk): getattr(lk, "name", "?") for lk in _held_locks()}
        with self._mutex:
            st = self._state.setdefault(
                (name, field),
                {"threads": set(), "lockset": None, "locknames": {}, "raced": False},
            )
            st["threads"].add(tid)
            st["locknames"].update(names)
            if len(st["threads"]) < 2:
                return  # init phase: a single owner thread never races
            st["lockset"] = held if st["lockset"] is None else (st["lockset"] & held)
            if not st["lockset"] and not st["raced"]:
                st["raced"] = True
                self._races.append({
                    "object": name,
                    "field": field,
                    "threads": len(st["threads"]),
                    "write": is_write,
                    "detail": (
                        f"{name}.{field} accessed by {len(st['threads'])} "
                        "threads with no common lock held"
                    ),
                })

    # ---- verdicts ---------------------------------------------------------
    def races(self) -> list[dict]:
        with self._mutex:
            return list(self._races)

    def assert_clean(self) -> None:
        races = self.races()
        assert not races, "lock-free conflicting accesses detected:\n" + "\n".join(
            r["detail"] for r in races
        )
