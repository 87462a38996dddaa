"""Gang scheduling provider plug-point
(≈ pkg/schedulerprovider/interface.go:39-64 + volcano_provider.go).

`create_pod_group_if_not_exists` is called by the pod controller when it sees
a leader pod; `inject_pod_group_metadata` is called by the pod webhook on every
group pod. PodGroup name: `<lws>-<groupIdx>-<revision>` so each rolling-update
generation gangs separately.

The port's copy of lws_tpu/sched/provider.py.
"""

from __future__ import annotations

from typing import Optional, Protocol

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.pod import Pod
from lws_tpu_torch.api.podgroup import PodGroup, PodGroupSpec
from lws_tpu_torch.api.types import LeaderWorkerSet, StartupPolicy
from lws_tpu_torch.core.store import Store, new_meta
from lws_tpu_torch.utils.common import group_resource_total
from lws_tpu_torch.utils.revision import get_revision_key


def get_pod_group_name(lws_name: str, group_index: str, revision_key: str) -> str:
    return f"{lws_name}-{group_index}-{revision_key}"


class SchedulerProvider(Protocol):
    def create_pod_group_if_not_exists(self, lws: LeaderWorkerSet, leader_pod: Pod) -> None: ...

    def inject_pod_group_metadata(self, pod: Pod) -> None: ...


class GangSchedulerProvider:
    """Native gang provider: one PodGroup per replica, min_member = group size
    (1 under LeaderReady startup: workers appear only after the leader runs,
    ref volcano_provider.go:58-66), min_resources = whole-group sum."""

    def __init__(self, store: Store, queue: str = "") -> None:
        self.store = store
        self.queue = queue

    def _queue_for(self, lws: LeaderWorkerSet) -> str:
        """Queue for this LWS's PodGroups; read per call so providers that
        derive it from LWS annotations stay safe under concurrent reconciles
        of different LWS (no shared-state write between them)."""
        return self.queue

    def create_pod_group_if_not_exists(self, lws: LeaderWorkerSet, leader_pod: Pod) -> None:
        group_index = leader_pod.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, "0")
        name = get_pod_group_name(lws.meta.name, group_index, get_revision_key(leader_pod))
        if self.store.try_get("PodGroup", lws.meta.namespace, name) is not None:
            return
        size = lws.spec.leader_worker_template.size
        min_member = 1 if lws.spec.startup_policy == StartupPolicy.LEADER_READY else size
        leader_template = (
            lws.spec.leader_worker_template.leader_template
            or lws.spec.leader_worker_template.worker_template
        )
        worker_template = lws.spec.leader_worker_template.worker_template

        def total(template):
            out: dict[str, int] = {}
            for c in template.spec.containers:
                for k, v in c.resources.items():
                    out[k] = out.get(k, 0) + v
            return out

        min_resources = group_resource_total(total(leader_template), total(worker_template), size)
        # Owner = the leader pod: the PodGroup is GC'd and re-created on group
        # recreation (ref volcano_provider.go:84-90).
        self.store.create(
            PodGroup(
                meta=new_meta(
                    name,
                    lws.meta.namespace,
                    labels={contract.SET_NAME_LABEL_KEY: lws.meta.name},
                    owners=[leader_pod],
                ),
                spec=PodGroupSpec(
                    min_member=min_member,
                    min_resources=min_resources,
                    queue=self._queue_for(lws),
                ),
            )
        )

    def inject_pod_group_metadata(self, pod: Pod) -> None:
        lws_name = pod.meta.labels.get(contract.SET_NAME_LABEL_KEY, "")
        group_index = pod.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, "")
        revision = pod.meta.labels.get(contract.REVISION_LABEL_KEY, "")
        pod.meta.annotations[contract.POD_GROUP_ANNOTATION_KEY] = get_pod_group_name(
            lws_name, group_index, revision
        )


# Annotation namespaces an external gang scheduler owns; inherited verbatim
# from the LWS onto PodGroups and pods (ref volcano_provider.go:49-101
# inherits queue + volcano.sh/* annotations; DS e2e checks Kueue labels).
EXTERNAL_INHERIT_PREFIXES = ("volcano.sh/", "kueue.x-k8s.io/", "scheduling.x-k8s.io/")
EXTERNAL_QUEUE_ANNOTATION = "volcano.sh/queue-name"


class ExternalSchedulerProvider(GangSchedulerProvider):
    """Compat path for clusters that already run an external gang scheduler
    (Volcano/Kueue-style): PodGroups carry the inherited queue + external
    annotations, pods are stamped with the external scheduler's name, and
    the NATIVE scheduler leaves them strictly alone — binding happens via
    the API (spec.node_name update through a client), exactly how an
    external scheduler integrates with an apiserver."""

    def __init__(self, store: Store, scheduler_name: str = "external") -> None:
        super().__init__(store)
        self.scheduler_name = scheduler_name

    def _queue_for(self, lws: LeaderWorkerSet) -> str:
        return lws.meta.annotations.get(EXTERNAL_QUEUE_ANNOTATION, "")

    def create_pod_group_if_not_exists(self, lws: LeaderWorkerSet, leader_pod: Pod) -> None:
        super().create_pod_group_if_not_exists(lws, leader_pod)
        # Inherit the external scheduler's annotation namespaces.
        group_index = leader_pod.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, "0")
        name = get_pod_group_name(lws.meta.name, group_index, get_revision_key(leader_pod))
        inherited = {
            k: v
            for k, v in lws.meta.annotations.items()
            if k.startswith(EXTERNAL_INHERIT_PREFIXES)
        }
        if not inherited:
            return
        pg = self.store.try_get("PodGroup", lws.meta.namespace, name)
        if pg is not None and not all(
            pg.meta.annotations.get(k) == v for k, v in inherited.items()
        ):
            pg.meta.annotations.update(inherited)
            from lws_tpu_torch.core.store import ConflictError

            try:
                self.store.update(pg)
            except ConflictError:
                pass  # level-triggered: the next leader-pod reconcile retries

    def inject_pod_group_metadata(self, pod: Pod) -> None:
        super().inject_pod_group_metadata(pod)
        pod.spec.scheduler_name = self.scheduler_name


def make_scheduler_provider(name: Optional[str], store: Store) -> Optional[SchedulerProvider]:
    """≈ schedulerprovider factory (interface.go:57-64). `external[:NAME]`
    selects the external-compat provider (pods bound by a foreign scheduler
    through the API)."""
    if name in (None, ""):
        return None
    if name == "gang":
        return GangSchedulerProvider(store)
    if name == "external" or (name and name.startswith("external:")):
        _, _, sched = name.partition(":")
        return ExternalSchedulerProvider(store, scheduler_name=sched or "external")
    raise ValueError(f"unknown scheduler provider {name!r}")
