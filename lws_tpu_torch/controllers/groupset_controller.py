"""GroupSet controller: materializes ordered, stable-identity pods.

This is the native replacement for the kube statefulset-controller the
reference leans on: parallel pod management, ordinal-stable names, per-pod
PVCs from claim templates, and partition-based rolling updates bounded by
max_unavailable (highest ordinal first) — the mechanism the LWS controller's
partition math drives (ref leaderworkerset_controller.go:643-696).

The port's copy of lws_tpu/controllers/groupset_controller.py.
"""

from __future__ import annotations

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.groupset import GroupSet, parent_name_and_ordinal
from lws_tpu_torch.api.pod import Pod, PodPhase, PodSpec, PodTemplateSpec
from lws_tpu_torch.utils.common import stable_hash
from lws_tpu_torch.api.pvc import PersistentVolumeClaim, PVCSpec
from lws_tpu_torch.core import trace
from lws_tpu_torch.core.events import EventRecorder
from lws_tpu_torch.core.manager import Result
from lws_tpu_torch.core.store import clone_object, Key, Store, new_meta


def template_hash(template: PodTemplateSpec) -> str:
    return stable_hash(template)


def pod_available(pod: Pod) -> bool:
    return pod.status.phase == PodPhase.RUNNING and pod.status.ready


class GroupSetReconciler:
    name = "groupset"

    def __init__(self, store: Store, recorder: EventRecorder) -> None:
        self.store = store
        self.recorder = recorder

    def reconcile(self, key: Key) -> Result | None:
        gs = self.store.try_get("GroupSet", key[1], key[2])
        if gs is None or not isinstance(gs, GroupSet):
            return None

        update_revision = template_hash(gs.spec.template)
        # owned_by_shared: READ-ONLY aliases (deletes go through the store by
        # name; nothing below mutates a pod). The leader groupset owns
        # O(replicas) leader pods — the per-reconcile deep clone of all of
        # them was the top rollout cost at 256 groups (CONTROL_r04).
        pods = {
            ordinal: pod
            for pod in self.store.owned_by_shared("Pod", gs.meta.namespace, gs.meta.uid)
            if (parsed := parent_name_and_ordinal(pod.meta.name))[0] == gs.meta.name
            and (ordinal := parsed[1]) >= 0
        }
        want = set(gs.ordinals())

        placement = trace.span(
            "reconcile.placement", revision=update_revision, want=len(want)
        )
        with placement:
            # Scale down: remove pods outside the ordinal range (highest first).
            for ordinal in sorted(set(pods) - want, reverse=True):
                self._delete_pod(gs, pods.pop(ordinal), scale_down=True)

            # Create missing pods (parallel pod management: all at once).
            for ordinal in sorted(want - set(pods)):
                pods[ordinal] = self._create_pod(gs, ordinal, update_revision)

        # Rolling update: recreate old-revision pods with ordinal >= partition,
        # highest ordinal first, within the unavailability budget. Deleting a
        # pod that is ALREADY unavailable consumes no budget — otherwise a
        # rollout that starts with crash-looping replicas wedges forever (the
        # LWS escape hatch, ref leaderworkerset_controller.go:660-669, lowers
        # partition expecting exactly this recreation to happen).
        partition = gs.spec.update_strategy.partition
        max_unavailable = max(1, gs.spec.update_strategy.max_unavailable)

        def is_candidate(ordinal: int, pod: Pod) -> bool:
            return (
                ordinal >= partition
                and pod.meta.labels.get(contract.GROUPSET_POD_REVISION_LABEL_KEY) != update_revision
            )

        with trace.span("reconcile.rollout_step", partition=partition) as step_span:
            unavailable_non_candidates = sum(
                1
                for ordinal, p in pods.items()
                if not pod_available(p) and not is_candidate(ordinal, p)
            )
            budget = max_unavailable - unavailable_non_candidates
            recreated = 0
            for ordinal in sorted(want, reverse=True):
                pod = pods.get(ordinal)
                if pod is None or not is_candidate(ordinal, pod):
                    continue
                if pod_available(pod):
                    if budget <= 0:
                        continue
                    budget -= 1
                self._delete_pod(gs, pod, scale_down=False)
                del pods[ordinal]
                recreated += 1
            step_span.set(recreated=recreated)

        # Status.
        with trace.span("reconcile.status"):
            ready = sum(1 for p in pods.values() if pod_available(p))
            updated = sum(
                1
                for p in pods.values()
                if p.meta.labels.get(contract.GROUPSET_POD_REVISION_LABEL_KEY) == update_revision
            )
            current = self.store.get("GroupSet", gs.meta.namespace, gs.meta.name)
            status = current.status
            changed = (
                status.replicas != len(pods)
                or status.ready_replicas != ready
                or status.available_replicas != ready
                or status.updated_replicas != updated
                or status.update_revision != update_revision
            )
            status.replicas = len(pods)
            status.ready_replicas = ready
            status.available_replicas = ready
            status.updated_replicas = updated
            status.update_revision = update_revision
            if updated == gs.spec.replicas and len(pods) == gs.spec.replicas:
                if status.current_revision != update_revision:
                    status.current_revision = update_revision
                    changed = True
            elif not status.current_revision:
                status.current_revision = update_revision
                changed = True
            if changed:
                self.store.update_status(current)
        return None

    # ------------------------------------------------------------------
    def _create_pod(self, gs: GroupSet, ordinal: int, update_revision: str) -> Pod:

        name = gs.pod_name(ordinal)
        labels = dict(gs.spec.template.metadata.labels)
        labels[contract.GROUPSET_POD_REVISION_LABEL_KEY] = update_revision
        annotations = dict(gs.spec.template.metadata.annotations)
        spec: PodSpec = clone_object(gs.spec.template.spec)
        if gs.spec.service_name:
            spec.subdomain = gs.spec.service_name
        pod = Pod(
            meta=new_meta(
                name,
                gs.meta.namespace,
                labels=labels,
                annotations=annotations,
                owners=[gs],
            ),
            spec=spec,
        )
        created = self.store.create(pod)
        self._ensure_pvcs(gs, name)
        return created  # type: ignore[return-value]

    def _ensure_pvcs(self, gs: GroupSet, pod_name: str) -> None:
        for vct in gs.spec.volume_claim_templates:
            pvc_name = f"{vct.name}-{pod_name}"
            if self.store.try_get("PersistentVolumeClaim", gs.meta.namespace, pvc_name):
                continue
            owners = [gs] if gs.spec.pvc_retention_policy_when_deleted == "Delete" else []
            self.store.create(
                PersistentVolumeClaim(
                    meta=new_meta(
                        pvc_name,
                        gs.meta.namespace,
                        labels={contract.SET_NAME_LABEL_KEY: gs.meta.labels.get(contract.SET_NAME_LABEL_KEY, "")},
                        owners=owners,
                    ),
                    spec=PVCSpec(
                        storage=vct.storage,
                        storage_class=vct.storage_class,
                        access_modes=list(vct.access_modes),
                    ),
                )
            )

    def _delete_pod(self, gs: GroupSet, pod: Pod, scale_down: bool) -> None:
        self.store.delete("Pod", pod.meta.namespace, pod.meta.name)
        if scale_down and gs.spec.pvc_retention_policy_when_scaled == "Delete":
            for vct in gs.spec.volume_claim_templates:
                self.store.delete(
                    "PersistentVolumeClaim", gs.meta.namespace, f"{vct.name}-{pod.meta.name}"
                )
