"""Pod/group controller (≈ pkg/controllers/pod_controller.go).

Leader pods materialize their worker GroupSet (from the *revision snapshot*
their own label names, never the live spec); every pod is watched for the
all-or-nothing restart policies; exclusive placement follows the leader's
node topology into the workers' nodeSelector.

Extends the reference with the KEP-820 fail-fast budget: group recreations are
counted on the LWS and stop once max-group-restarts is hit (TPU preemptions
make unbounded restart storms expensive).

The port's copy of lws_tpu/controllers/pod_controller.py.
"""

from __future__ import annotations

import json
from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.groupset import (
    GroupSet,
    GroupSetSpec,
    GroupSetUpdateStrategy,
    parent_name_and_ordinal,
)
from lws_tpu_torch.api.pod import Pod, PodPhase
from lws_tpu_torch.api.service import Service, ServiceSpec
from lws_tpu_torch.api.types import LeaderWorkerSet, RestartPolicy, StartupPolicy, SubdomainPolicy
from lws_tpu_torch.core.events import EventRecorder
from lws_tpu_torch.core.manager import Result
from lws_tpu_torch.core.store import clone_object, Key, Store, new_meta
from lws_tpu_torch.sched.provider import SchedulerProvider
from lws_tpu_torch.utils import revision as revisionutils
from lws_tpu_torch.utils.podutils import container_restarted, is_leader_pod, pod_running_and_ready
from lws_tpu_torch.utils.tpu import add_tpu_annotations


class PodReconciler:
    name = "pod"

    def __init__(
        self,
        store: Store,
        recorder: EventRecorder,
        scheduler_provider: Optional[SchedulerProvider] = None,
    ) -> None:
        self.store = store
        self.recorder = recorder
        self.scheduler_provider = scheduler_provider

    # ------------------------------------------------------------------
    def reconcile(self, key: Key) -> Result | None:
        pod = self.store.try_get("Pod", key[1], key[2])
        if pod is None or not isinstance(pod, Pod):
            return None
        lws_name = pod.meta.labels.get(contract.SET_NAME_LABEL_KEY)
        if not lws_name or contract.WORKER_INDEX_LABEL_KEY not in pod.meta.labels:
            return None
        lws = self.store.try_get("LeaderWorkerSet", pod.meta.namespace, lws_name)
        if lws is None or not isinstance(lws, LeaderWorkerSet):
            return None

        leader_deleted = self._handle_restart_policy(pod, lws)
        if leader_deleted:
            return None
        if not is_leader_pod(pod):
            return None

        # Per-replica headless service under UniquePerReplica (ref :116-120).
        if (
            lws.spec.network_config is not None
            and lws.spec.network_config.subdomain_policy == SubdomainPolicy.UNIQUE_PER_REPLICA
        ):
            self._ensure_service(
                lws,
                pod.meta.name,
                {
                    contract.SET_NAME_LABEL_KEY: lws.meta.name,
                    contract.GROUP_INDEX_LABEL_KEY: pod.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, ""),
                },
                owner=pod,
            )

        if self.scheduler_provider is not None:
            self.scheduler_provider.create_pod_group_if_not_exists(lws, pod)

        # size == 1: no worker groupset (ref :138-140).
        if lws.spec.leader_worker_template.size == 1:
            return None

        # LeaderReady startup gate (ref :143-146).
        if lws.spec.startup_policy == StartupPolicy.LEADER_READY and not pod_running_and_ready(pod):
            return None

        revision = revisionutils.get_revision(self.store, lws, revisionutils.get_revision_key(pod))
        if revision is None:
            # Revision not created yet (or this pod is about to be replaced);
            # a ControllerRevision/Pod watch event will retrigger.
            return None

        gs = self._construct_worker_groupset(pod, lws, revision)

        # Exclusive placement: wait for the leader to be scheduled, then pin
        # workers to its topology domain (ref :162-172, :297-336).
        topology_key = lws.meta.annotations.get(contract.EXCLUSIVE_KEY_ANNOTATION_KEY)
        if topology_key:
            if not pod.spec.node_name:
                return None
            value = self._topology_value(pod, topology_key)
            if value is None:
                return None
            gs.spec.template.spec.node_selector[topology_key] = value

        if self.store.try_get("GroupSet", lws.meta.namespace, pod.meta.name) is None:
            self.store.create(gs)
            self.recorder.event(
                lws, "Normal", "GroupsProgressing", f"Created worker groupset for leader pod {pod.meta.name}"
            )
        return None

    # ---- restart policy (ref :204-266) ---------------------------------
    def _handle_restart_policy(self, pod: Pod, lws: LeaderWorkerSet) -> bool:
        policy = lws.spec.leader_worker_template.restart_policy
        if policy not in (RestartPolicy.RECREATE_GROUP_ON_POD_RESTART, RestartPolicy.RECREATE_GROUP_AFTER_START):
            return False
        if not container_restarted(pod) and pod.status.phase != PodPhase.FAILED:
            return False

        size = lws.spec.leader_worker_template.size
        pending = self._pending_pods_in_group(pod, size)
        opted_in = contract.RECREATE_GROUP_AFTER_START_ANNOTATION_KEY in lws.meta.annotations
        if pending and (policy == RestartPolicy.RECREATE_GROUP_AFTER_START or opted_in):
            return False

        if not is_leader_pod(pod):
            leader_name, ordinal = parent_name_and_ordinal(pod.meta.name)
            if ordinal == -1:
                raise ValueError(f"parsing pod name for pod {pod.meta.name}")
            leader = self.store.try_get("Pod", pod.meta.namespace, leader_name)
            if leader is None:
                return False  # leader already deleted; GC will finish the job
            if revisionutils.get_revision_key(leader) != revisionutils.get_revision_key(pod):
                return False  # pod about to be replaced by the new revision
            if not self._worker_belongs_to_leader(pod, leader):
                return False  # stale worker from a previous group generation
        else:
            leader = pod

        if self._increment_restart_count_or_fail(lws, leader):
            return False  # budget exhausted: leave the group down, Failed set

        self.store.delete("Pod", leader.meta.namespace, leader.meta.name)
        self.recorder.event(
            lws,
            "Normal",
            "RecreateGroup",
            f"Worker pod {pod.meta.name} failed, deleted leader pod {leader.meta.name} "
            f"to recreate group {leader.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, '?')}",
        )
        return True

    def _pending_pods_in_group(self, pod: Pod, size: int) -> bool:
        """≈ :338-362 — any pod of this group still Pending."""
        lws_name = pod.meta.labels[contract.SET_NAME_LABEL_KEY]
        group_index = pod.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, "")
        group_pods = self.store.list(
            "Pod",
            pod.meta.namespace,
            labels={contract.SET_NAME_LABEL_KEY: lws_name, contract.GROUP_INDEX_LABEL_KEY: group_index},
        )
        return any(p.status.phase == PodPhase.PENDING for p in group_pods)

    def _worker_belongs_to_leader(self, pod: Pod, leader: Pod) -> bool:
        """≈ :268-295 — ownership chain: pod -> worker groupset -> leader."""
        owner = pod.meta.controller_owner()
        if owner is None or owner.kind != "GroupSet":
            return False
        gs = self.store.try_get("GroupSet", pod.meta.namespace, owner.name)
        if gs is None or gs.meta.uid != owner.uid:
            return False
        gs_owner = gs.meta.controller_owner()
        return gs_owner is not None and gs_owner.kind == "Pod" and gs_owner.uid == leader.meta.uid

    def _increment_restart_count_or_fail(self, lws: LeaderWorkerSet, leader: Pod) -> bool:
        """KEP-820 budget: returns True when the budget is exhausted."""
        budget = lws.meta.annotations.get(contract.MAX_GROUP_RESTARTS_ANNOTATION_KEY)
        if budget is None:
            return False
        group = leader.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, "?")
        fresh = self.store.get("LeaderWorkerSet", lws.meta.namespace, lws.meta.name)
        counts = json.loads(fresh.meta.annotations.get(contract.GROUP_RESTARTS_ANNOTATION_KEY, "{}"))
        if int(counts.get(group, 0)) >= int(budget):
            return True
        counts[group] = int(counts.get(group, 0)) + 1
        fresh.meta.annotations[contract.GROUP_RESTARTS_ANNOTATION_KEY] = json.dumps(counts, sort_keys=True)
        self.store.update(fresh)
        return False

    # ---- worker groupset construction (ref :386-458) --------------------
    def _construct_worker_groupset(self, leader_pod: Pod, lws: LeaderWorkerSet, revision) -> GroupSet:
        current_lws = revisionutils.apply_revision(lws, revision)
        template = clone_object(current_lws.spec.leader_worker_template.worker_template)

        group_index = leader_pod.meta.labels.get(contract.GROUP_INDEX_LABEL_KEY, "")
        group_key = leader_pod.meta.labels.get(contract.GROUP_UNIQUE_HASH_LABEL_KEY, "")
        selector = {
            contract.GROUP_INDEX_LABEL_KEY: group_index,
            contract.SET_NAME_LABEL_KEY: lws.meta.name,
            contract.GROUP_UNIQUE_HASH_LABEL_KEY: group_key,
        }
        labels = dict(selector)
        labels[contract.REVISION_LABEL_KEY] = revisionutils.get_revision_key(leader_pod)
        template.metadata.labels.update(labels)

        annotations = template.metadata.annotations
        size = lws.spec.leader_worker_template.size
        annotations[contract.SIZE_ANNOTATION_KEY] = str(size)
        annotations[contract.LEADER_POD_NAME_ANNOTATION_KEY] = leader_pod.meta.name
        if lws.meta.annotations.get(contract.EXCLUSIVE_KEY_ANNOTATION_KEY):
            annotations[contract.EXCLUSIVE_KEY_ANNOTATION_KEY] = lws.meta.annotations[
                contract.EXCLUSIVE_KEY_ANNOTATION_KEY
            ]
        sgp = current_lws.spec.leader_worker_template.sub_group_policy
        if sgp is not None:
            annotations[contract.SUBGROUP_SIZE_ANNOTATION_KEY] = str(sgp.sub_group_size)
            if lws.meta.annotations.get(contract.SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY):
                annotations[contract.SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY] = lws.meta.annotations[
                    contract.SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY
                ]
        add_tpu_annotations(leader_pod, annotations)

        service_name = leader_pod.meta.name
        if (
            lws.spec.network_config is None
            or lws.spec.network_config.subdomain_policy in (None, SubdomainPolicy.SHARED)
        ):
            service_name = lws.meta.name

        return GroupSet(
            meta=new_meta(
                leader_pod.meta.name,
                leader_pod.meta.namespace,
                labels=labels,
                owners=[leader_pod],
            ),
            spec=GroupSetSpec(
                replicas=size - 1,
                start_ordinal=1,
                selector=selector,
                template=template,
                service_name=service_name,
                update_strategy=GroupSetUpdateStrategy(),
                volume_claim_templates=clone_object(
                    current_lws.spec.leader_worker_template.volume_claim_templates
                ),
                pvc_retention_policy_when_deleted=current_lws.spec.leader_worker_template.pvc_retention_policy_when_deleted,
                pvc_retention_policy_when_scaled=current_lws.spec.leader_worker_template.pvc_retention_policy_when_scaled,
            ),
        )

    def _topology_value(self, pod: Pod, topology_key: str) -> Optional[str]:
        """≈ :315-336 topologyValueFromPod. Nodes are cluster-scoped."""
        from lws_tpu_torch.api.node import CLUSTER_NAMESPACE

        node = self.store.try_get("Node", CLUSTER_NAMESPACE, pod.spec.node_name)
        if node is None:
            return None
        return node.meta.labels.get(topology_key)

    def _ensure_service(self, lws, name: str, selector: dict[str, str], owner) -> None:
        if self.store.try_get("Service", lws.meta.namespace, name) is None:
            self.store.create(
                Service(
                    meta=new_meta(
                        name,
                        lws.meta.namespace,
                        labels={contract.SET_NAME_LABEL_KEY: lws.meta.name},
                        owners=[owner],
                    ),
                    spec=ServiceSpec(selector=selector, headless=True, publish_not_ready_addresses=True),
                )
            )
