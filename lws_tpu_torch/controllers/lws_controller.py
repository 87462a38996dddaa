"""LeaderWorkerSet controller (≈ pkg/controllers/leaderworkerset_controller.go).

Reconcile: fetch -> revision management -> rolling-update parameters
(5 cases + surge reclaim, ref :258-373) -> apply leader GroupSet -> shared
headless service -> status/conditions -> truncate revisions when done.

The port's copy of lws_tpu/controllers/lws_controller.py.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.groupset import GroupSet, GroupSetSpec, GroupSetUpdateStrategy, groupset_ready
from lws_tpu_torch.api.intstr import scaled_value
from lws_tpu_torch.api.meta import Condition
from lws_tpu_torch.api.pod import Pod, PodTemplateSpec
from lws_tpu_torch.api.service import Service, ServiceSpec
from lws_tpu_torch.api.types import (
    CONDITION_AVAILABLE,
    CONDITION_FAILED,
    CONDITION_PROGRESSING,
    CONDITION_UPDATE_IN_PROGRESS,
    LeaderWorkerSet,
    SubdomainPolicy,
    SubGroupPolicyType,
)
from lws_tpu_torch.core import metrics as metricsmod, trace
from lws_tpu_torch.core.events import EventRecorder
from lws_tpu_torch.core.manager import Result
from lws_tpu_torch.core.store import clone_object, Key, Store, new_meta
from lws_tpu_torch.utils import revision as revisionutils
from lws_tpu_torch.utils.common import nonzero, sort_by_index
from lws_tpu_torch.utils.podutils import pod_running_and_ready


@dataclass
class ReplicaState:
    """Per-group (ready, updated) pair (ref :569-580)."""

    ready: bool = False
    updated: bool = False


class LWSReconciler:
    name = "lws"

    def __init__(self, store: Store, recorder: EventRecorder, metrics=None) -> None:
        self.store = store
        self.recorder = recorder
        # Rollout-progress gauge sink (default: the process registry; the
        # harness passes its per-control-plane registry).
        self.metrics = metrics if metrics is not None else metricsmod.REGISTRY
        # Per-replica (ready, updated) memo keyed by leader-pod identity and
        # invalidated by (pod rv, worker-gs rv, revision key): the status
        # pass runs on EVERY LWS requeue — O(fleet) events per rollout, each
        # paying an O(replicas) recompute, i.e. O(fleet^2) total. The flags
        # are pure functions of the two objects (rv changes iff content
        # changes), so unchanged replicas become two dict hits. Bounded LRU
        # (informer-cache semantics, like the scheduler's indexes).
        self._replica_memo: collections.OrderedDict = collections.OrderedDict()

    def _replica_flags(self, namespace: str, pod, gs, revision_key: str,
                       no_worker_gs: bool) -> tuple[bool, bool]:
        key = (namespace, pod.meta.name)
        gs_rv = None if no_worker_gs else gs.meta.resource_version
        memo = self._replica_memo.get(key)
        if (memo is not None and memo[0] == pod.meta.resource_version
                and memo[1] == gs_rv and memo[2] == revision_key):
            self._replica_memo.move_to_end(key)
            return memo[3], memo[4]
        ready = (
            (no_worker_gs or groupset_ready(gs)) and pod_running_and_ready(pod)
        )
        updated = (
            (no_worker_gs or revisionutils.get_revision_key(gs) == revision_key)
            and revisionutils.get_revision_key(pod) == revision_key
        )
        self._replica_memo[key] = (
            pod.meta.resource_version, gs_rv, revision_key, ready, updated
        )
        while len(self._replica_memo) > 65536:
            self._replica_memo.popitem(last=False)
        return ready, updated

    # ------------------------------------------------------------------
    def reconcile(self, key: Key) -> Result | None:
        lws = self.store.try_get("LeaderWorkerSet", key[1], key[2])
        if lws is None or not isinstance(lws, LeaderWorkerSet):
            return None

        # One store snapshot per reconcile: leader pods + every owned
        # groupset, shared by the rolling-update math and the status pass.
        # Re-listing per phase was the rollout hot path at fleet scale — and
        # a single snapshot is also more coherent than three taken at
        # different points of the same reconcile. list_shared: these are
        # READ-ONLY (every mutation below re-fetches via get()); the
        # per-call deep clone of 2x replicas objects was the remaining
        # rollout bottleneck (CONTROL_r04).
        leader_pods = self.store.list_shared(
            "Pod",
            lws.meta.namespace,
            labels={contract.SET_NAME_LABEL_KEY: lws.meta.name, contract.WORKER_INDEX_LABEL_KEY: "0"},
        )
        groupsets = self.store.list_shared(
            "GroupSet", lws.meta.namespace, labels={contract.SET_NAME_LABEL_KEY: lws.meta.name}
        )
        gs_by_name = {g.meta.name: g for g in groupsets}
        leader_gs = gs_by_name.get(lws.meta.name)

        # Revision management (ref :138-157, :722-766).
        revision = self._get_or_create_revision(leader_gs, lws)
        updated_revision = self._get_updated_revision(leader_gs, lws, revision)
        lws_updated = updated_revision is not None
        if lws_updated:
            revision = updated_revision
            self.recorder.event(
                lws, "Normal", "CreatingRevision",
                f"Creating revision with key {revisionutils.get_revision_key(revision)} for updated LWS",
            )
        revision_key = revisionutils.get_revision_key(revision)

        with trace.span("reconcile.rollout_step", revision=revision_key) as sp:
            partition, replicas = self._rolling_update_parameters(
                lws, leader_gs, revision_key, lws_updated, leader_pods, gs_by_name
            )
            sp.set(partition=partition, replicas=replicas)
        with trace.span("reconcile.placement"):
            self._apply_leader_groupset(lws, partition, replicas, revision_key)
            if leader_gs is None:
                self.recorder.event(lws, "Normal", "GroupsProgressing", f"Created leader groupset {lws.meta.name}")
            elif not lws_updated and partition != leader_gs.spec.update_strategy.partition:
                self.recorder.event(lws, "Normal", "GroupsUpdating", f"Updating partition to {partition}")

            self._reconcile_headless_services(lws)

        with trace.span("reconcile.status"):
            update_done = self._update_status(lws, revision_key, leader_pods, gs_by_name)
        if update_done:
            revisionutils.truncate_revisions(self.store, lws, revision_key)
        return None

    # ---- revisions ----------------------------------------------------
    def _get_or_create_revision(self, leader_gs, lws):
        revision_key = ""
        if leader_gs is not None:
            revision_key = revisionutils.get_revision_key(leader_gs)
        if revision_key:
            existing = revisionutils.get_revision(self.store, lws, revision_key)
            if existing is not None:
                return existing
        return revisionutils.get_or_create_current_revision(self.store, lws)

    def _get_updated_revision(self, leader_gs, lws, revision):
        """Non-None iff the live template semantically differs from the
        revision the leader groupset runs (ref :747-766)."""
        if leader_gs is None:
            return None
        if revisionutils.equal_revision(lws, revision):
            return None
        return revisionutils.get_or_create_current_revision(self.store, lws)

    # ---- rolling update parameters (ref :258-373) ---------------------
    def _rolling_update_parameters(
        self, lws: LeaderWorkerSet, gs: Optional[GroupSet], revision_key: str,
        lws_updated: bool, leader_pods: list, gs_by_name: dict,
    ) -> tuple[int, int]:
        lws_replicas = lws.spec.replicas
        cfg = lws.spec.rollout_strategy.rolling_update_configuration
        lws_partition = cfg.partition if cfg else 0

        def clamp(partition: int, replicas: int) -> tuple[int, int]:
            return max(partition, lws_partition), replicas

        # Case 1: groupset not created yet.
        if gs is None:
            return clamp(0, lws_replicas)

        gs_replicas = gs.spec.replicas
        max_surge = scaled_value(cfg.max_surge if cfg else 0, lws_replicas, True)
        max_unavailable = scaled_value(cfg.max_unavailable if cfg else 1, lws_replicas, False)
        max_surge = min(max_surge, lws_replicas)
        burst_replicas = lws_replicas + max_surge

        states: Optional[list[ReplicaState]] = None

        def want_replicas(unready: int) -> int:
            return calculate_rolling_update_replicas(lws_replicas, max_surge, max_unavailable, unready)

        # Case 2: a new rolling update starts now.
        if lws_updated:
            partition = min(lws_replicas, gs_replicas)
            if gs_replicas < lws_replicas:
                return clamp(partition, lws_replicas)
            return clamp(partition, want_replicas(lws_replicas))

        partition = gs.spec.update_strategy.partition
        rolling_update_completed = partition == 0 and gs_replicas == lws_replicas
        # Case 3: steady state.
        if rolling_update_completed:
            return clamp(0, lws_replicas)
        if gs_replicas < lws_replicas:
            return clamp(partition, lws_replicas)

        states = self._get_replica_states(
            lws, gs_replicas, revision_key, leader_pods, gs_by_name
        )
        lws_unready = calculate_lws_unready_replicas(states, lws_replicas)

        original_replicas = int(gs.meta.annotations.get(contract.REPLICAS_ANNOTATION_KEY, lws_replicas))
        # Case 4: replicas changed during rolling update.
        if original_replicas != lws_replicas:
            partition = min(partition, burst_replicas)
            return clamp(partition, want_replicas(lws_unready))

        # Case 5: partition progression during rolling update.
        rolling_step = max_unavailable + max_surge - (burst_replicas - gs_replicas)
        partition = rolling_update_partition(states, gs_replicas, rolling_step, partition)
        return clamp(partition, want_replicas(lws_unready))

    # ---- replica states (ref :576-641) --------------------------------
    def _get_replica_states(
        self, lws: LeaderWorkerSet, gs_replicas: int, revision_key: str,
        leader_pods: list, gs_by_name: dict,
    ) -> list["ReplicaState"]:
        sorted_pods = sort_by_index(
            lambda p: int(p.meta.labels[contract.GROUP_INDEX_LABEL_KEY]), leader_pods, gs_replicas
        )
        worker_groupsets = [
            g for g in gs_by_name.values()
            if contract.GROUP_INDEX_LABEL_KEY in g.meta.labels
        ]
        sorted_gs = sort_by_index(
            lambda g: int(g.meta.labels[contract.GROUP_INDEX_LABEL_KEY]), worker_groupsets, gs_replicas
        )
        no_worker_gs = lws.spec.leader_worker_template.size == 1

        states = []
        for idx in range(gs_replicas):
            nominated = f"{lws.meta.name}-{idx}"
            pod = sorted_pods[idx]
            gs = sorted_gs[idx]
            if pod is None or pod.meta.name != nominated or (
                not no_worker_gs and (gs is None or gs.meta.name != nominated)
            ):
                states.append(ReplicaState(False, False))
                continue
            ready, updated = self._replica_flags(
                lws.meta.namespace, pod, gs, revision_key, no_worker_gs
            )
            states.append(ReplicaState(ready, updated))
        return states

    # ---- leader groupset construction/apply (ref :768-868) -------------
    def _apply_leader_groupset(
        self, lws: LeaderWorkerSet, partition: int, replicas: int, revision_key: str
    ) -> None:
        tmpl_src = (
            lws.spec.leader_worker_template.leader_template
            or lws.spec.leader_worker_template.worker_template
        )
        template: PodTemplateSpec = clone_object(tmpl_src)
        template.metadata.labels.update(
            {
                contract.WORKER_INDEX_LABEL_KEY: "0",
                contract.SET_NAME_LABEL_KEY: lws.meta.name,
                contract.REVISION_LABEL_KEY: revision_key,
            }
        )
        annotations = template.metadata.annotations
        annotations[contract.SIZE_ANNOTATION_KEY] = str(lws.spec.leader_worker_template.size)
        if lws.meta.annotations.get(contract.EXCLUSIVE_KEY_ANNOTATION_KEY):
            annotations[contract.EXCLUSIVE_KEY_ANNOTATION_KEY] = lws.meta.annotations[
                contract.EXCLUSIVE_KEY_ANNOTATION_KEY
            ]
        sgp = lws.spec.leader_worker_template.sub_group_policy
        if sgp is not None:
            annotations[contract.SUBGROUP_POLICY_TYPE_ANNOTATION_KEY] = (
                sgp.type or SubGroupPolicyType.LEADER_WORKER
            ).value
            annotations[contract.SUBGROUP_SIZE_ANNOTATION_KEY] = str(sgp.sub_group_size)
            if lws.meta.annotations.get(contract.SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY):
                annotations[contract.SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY] = lws.meta.annotations[
                    contract.SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY
                ]
        if (
            lws.spec.network_config is not None
            and lws.spec.network_config.subdomain_policy == SubdomainPolicy.UNIQUE_PER_REPLICA
        ):
            annotations[contract.SUBDOMAIN_POLICY_ANNOTATION_KEY] = SubdomainPolicy.UNIQUE_PER_REPLICA.value

        cfg = lws.spec.rollout_strategy.rolling_update_configuration
        lws_max_unavailable = scaled_value(cfg.max_unavailable if cfg else 1, lws.spec.replicas, False)
        lws_max_surge = scaled_value(cfg.max_surge if cfg else 0, lws.spec.replicas, True)
        lws_max_surge = min(lws_max_surge, lws.spec.replicas)
        gs_max_unavailable = max(1, lws_max_unavailable + lws_max_surge)

        spec = GroupSetSpec(
            replicas=replicas,
            start_ordinal=0,
            selector={
                contract.SET_NAME_LABEL_KEY: lws.meta.name,
                contract.WORKER_INDEX_LABEL_KEY: "0",
            },
            template=template,
            service_name=lws.meta.name,
            update_strategy=GroupSetUpdateStrategy(partition=partition, max_unavailable=gs_max_unavailable),
            volume_claim_templates=clone_object(lws.spec.leader_worker_template.volume_claim_templates),
            pvc_retention_policy_when_deleted=lws.spec.leader_worker_template.pvc_retention_policy_when_deleted,
            pvc_retention_policy_when_scaled=lws.spec.leader_worker_template.pvc_retention_policy_when_scaled,
        )
        labels = {contract.SET_NAME_LABEL_KEY: lws.meta.name, contract.REVISION_LABEL_KEY: revision_key}
        gs_annotations = {contract.REPLICAS_ANNOTATION_KEY: str(lws.spec.replicas)}

        # Server-side apply with fieldManager "lws" + force — the reference's
        # exact write pattern (leaderworkerset_controller.go:375-411): this
        # controller durably owns the fields it sets; an external controller
        # can co-own DISJOINT fields of the derived groupset (its own
        # labels/annotations) and they survive every reconcile (no whole-
        # object clobber). apply() is a no-op when nothing changed, creates
        # when absent, and retries rv races internally.
        from lws_tpu_torch.api.meta import to_plain
        from lws_tpu_torch.core.store import owner_ref

        self.store.apply(
            "GroupSet", lws.meta.namespace, lws.meta.name,
            {
                "meta": {
                    "labels": labels,
                    "annotations": gs_annotations,
                    "owner_references": [to_plain(owner_ref(lws))],
                },
                "spec": to_plain(spec),
            },
            field_manager="lws",
            force=True,
        )

    # ---- services (ref :213-221) ---------------------------------------
    def _reconcile_headless_services(self, lws: LeaderWorkerSet) -> None:
        if (
            lws.spec.network_config is None
            or lws.spec.network_config.subdomain_policy in (None, SubdomainPolicy.SHARED)
        ):
            if self.store.try_get("Service", lws.meta.namespace, lws.meta.name) is None:
                self.store.create(
                    Service(
                        meta=new_meta(
                            lws.meta.name,
                            lws.meta.namespace,
                            labels={contract.SET_NAME_LABEL_KEY: lws.meta.name},
                            owners=[lws],
                        ),
                        spec=ServiceSpec(
                            selector={contract.SET_NAME_LABEL_KEY: lws.meta.name},
                            headless=True,
                            publish_not_ready_addresses=True,
                        ),
                    )
                )

    # ---- status & conditions (ref :414-567) -----------------------------
    def _update_status(
        self, lws: LeaderWorkerSet, revision_key: str, leader_pods: list, gs_by_name: dict
    ) -> bool:
        fresh = self.store.get("LeaderWorkerSet", lws.meta.namespace, lws.meta.name)
        # The leader groupset is re-fetched (not taken from the snapshot):
        # _apply_leader_groupset may have just created/resized it.
        gs = self.store.try_get("GroupSet", lws.meta.namespace, lws.meta.name)
        if gs is None:
            return False
        changed = False
        if fresh.status.replicas != gs.status.replicas:
            fresh.status.replicas = gs.status.replicas
            changed = True
        if fresh.status.observed_generation != fresh.meta.generation:
            fresh.status.observed_generation = fresh.meta.generation
            changed = True
        hpa_selector = (
            f"{contract.SET_NAME_LABEL_KEY}={lws.meta.name},{contract.WORKER_INDEX_LABEL_KEY}=0"
        )
        if not fresh.status.hpa_pod_selector:
            fresh.status.hpa_pod_selector = hpa_selector
            changed = True

        cond_changed, update_done = self._update_conditions(
            fresh, revision_key, leader_pods, gs_by_name
        )
        if changed or cond_changed:
            self.store.update_status(fresh)
        return update_done

    def _update_conditions(
        self, lws: LeaderWorkerSet, revision_key: str, leader_pods: list, gs_by_name: dict
    ) -> tuple[bool, bool]:
        no_worker_gs = lws.spec.leader_worker_template.size == 1
        cfg = lws.spec.rollout_strategy.rolling_update_configuration
        lws_partition = cfg.partition if cfg else 0
        replicas = lws.spec.replicas

        ready_count = updated_count = ready_non_burst = 0
        part_updated_non_burst = part_current_non_burst = part_updated_and_ready = 0

        for pod in leader_pods:
            try:
                index = int(pod.meta.labels[contract.GROUP_INDEX_LABEL_KEY])
            except (KeyError, ValueError):
                continue
            gs = None
            if not no_worker_gs:
                gs = gs_by_name.get(pod.meta.name)
                if gs is None:
                    continue
            if index < replicas and index >= lws_partition:
                part_current_non_burst += 1
            ready, updated = self._replica_flags(
                lws.meta.namespace, pod, gs, revision_key, no_worker_gs
            )
            if ready:
                ready_count += 1
            if updated:
                updated_count += 1
                if index < replicas and index >= lws_partition:
                    part_updated_non_burst += 1
            if index < replicas:
                if ready:
                    ready_non_burst += 1
                if index >= lws_partition and ready and updated:
                    part_updated_and_ready += 1

        changed = False
        if lws.status.ready_replicas != ready_count:
            lws.status.ready_replicas = ready_count
            changed = True
        if lws.status.updated_replicas != updated_count:
            lws.status.updated_replicas = updated_count
            changed = True

        conditions: list[Condition] = []
        if self._exceeded_restart_budget(lws):
            # KEP-820 fail-fast: terminal Failed state.
            conditions.append(
                Condition(CONDITION_FAILED, True, reason="GroupRestartBudgetExceeded",
                          message="A group exceeded its restart budget; not restarting further")
            )
        elif part_updated_non_burst < part_current_non_burst:
            conditions.append(make_condition(CONDITION_UPDATE_IN_PROGRESS))
            conditions.append(make_condition(CONDITION_PROGRESSING))
        elif ready_non_burst == replicas and part_updated_and_ready == part_current_non_burst:
            conditions.append(make_condition(CONDITION_AVAILABLE))
        else:
            conditions.append(make_condition(CONDITION_PROGRESSING))

        # Rollout progress gauge: fraction of desired groups already on the
        # target revision — the "why did the 512-group rollout stall?"
        # signal, scrape-able instead of derived from bench timers. Exactly
        # ONE series per LWS: superseded revisions' series retire here (a
        # stale series would misreport a stalled rollout forever AND leak
        # label-cardinality slots across revision churn).
        lws_label = f"{lws.meta.namespace}/{lws.meta.name}"
        self.metrics.clear_gauge("lws_rollout_progress", {"lws": lws_label})
        self.metrics.set(
            "lws_rollout_progress",
            updated_count / replicas if replicas else 1.0,
            {"lws": lws_label, "revision": revision_key},
        )

        update_done = lws_partition == 0 and part_updated_and_ready == replicas
        cond_changed = set_conditions(lws, conditions)
        if cond_changed:
            self.recorder.event(
                lws, "Normal", conditions[0].reason,
                f"{conditions[0].message}, with {ready_count} groups ready of total {replicas} groups",
            )
        return changed or cond_changed, update_done

    def _exceeded_restart_budget(self, lws: LeaderWorkerSet) -> bool:
        budget = lws.meta.annotations.get(contract.MAX_GROUP_RESTARTS_ANNOTATION_KEY)
        if budget is None:
            return False
        import json

        counts = json.loads(lws.meta.annotations.get(contract.GROUP_RESTARTS_ANNOTATION_KEY, "{}"))
        return any(int(c) >= int(budget) for c in counts.values())


# ---- pure partition math (ref :643-708) ------------------------------------


def rolling_update_partition(
    states: list[ReplicaState], gs_replicas: int, rolling_step: int, current_partition: int
) -> int:
    continuous_ready = calculate_continuous_ready_replicas(states)
    rolling_step_partition = nonzero(gs_replicas - continuous_ready - rolling_step)

    unavailable = sum(1 for idx in range(rolling_step_partition) if not states[idx].ready)
    partition = rolling_step_partition + unavailable

    # Escape hatch: skip over continuously not-ready/updated replicas above the
    # floor so a violated maxUnavailable can't wedge the update.
    idx = min(partition, gs_replicas - 1)
    while idx >= rolling_step_partition:
        if not states[idx].ready or states[idx].updated:
            partition = idx
        else:
            break
        idx -= 1

    return min(partition, current_partition)


def calculate_continuous_ready_replicas(states: list[ReplicaState]) -> int:
    count = 0
    for state in reversed(states):
        if not state.ready or not state.updated:
            break
        count += 1
    return count


def calculate_lws_unready_replicas(states: list[ReplicaState], lws_replicas: int) -> int:
    unready = 0
    for idx in range(lws_replicas):
        if idx >= len(states) or not states[idx].ready or not states[idx].updated:
            unready += 1
    return unready


def calculate_rolling_update_replicas(
    lws_replicas: int, max_surge: int, max_unavailable: int, unready: int
) -> int:
    burst = lws_replicas + max_surge
    if unready <= max_surge:
        # Keep surge only for unready desired replicas beyond the budget;
        # reclaim the rest gradually (ref :685-696).
        return lws_replicas + nonzero(unready - max_unavailable)
    return burst


def make_condition(ctype: str) -> Condition:
    if ctype == CONDITION_AVAILABLE:
        return Condition(CONDITION_AVAILABLE, True, reason="AllGroupsReady", message="All replicas are ready")
    if ctype == CONDITION_UPDATE_IN_PROGRESS:
        return Condition(
            CONDITION_UPDATE_IN_PROGRESS, True, reason="GroupsUpdating", message="Rolling Upgrade is in progress"
        )
    return Condition(
        CONDITION_PROGRESSING, True, reason="GroupsProgressing", message="Replicas are progressing"
    )


EXCLUSIVE_CONDITION_TYPES = [
    {CONDITION_AVAILABLE, CONDITION_PROGRESSING},
    {CONDITION_AVAILABLE, CONDITION_UPDATE_IN_PROGRESS},
]


def exclusive_condition_types(a: str, b: str) -> bool:
    """≈ :947-963 — Available is mutually exclusive with both Progressing and
    UpdateInProgress."""
    return a != b and {a, b} in EXCLUSIVE_CONDITION_TYPES


def set_conditions(lws: LeaderWorkerSet, conditions: list[Condition]) -> bool:
    changed = False
    for cond in conditions:
        changed = _set_condition(lws, cond) or changed
    return changed


def _set_condition(lws: LeaderWorkerSet, new: Condition) -> bool:
    """≈ :914-946 setCondition: upsert-if-true, flipping mutually exclusive
    true conditions to false rather than removing them."""
    import time

    changed = False
    found = False
    for cur in lws.status.conditions:
        if cur.type == new.type:
            if cur.status != new.status:
                cur.status = new.status
                cur.reason = new.reason
                cur.message = new.message
                cur.last_transition_time = time.time()
                changed = True
            found = True
        elif exclusive_condition_types(cur.type, new.type) and new.status and cur.status:
            cur.status = False
            cur.last_transition_time = time.time()
            changed = True
    if new.status and not found:
        new.last_transition_time = time.time()
        lws.status.conditions.append(new)
        changed = True
    return changed
