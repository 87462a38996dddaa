"""Pod mutation (≈ pkg/webhooks/pod_webhook.go): THE single place the whole
distributed-bootstrap contract is written into pods (SURVEY §3.3).

Leader branch: group index from ordinal, subdomain override (UniquePerReplica),
sha1 group key, exclusive affinity/anti-affinity, subgroup-0 labels.
Worker branch: worker index from ordinal, subgroup index math.
Then: gang metadata, TPU env (if chips requested), LWS + JAX env for all.

The port's copy of lws_tpu/webhooks/pod_webhook.py.
"""

from __future__ import annotations

from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.groupset import parent_name_and_ordinal
from lws_tpu_torch.api.pod import (
    AffinityOperator,
    AffinityTerm,
    LabelSelectorRequirement,
    Pod,
    PodAffinity,
)
from lws_tpu_torch.api.types import SubdomainPolicy, SubGroupPolicyType
from lws_tpu_torch.core.store import Store
from lws_tpu_torch.sched.provider import SchedulerProvider
from lws_tpu_torch.utils.common import sha1_hash
from lws_tpu_torch.utils.podutils import add_lws_variables, is_leader_pod
from lws_tpu_torch.utils.tpu import add_tpu_variables, get_subgroup_index, pod_requests_tpus


def gen_group_unique_key(a: str, b: str) -> str:
    """≈ pod_webhook.go:180-183 genGroupUniqueKey (sha1 of "a/b")."""
    return sha1_hash(f"{a}/{b}")


def set_exclusive_affinities(pod: Pod, unique_key: str, topology_key: str, label_key: str) -> None:
    """1:1 exclusive placement (≈ pod_webhook.go:185-227): require landing in
    a topology domain with this group's pods; forbid domains hosting others."""
    if pod.spec.affinity is None:
        pod.spec.affinity = PodAffinity()
    aff = pod.spec.affinity
    # Skip if already applied for this key.
    for term in aff.required_affinity:
        if term.topology_key == topology_key and any(
            r.key == label_key for r in term.match_expressions
        ):
            return
    aff.required_affinity.append(
        AffinityTerm(
            topology_key=topology_key,
            match_expressions=[
                LabelSelectorRequirement(label_key, AffinityOperator.IN, [unique_key])
            ],
        )
    )
    aff.required_anti_affinity.append(
        AffinityTerm(
            topology_key=topology_key,
            match_expressions=[
                LabelSelectorRequirement(label_key, AffinityOperator.EXISTS),
                LabelSelectorRequirement(label_key, AffinityOperator.NOT_IN, [unique_key]),
            ],
        )
    )


class PodWebhook:
    def __init__(self, scheduler_provider: Optional[SchedulerProvider] = None) -> None:
        self.scheduler_provider = scheduler_provider

    def default(self, pod: Pod, old: Optional[Pod]) -> None:
        if old is not None:
            return  # mutate on create only
        if contract.SET_NAME_LABEL_KEY not in pod.meta.labels:
            return
        size_str = pod.meta.annotations.get(contract.SIZE_ANNOTATION_KEY)
        if size_str is None:
            raise ValueError(f"pod {pod.meta.name}: missing size annotation")
        pod_count = int(size_str)
        labels, annotations = pod.meta.labels, pod.meta.annotations

        if is_leader_pod(pod):
            if contract.GROUP_INDEX_LABEL_KEY not in labels:
                _, group_index = parent_name_and_ordinal(pod.meta.name)
                if group_index == -1:
                    raise ValueError(f"parsing pod ordinal for pod {pod.meta.name}")
                labels[contract.GROUP_INDEX_LABEL_KEY] = str(group_index)
            if annotations.get(contract.SUBDOMAIN_POLICY_ANNOTATION_KEY) == SubdomainPolicy.UNIQUE_PER_REPLICA.value:
                pod.spec.subdomain = pod.meta.name
            group_key = labels.get(contract.GROUP_UNIQUE_HASH_LABEL_KEY)
            if group_key is None:
                group_key = gen_group_unique_key(pod.meta.namespace, pod.meta.name)
                labels[contract.GROUP_UNIQUE_HASH_LABEL_KEY] = group_key
            ep_key = annotations.get(contract.EXCLUSIVE_KEY_ANNOTATION_KEY)
            if ep_key:
                set_exclusive_affinities(pod, group_key, ep_key, contract.GROUP_UNIQUE_HASH_LABEL_KEY)
            sub_policy = annotations.get(contract.SUBGROUP_POLICY_TYPE_ANNOTATION_KEY)
            if (
                contract.SUBGROUP_SIZE_ANNOTATION_KEY in annotations
                and not labels.get(contract.SUBGROUP_INDEX_LABEL_KEY)
                and sub_policy != SubGroupPolicyType.LEADER_EXCLUDED.value
            ):
                # The leader always lands in subgroup 0.
                labels[contract.SUBGROUP_INDEX_LABEL_KEY] = "0"
                sub_key = gen_group_unique_key(pod.meta.name, "0")
                labels[contract.SUBGROUP_UNIQUE_HASH_LABEL_KEY] = sub_key
                sub_ep_key = annotations.get(contract.SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY)
                if sub_ep_key:
                    set_exclusive_affinities(
                        pod, sub_key, sub_ep_key, contract.SUBGROUP_UNIQUE_HASH_LABEL_KEY
                    )
        else:
            _, worker_index = parent_name_and_ordinal(pod.meta.name)
            if worker_index == -1:
                raise ValueError(f"parsing pod ordinal for pod {pod.meta.name}")
            labels[contract.WORKER_INDEX_LABEL_KEY] = str(worker_index)
            if (
                contract.SUBGROUP_SIZE_ANNOTATION_KEY in annotations
                and not labels.get(contract.SUBGROUP_INDEX_LABEL_KEY)
            ):
                sgs = int(annotations[contract.SUBGROUP_SIZE_ANNOTATION_KEY])
                leader_name = annotations.get(contract.LEADER_POD_NAME_ANNOTATION_KEY, "")
                sub_index = get_subgroup_index(pod_count, sgs, worker_index)
                labels[contract.SUBGROUP_INDEX_LABEL_KEY] = str(sub_index)
                sub_key = gen_group_unique_key(leader_name, str(sub_index))
                labels[contract.SUBGROUP_UNIQUE_HASH_LABEL_KEY] = sub_key
                sub_ep_key = annotations.get(contract.SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY)
                if sub_ep_key:
                    set_exclusive_affinities(
                        pod, sub_key, sub_ep_key, contract.SUBGROUP_UNIQUE_HASH_LABEL_KEY
                    )

        if self.scheduler_provider is not None:
            self.scheduler_provider.inject_pod_group_metadata(pod)

        if pod_requests_tpus(pod):
            add_tpu_variables(pod, pod_count)

        add_lws_variables(pod)


def register_pod_webhooks(store: Store, scheduler_provider: Optional[SchedulerProvider] = None) -> None:
    store.register_mutator("Pod", PodWebhook(scheduler_provider).default)
