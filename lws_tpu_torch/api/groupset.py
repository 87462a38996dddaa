"""GroupSet: ordered, stable-identity set of pods (≈ appsv1.StatefulSet).

The reference delegates this kind to Kubernetes; here it is native. Pods are
named `<groupset>-<ordinal>` with ordinals in
[start_ordinal, start_ordinal+replicas); worker groupsets start at ordinal 1
(the leader pod is ordinal 0 of the *leader* groupset,
ref pkg/controllers/pod_controller.go:440).

The port's copy of lws_tpu/api/groupset.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject
from lws_tpu_torch.api.pod import PodTemplateSpec, VolumeClaimTemplate


@dataclass
class GroupSetUpdateStrategy:
    """RollingUpdate semantics: pods with ordinal >= partition whose revision
    differs from update_revision are recreated, highest ordinal first, keeping
    unavailable pods in the update range <= max_unavailable."""

    partition: int = 0
    max_unavailable: int = 1


@dataclass
class GroupSetSpec:
    replicas: int = 0
    start_ordinal: int = 0
    selector: dict[str, str] = field(default_factory=dict)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    service_name: str = ""
    update_strategy: GroupSetUpdateStrategy = field(default_factory=GroupSetUpdateStrategy)
    volume_claim_templates: list[VolumeClaimTemplate] = field(default_factory=list)
    # "Delete" | "Retain" on groupset deletion / scale-down.
    pvc_retention_policy_when_deleted: str = "Retain"
    pvc_retention_policy_when_scaled: str = "Retain"


@dataclass
class GroupSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    updated_replicas: int = 0
    current_revision: str = ""
    update_revision: str = ""


@dataclass
class GroupSet(TypedObject):
    kind = "GroupSet"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: GroupSetSpec = field(default_factory=GroupSetSpec)
    status: GroupSetStatus = field(default_factory=GroupSetStatus)

    def pod_name(self, ordinal: int) -> str:
        return f"{self.meta.name}-{ordinal}"

    def ordinals(self) -> range:
        return range(self.spec.start_ordinal, self.spec.start_ordinal + self.spec.replicas)


def groupset_ready(gs: GroupSet) -> bool:
    """≈ pkg/utils/statefulset/statefulset_utils.go:48-51 StatefulsetReady."""
    return (
        gs.status.available_replicas == gs.spec.replicas
        and gs.status.current_revision == gs.status.update_revision
    )


def parent_name_and_ordinal(pod_name: str) -> tuple[Optional[str], int]:
    """Parse `<parent>-<ordinal>` (≈ statefulset_utils.go:34-46)."""
    head, sep, tail = pod_name.rpartition("-")
    if not sep or not tail.isdigit():
        return None, -1
    return head, int(tail)
