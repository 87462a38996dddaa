"""Pod: the unit of execution — one host process bound to (part of) a TPU host.

The reference borrows corev1.Pod from Kubernetes; this framework owns the kind.
A Pod carries containers (env + chip resources), a subdomain for rendezvous
DNS, scheduling constraints (nodeSelector + affinity terms), and a status the
runtime/backends maintain.

The port's copy of lws_tpu/api/pod.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.meta import ObjectMeta, TypedObject


@dataclass
class EnvVar:
    name: str
    value: str = ""


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    command: list[str] = field(default_factory=list)
    # Ordered list — ordering is part of the contract: LWS_LEADER_ADDRESS is
    # always injected first so later vars may reference it
    # (ref pkg/utils/pod/pod_utils.go:131-179).
    env: list[EnvVar] = field(default_factory=list)
    # resource name -> amount, e.g. {"google.com/tpu": 4}
    resources: dict[str, int] = field(default_factory=dict)
    ports: dict[str, int] = field(default_factory=dict)

    def env_value(self, name: str) -> tuple[bool, str]:
        for e in self.env:
            if e.name == name:
                return True, e.value
        return False, ""

    def tpu_chips(self) -> int:
        return int(self.resources.get(contract.TPU_RESOURCE_NAME, 0))


class AffinityOperator(str, Enum):
    # Label value must be one of the listed values.
    IN = "In"
    # Label value must not be any of the listed values.
    NOT_IN = "NotIn"
    # Label key must be present (values ignored).
    EXISTS = "Exists"
    # Label key must be absent (values ignored).
    DOES_NOT_EXIST = "DoesNotExist"


@dataclass
class LabelSelectorRequirement:
    key: str
    operator: AffinityOperator
    values: list[str] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        present = self.key in labels
        if self.operator == AffinityOperator.EXISTS:
            return present
        if self.operator == AffinityOperator.DOES_NOT_EXIST:
            return not present
        if self.operator == AffinityOperator.IN:
            return present and labels[self.key] in self.values
        if self.operator == AffinityOperator.NOT_IN:
            return (not present) or labels[self.key] not in self.values
        return False


@dataclass
class AffinityTerm:
    """Require co-location (affinity) or spreading (anti-affinity) against pods
    matching the selector, at the granularity of `topology_key` node-label
    domains (≈ corev1.PodAffinityTerm; used for exclusive 1:1 slice placement,
    ref pkg/webhooks/pod_webhook.go:185-227)."""

    topology_key: str
    match_expressions: list[LabelSelectorRequirement] = field(default_factory=list)

    def selector_matches(self, labels: dict[str, str]) -> bool:
        return all(r.matches(labels) for r in self.match_expressions)


@dataclass
class PodAffinity:
    required_affinity: list[AffinityTerm] = field(default_factory=list)
    required_anti_affinity: list[AffinityTerm] = field(default_factory=list)


@dataclass
class VolumeClaimTemplate:
    name: str
    storage: str = ""
    storage_class: str = ""
    access_modes: list[str] = field(default_factory=lambda: ["ReadWriteOnce"])


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=lambda: [Container()])
    init_containers: list[Container] = field(default_factory=list)
    subdomain: str = ""
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[PodAffinity] = None
    scheduler_name: str = ""
    # Filled by the scheduler at bind time.
    node_name: str = ""

    def all_containers(self) -> list[Container]:
        return list(self.containers) + list(self.init_containers)

    def requests_tpus(self) -> bool:
        return any(c.tpu_chips() > 0 for c in self.all_containers())

    def tpu_chips(self) -> int:
        return sum(c.tpu_chips() for c in self.containers)

    def effective_tpu_chips(self) -> int:
        """Schedulable chip demand: max(sum of main containers, largest init
        container) — k8s effective-request semantics, so init-container-only
        TPU requests still reserve capacity."""
        init_max = max((c.tpu_chips() for c in self.init_containers), default=0)
        return max(self.tpu_chips(), init_max)


@dataclass
class TemplateMeta:
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)


@dataclass
class PodTemplateSpec:
    metadata: TemplateMeta = field(default_factory=TemplateMeta)
    spec: PodSpec = field(default_factory=PodSpec)


class PodPhase(str, Enum):
    # Accepted but not yet scheduled/started (image pulls live here).
    PENDING = "Pending"
    # Bound to a node with all containers started.
    RUNNING = "Running"
    # All containers exited 0.
    SUCCEEDED = "Succeeded"
    # At least one container exited non-zero and will not be restarted.
    FAILED = "Failed"


@dataclass
class PodStatus:
    phase: PodPhase = PodPhase.PENDING
    ready: bool = False
    # Cumulative restarts across containers + init containers
    # (ref pkg/utils/pod/pod_utils.go:29-45 ContainerRestarted).
    container_restarts: int = 0
    address: str = ""  # host:... resolvable address, set by the backend
    message: str = ""


@dataclass
class Pod(TypedObject):
    kind = "Pod"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
