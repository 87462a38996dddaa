"""DisaggregatedSet API (≈ api/disaggregatedset/v1/disaggregatedset_types.go).

Coordinates 2-10 roles (e.g. prefill/decode), each an embedded LWS template,
as one versioned unit with N-dimensional lockstep rollouts. On TPU, each role
lands on its own slice pool; KV-transfer endpoints are published via
revision-aware per-role services.

The port's copy of lws_tpu/api/disagg.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from lws_tpu_torch.api.meta import Condition, ObjectMeta, TypedObject
from lws_tpu_torch.api.types import LeaderWorkerSetSpec

DOMAIN = "disaggregatedset.lws.tpu"

# Labels on child LWS + pods (ref disaggregatedset_types.go:24-39).
DS_NAME_LABEL_KEY = f"{DOMAIN}/name"
DS_ROLE_LABEL_KEY = f"{DOMAIN}/role"
DS_REVISION_LABEL_KEY = f"{DOMAIN}/revision"
# Snapshot of per-role replicas at rollout start (the planner baseline).
DS_INITIAL_REPLICAS_ANNOTATION_KEY = f"{DOMAIN}/initial-replicas"
# Slice identity (KEP-846): which copy of the whole role topology this
# LWS/pod/service belongs to. A slice is the durable outer identity; the
# revision is ephemeral within it.
DS_SLICE_LABEL_KEY = f"{DOMAIN}/slice"

MIN_ROLES = 2
MAX_ROLES = 10
# KEP-846: bound the per-reconcile slice fan-out.
MAX_SLICES = 64


@dataclass
class TemplateObjectMeta:
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)


@dataclass
class LeaderWorkerSetTemplateSpec:
    metadata: TemplateObjectMeta = field(default_factory=TemplateObjectMeta)
    spec: LeaderWorkerSetSpec = field(default_factory=LeaderWorkerSetSpec)


@dataclass
class DisaggregatedRoleSpec:
    name: str = ""
    replicas: int = 1
    template: LeaderWorkerSetTemplateSpec = field(default_factory=LeaderWorkerSetTemplateSpec)


@dataclass
class DisaggregatedSetSpec:
    roles: list[DisaggregatedRoleSpec] = field(default_factory=list)
    # KEP-846: number of independent copies of the whole role topology. Each
    # slice rolls out on its own clock; changing slices is a scale operation
    # (excluded from the revision hash, never triggers a rollout).
    slices: int = 1


@dataclass
class RoleStatus:
    name: str = ""
    replicas: int = 0
    ready_replicas: int = 0
    updated_replicas: int = 0


@dataclass
class DisaggregatedSetStatus:
    conditions: list[Condition] = field(default_factory=list)
    roles: list[RoleStatus] = field(default_factory=list)
    current_revision: str = ""
    observed_generation: int = 0


@dataclass
class DisaggregatedSet(TypedObject):
    kind = "DisaggregatedSet"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DisaggregatedSetSpec = field(default_factory=DisaggregatedSetSpec)
    status: DisaggregatedSetStatus = field(default_factory=DisaggregatedSetStatus)

    def role(self, name: str) -> Optional[DisaggregatedRoleSpec]:
        for r in self.spec.roles:
            if r.name == name:
                return r
        return None
