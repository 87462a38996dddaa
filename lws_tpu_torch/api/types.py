"""LeaderWorkerSet API (≈ api/leaderworkerset/v1/leaderworkerset_types.go).

One group = 1 leader + (size-1) workers; an LWS runs `replicas` groups as
atomic replication units. Groups map 1:1 onto TPU slices; subgroups map onto
sub-slices (TP x PP). Naming contract:
  leader pod  : <lws>-<groupIndex>            (groupIndex in [0, replicas))
  worker pod  : <lws>-<groupIndex>-<workerIndex>   (workerIndex in [1, size))

The port's copy of lws_tpu/api/types.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from lws_tpu_torch.api.intstr import IntOrPercent
from lws_tpu_torch.api.meta import Condition, ObjectMeta, TypedObject
from lws_tpu_torch.api.pod import PodTemplateSpec, VolumeClaimTemplate


class RolloutStrategyType(str, Enum):
    # Replace groups incrementally under maxUnavailable/maxSurge/partition
    # control — the only strategy, as in the reference
    # (ref leaderworkerset_types.go:254-265).
    ROLLING_UPDATE = "RollingUpdate"


class RestartPolicy(str, Enum):
    # Recreate the whole group when any pod/container in it fails/restarts
    # (ref leaderworkerset_types.go:323-349).
    RECREATE_GROUP_ON_POD_RESTART = "RecreateGroupOnPodRestart"
    # Same, but only once no pod in the group is Pending (protects pulls).
    RECREATE_GROUP_AFTER_START = "RecreateGroupAfterStart"
    # Only the failed pod restarts.
    NONE = "None"
    # Deprecated alias of NONE.
    DEPRECATED_DEFAULT = "Default"


class StartupPolicy(str, Enum):
    # Workers are created as soon as the leader pod EXISTS (parallel startup).
    LEADER_CREATED = "LeaderCreated"
    # Workers are created only after the leader pod reports Ready — for
    # leaders that must initialize (e.g. coordinator bring-up) first
    # (ref leaderworkerset_types.go:351-365).
    LEADER_READY = "LeaderReady"


class SubdomainPolicy(str, Enum):
    # All groups share one headless service / DNS subdomain.
    SHARED = "Shared"
    # Each group gets its own headless service — needed when per-group
    # hostnames must not collide across replicas
    # (ref leaderworkerset_types.go:228-241).
    UNIQUE_PER_REPLICA = "UniquePerReplica"


class SubGroupPolicyType(str, Enum):
    # The leader is counted inside subgroup 0 (default TP x PP windowing).
    LEADER_WORKER = "LeaderWorker"
    # The leader sits outside every subgroup window — for leaders that only
    # coordinate and run no shard (ref leaderworkerset_types.go:150-176).
    LEADER_EXCLUDED = "LeaderExcluded"


@dataclass
class RollingUpdateConfiguration:
    """ref leaderworkerset_types.go:267-312."""

    # Groups with index < partition are not updated (canary / xPyD rollouts).
    partition: int = 0
    # Absolute or percent (floor) of replicas that may be unavailable.
    max_unavailable: IntOrPercent = 1
    # Absolute or percent (ceil) of extra burst replicas during update.
    max_surge: IntOrPercent = 0


@dataclass
class RolloutStrategy:
    type: RolloutStrategyType = RolloutStrategyType.ROLLING_UPDATE
    rolling_update_configuration: Optional[RollingUpdateConfiguration] = None


@dataclass
class SubGroupPolicy:
    type: Optional[SubGroupPolicyType] = None
    # size (LeaderWorker) or size-1 (either) must be divisible by this.
    sub_group_size: Optional[int] = None


@dataclass
class NetworkConfig:
    subdomain_policy: Optional[SubdomainPolicy] = None


@dataclass
class LeaderWorkerTemplate:
    worker_template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    leader_template: Optional[PodTemplateSpec] = None
    size: int = 1
    restart_policy: RestartPolicy = RestartPolicy.RECREATE_GROUP_ON_POD_RESTART
    sub_group_policy: Optional[SubGroupPolicy] = None
    volume_claim_templates: list[VolumeClaimTemplate] = field(default_factory=list)
    pvc_retention_policy_when_deleted: str = "Retain"
    pvc_retention_policy_when_scaled: str = "Retain"


@dataclass
class LeaderWorkerSetSpec:
    replicas: int = 1
    leader_worker_template: LeaderWorkerTemplate = field(default_factory=LeaderWorkerTemplate)
    rollout_strategy: RolloutStrategy = field(default_factory=RolloutStrategy)
    startup_policy: StartupPolicy = StartupPolicy.LEADER_CREATED
    network_config: Optional[NetworkConfig] = None


@dataclass
class LeaderWorkerSetStatus:
    conditions: list[Condition] = field(default_factory=list)
    # groups ready (updated or not).
    ready_replicas: int = 0
    # groups updated to latest revision (ready or not).
    updated_replicas: int = 0
    # groups created.
    replicas: int = 0
    # selector string for autoscalers — selects leader pods only.
    hpa_pod_selector: str = ""
    observed_generation: int = 0


# Condition types (ref leaderworkerset_types.go:392-411 + KEP-820 Failed).
CONDITION_AVAILABLE = "Available"
CONDITION_PROGRESSING = "Progressing"
CONDITION_UPDATE_IN_PROGRESS = "UpdateInProgress"
CONDITION_FAILED = "Failed"


@dataclass
class LeaderWorkerSet(TypedObject):
    kind = "LeaderWorkerSet"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaderWorkerSetSpec = field(default_factory=LeaderWorkerSetSpec)
    status: LeaderWorkerSetStatus = field(default_factory=LeaderWorkerSetStatus)
