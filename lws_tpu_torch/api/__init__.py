"""L0 API layer: typed object model + the label/annotation/env contract.

Equivalent surface to the reference's `api/leaderworkerset/v1`,
`api/disaggregatedset/v1` and the core k8s kinds the reference borrows
(Pod, StatefulSet->GroupSet, Service, Node, ControllerRevision).

The port's copy of lws_tpu/api/__init__.py.
"""

from lws_tpu_torch.api import contract  # noqa: F401
from lws_tpu_torch.api.meta import Condition, ObjectMeta, OwnerReference, TypedObject  # noqa: F401
from lws_tpu_torch.api.pod import (  # noqa: F401
    AffinityTerm,
    Container,
    EnvVar,
    Pod,
    PodAffinity,
    PodPhase,
    PodSpec,
    PodStatus,
    PodTemplateSpec,
)
from lws_tpu_torch.api.groupset import (  # noqa: F401
    GroupSet,
    GroupSetSpec,
    GroupSetStatus,
    GroupSetUpdateStrategy,
)
from lws_tpu_torch.api.service import Service, ServiceSpec  # noqa: F401
from lws_tpu_torch.api.node import Node  # noqa: F401
from lws_tpu_torch.api.lease import Lease, LeaseSpec  # noqa: F401
from lws_tpu_torch.api.revision import ControllerRevision  # noqa: F401
from lws_tpu_torch.api.types import (  # noqa: F401
    LeaderWorkerSet,
    LeaderWorkerSetSpec,
    LeaderWorkerSetStatus,
    LeaderWorkerTemplate,
    NetworkConfig,
    RestartPolicy,
    RollingUpdateConfiguration,
    RolloutStrategy,
    RolloutStrategyType,
    StartupPolicy,
    SubdomainPolicy,
    SubGroupPolicy,
    SubGroupPolicyType,
)
from lws_tpu_torch.api.disagg import (  # noqa: F401
    DisaggregatedRoleSpec,
    DisaggregatedSet,
    DisaggregatedSetSpec,
    DisaggregatedSetStatus,
    LeaderWorkerSetTemplateSpec,
    RoleStatus,
)
