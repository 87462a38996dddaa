"""PodGroup: gang-scheduling unit (≈ Volcano PodGroup,
ref pkg/schedulerprovider/volcano_provider.go:49-101).

One PodGroup per LWS replica: `<lws>-<groupIdx>-<revision>`; min_member is the
whole group (or 1 under LeaderReady startup), min_resources the whole-group
chip/cpu sum. On TPU a slice is inherently gang-allocated; the scheduler uses
this to admit the group onto a slice all-or-nothing.

The port's copy of lws_tpu/api/podgroup.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject


@dataclass
class PodGroupSpec:
    min_member: int = 1
    min_resources: dict[str, int] = field(default_factory=dict)
    queue: str = ""


@dataclass
class PodGroupStatus:
    phase: str = "Pending"  # Pending | Running


@dataclass
class PodGroup(TypedObject):
    kind = "PodGroup"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)
