"""Object metadata shared by every API kind (≈ metav1.ObjectMeta/Condition).

The port's copy of lws_tpu/api/meta.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str
    controller: bool = True


@dataclass
class Condition:
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    generation: int = 0
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[OwnerReference] = field(default_factory=list)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    # Server-side apply field ownership (≈ metadata.managedFields, ref
    # leaderworkerset_controller.go:375-411 fieldManager "lws" + force):
    # field-manager name -> sorted list of leaf field paths (each a list of
    # plain-tree keys) that manager owns. Maintained exclusively by
    # Store.apply; plain update() preserves it.
    managed_fields: dict[str, list[list[str]]] = field(default_factory=dict)

    def controller_owner(self) -> Optional[OwnerReference]:
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None


class TypedObject:
    """Base for all API objects: a `kind` class attr + `meta` field.

    Objects are plain mutable dataclasses; the Store deep-copies on the way in
    and out, so held references never alias stored state (same isolation the
    reference gets from the apiserver boundary).
    """

    kind: str = ""
    meta: ObjectMeta

    def key(self) -> tuple[str, str, str]:
        return (self.kind, self.meta.namespace, self.meta.name)

    def deepcopy(self):
        from lws_tpu_torch.core.store import clone_object

        return clone_object(self)

    def set_condition(self, cond: Condition, conditions: list[Condition]) -> bool:
        """Upsert by type; returns True if anything changed. Transition time
        only moves when status flips (≈ apimachinery SetStatusCondition)."""
        for i, existing in enumerate(conditions):
            if existing.type == cond.type:
                if (
                    existing.status == cond.status
                    and existing.reason == cond.reason
                    and existing.message == cond.message
                ):
                    return False
                if existing.status == cond.status:
                    cond.last_transition_time = existing.last_transition_time
                else:
                    cond.last_transition_time = time.time()
                conditions[i] = cond
                return True
        cond.last_transition_time = time.time()
        conditions.append(cond)
        return True


def find_condition(conditions: list[Condition], ctype: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


def to_plain(obj: Any) -> Any:
    """Canonical plain-data form (dicts/lists/scalars) for hashing/snapshots.

    Enum -> value, dataclass -> dict (None fields dropped for stable hashes
    across optional-field additions, mirroring the reference's
    json-roundtrip+strategic-merge-patch canonicalization,
    ref pkg/utils/revision/revision_utils.go:265-297).
    """
    import dataclasses
    import enum

    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = to_plain(getattr(obj, f.name))
            if v is None:
                continue
            out[f.name] = v
        return out
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj
