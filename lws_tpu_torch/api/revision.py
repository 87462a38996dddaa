"""ControllerRevision: immutable template snapshot (≈ appsv1.ControllerRevision).

Used as template history for update detection and worker-template snapshotting
(ref pkg/utils/revision/revision_utils.go).

The port's copy of lws_tpu/api/revision.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject


@dataclass
class ControllerRevision(TypedObject):
    kind = "ControllerRevision"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    # Plain-data snapshot of the revisable fields.
    data: dict[str, Any] = field(default_factory=dict)
    revision: int = 0
