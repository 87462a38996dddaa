"""DS helpers (≈ pkg/utils/disaggregatedset/utils.go): revision hashing,
naming, labels, revision-role grouping, initial-replicas snapshots.

The port's copy of lws_tpu/controllers/disagg/utils.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from lws_tpu_torch.api import disagg
from lws_tpu_torch.api.disagg import DisaggregatedRoleSpec, DisaggregatedSet
from lws_tpu_torch.api.meta import to_plain
from lws_tpu_torch.api.types import LeaderWorkerSet
from lws_tpu_torch.utils.common import stable_hash


def compute_revision(roles: list[DisaggregatedRoleSpec]) -> str:
    """sha of every role's name + LeaderWorkerTemplate (≈ utils.go:107-132);
    replicas excluded so scaling is never a new revision."""
    payload = []
    for role in sorted(roles, key=lambda r: r.name):
        payload.append(
            {
                "name": role.name,
                "template": to_plain(role.template.spec.leader_worker_template),
                "network_config": to_plain(role.template.spec.network_config),
            }
        )
    return stable_hash(payload)[:8]


def generate_name(ds_name: str, slice_idx: int, role: str, revision: str) -> str:
    """`<ds>-<slice>-<revision>-<role>` (KEP-846: slice before revision —
    the slice is the durable identity, the revision is ephemeral)."""
    return f"{ds_name}-{slice_idx}-{revision}-{role}"


def generate_service_name(ds_name: str, slice_idx: int, role: str, revision: str) -> str:
    """`<ds>-<slice>-<revision>-<role>-prv`."""
    return f"{ds_name}-{slice_idx}-{revision}-{role}-prv"


def generate_labels(ds_name: str, slice_idx: int, role: str, revision: str) -> dict[str, str]:
    return {
        disagg.DS_NAME_LABEL_KEY: ds_name,
        disagg.DS_SLICE_LABEL_KEY: str(slice_idx),
        disagg.DS_ROLE_LABEL_KEY: role,
        disagg.DS_REVISION_LABEL_KEY: revision,
    }


def slice_of(obj) -> int:
    """Slice index of a managed child (LWS/Service/pod); label-less children
    bucket into slice 0 (KEP-846 adoption semantics)."""
    raw = obj.meta.labels.get(disagg.DS_SLICE_LABEL_KEY, "0")
    return int(raw) if raw.isdigit() else 0


def get_role_names(ds: DisaggregatedSet) -> list[str]:
    return [r.name for r in ds.spec.roles]


def get_role_configs(ds: DisaggregatedSet) -> dict[str, DisaggregatedRoleSpec]:
    return {r.name: r for r in ds.spec.roles}


def get_lws_replicas(lws: LeaderWorkerSet) -> int:
    return lws.spec.replicas


def get_initial_replicas(lws: LeaderWorkerSet) -> int:
    """Planner baseline: the snapshot annotation, falling back to live spec."""
    raw = lws.meta.annotations.get(disagg.DS_INITIAL_REPLICAS_ANNOTATION_KEY)
    if raw is None:
        return get_lws_replicas(lws)
    return int(raw)


@dataclass
class RevisionRoles:
    revision: str
    roles: dict[str, LeaderWorkerSet] = field(default_factory=dict)

    def newest_creation(self) -> float:
        return max((lws.meta.creation_timestamp for lws in self.roles.values()), default=0.0)


class RevisionRolesList(list):
    def total_replicas_for_role(self, role: str) -> int:
        return sum(
            get_lws_replicas(g.roles[role]) for g in self if role in g.roles
        )

    def total_initial_replicas_for_role(self, role: str) -> int:
        return sum(
            get_initial_replicas(g.roles[role]) for g in self if role in g.roles
        )


def group_by_revision(lws_list: list[LeaderWorkerSet]) -> RevisionRolesList:
    groups: dict[str, RevisionRoles] = {}
    for lws in lws_list:
        revision = lws.meta.labels.get(disagg.DS_REVISION_LABEL_KEY, "")
        role = lws.meta.labels.get(disagg.DS_ROLE_LABEL_KEY, "")
        groups.setdefault(revision, RevisionRoles(revision=revision)).roles[role] = lws
    return RevisionRolesList(sorted(groups.values(), key=lambda g: g.revision))


def split_revisions(
    lws_list: list[LeaderWorkerSet], target_revision: str
) -> tuple[RevisionRolesList, Optional[RevisionRoles]]:
    """(old revisions, target revision or None) ≈ GetRevisionRolesList."""
    grouped = group_by_revision(lws_list)
    old = RevisionRolesList(g for g in grouped if g.revision != target_revision)
    new = next((g for g in grouped if g.revision == target_revision), None)
    return old, new
