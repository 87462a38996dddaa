"""ControllerRevision-based template history
(≈ pkg/utils/revision/revision_utils.go).

A revision snapshots the revisable fields of an LWS — {network_config,
leader_worker_template} — so (a) template updates are detected semantically,
and (b) worker groups are built from the *revision their leader runs*, not the
live spec (no mixed groups mid-rollout, ref revision_utils.go:168-184).

The port's copy of lws_tpu/utils/revision.py.
"""

from __future__ import annotations

from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.meta import to_plain
from lws_tpu_torch.api.revision import ControllerRevision
from lws_tpu_torch.api.types import LeaderWorkerSet
from lws_tpu_torch.core.store import clone_object, Store, new_meta
from lws_tpu_torch.utils.common import stable_hash


def revision_data(lws: LeaderWorkerSet) -> dict:
    """The revisable subset (≈ getPatch, revision_utils.go:265-297)."""
    return {
        "leader_worker_template": clone_object(lws.spec.leader_worker_template),
        "network_config": clone_object(lws.spec.network_config),
    }


def hash_revision_data(data: dict) -> str:
    return stable_hash(data)


def get_revision_key(obj) -> str:
    return obj.meta.labels.get(contract.REVISION_LABEL_KEY, "")


def new_revision(lws: LeaderWorkerSet, revision_num: int = 1) -> ControllerRevision:
    data = revision_data(lws)
    key = hash_revision_data(data)
    rev = ControllerRevision(
        meta=new_meta(
            name=f"{lws.meta.name}-{key}",
            namespace=lws.meta.namespace,
            labels={
                contract.SET_NAME_LABEL_KEY: lws.meta.name,
                contract.REVISION_LABEL_KEY: key,
            },
            owners=[lws],
        ),
        data=data,
        revision=revision_num,
    )
    return rev


def list_revisions(store: Store, lws: LeaderWorkerSet) -> list[ControllerRevision]:
    revs = store.list(
        "ControllerRevision",
        lws.meta.namespace,
        labels={contract.SET_NAME_LABEL_KEY: lws.meta.name},
    )
    return sorted(revs, key=lambda r: r.revision)  # type: ignore[attr-defined]


def get_revision(store: Store, lws: LeaderWorkerSet, key: str) -> Optional[ControllerRevision]:
    for rev in list_revisions(store, lws):
        if get_revision_key(rev) == key:
            return rev
    return None


def equal_revision(lws: LeaderWorkerSet, rev: ControllerRevision) -> bool:
    """Semantic template equality (≈ revision_utils.go:188-235 EqualRevision;
    canonical plain-form comparison subsumes the serialization-drift LRU)."""
    return to_plain(revision_data(lws)) == to_plain(rev.data)


def get_or_create_current_revision(store: Store, lws: LeaderWorkerSet) -> ControllerRevision:
    """≈ leaderworkerset_controller.go:722-745 getOrCreateRevisionIfNonExist."""
    data = revision_data(lws)
    key = hash_revision_data(data)
    existing = get_revision(store, lws, key)
    if existing is not None:
        return existing
    revs = list_revisions(store, lws)
    next_num = (revs[-1].revision + 1) if revs else 1
    rev = new_revision(lws, next_num)
    return store.create(rev)  # type: ignore[return-value]


def apply_revision(lws: LeaderWorkerSet, rev: ControllerRevision) -> LeaderWorkerSet:
    """Restore the revisable fields from a snapshot (≈ ApplyRevision,
    revision_utils.go:168-184)."""
    restored = clone_object(lws)
    restored.spec.leader_worker_template = clone_object(rev.data["leader_worker_template"])
    restored.spec.network_config = clone_object(rev.data["network_config"])
    return restored


def truncate_revisions(store: Store, lws: LeaderWorkerSet, current_key: str) -> None:
    """GC all revisions but the current one, only safe once an update is done
    (≈ revision_utils.go:239-259 TruncateRevisions)."""
    for rev in list_revisions(store, lws):
        if get_revision_key(rev) != current_key:
            store.delete("ControllerRevision", rev.meta.namespace, rev.meta.name)
