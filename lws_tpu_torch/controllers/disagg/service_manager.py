"""Revision-aware per-role "private" services
(≈ pkg/controllers/disaggregatedset/service_manager.go).

`<ds>-<revision>-<role>-prv` is created only once the target revision is ready
on ALL roles (so clients flip atomically to a complete prefill+decode set),
and services of old, no-longer-ready revisions are deleted. On TPU these are
the KV-transfer / routing endpoints between roles.

The port's copy of lws_tpu/controllers/disagg/service_manager.py.
"""

from __future__ import annotations

from lws_tpu_torch.api import disagg
from lws_tpu_torch.api.disagg import DisaggregatedSet
from lws_tpu_torch.api.service import Service, ServiceSpec
from lws_tpu_torch.controllers.disagg import utils as dsutils
from lws_tpu_torch.core.store import Store, new_meta


class ServiceManager:
    def __init__(self, store: Store) -> None:
        self.store = store

    def reconcile_services(
        self,
        ds: DisaggregatedSet,
        slice_idx: int,
        revision_roles: dsutils.RevisionRolesList,
        target_revision: str,
    ) -> None:
        """Per-slice (KEP-846): selectors are slice-scoped so role-to-role
        pairing (the KV handoff) stays within a slice."""
        role_names = dsutils.get_role_names(ds)
        ready_revisions = {
            g.revision for g in revision_roles if self._revision_ready(g, role_names)
        }
        if not ready_revisions:
            return
        if target_revision not in ready_revisions:
            return  # keep old services until the new revision can serve

        for role in role_names:
            self._ensure_service(ds, slice_idx, role, target_revision)
        self._cleanup_drained_services(ds, slice_idx, ready_revisions, target_revision)

    @staticmethod
    def _revision_ready(group: dsutils.RevisionRoles, role_names: list[str]) -> bool:
        for role in role_names:
            lws = group.roles.get(role)
            if lws is None or lws.status.ready_replicas < 1:
                return False
        return True

    def _ensure_service(self, ds: DisaggregatedSet, slice_idx: int, role: str, revision: str) -> None:
        name = dsutils.generate_service_name(ds.meta.name, slice_idx, role, revision)
        if self.store.try_get("Service", ds.meta.namespace, name) is not None:
            return
        labels = dsutils.generate_labels(ds.meta.name, slice_idx, role, revision)
        self.store.create(
            Service(
                meta=new_meta(name, ds.meta.namespace, labels=labels, owners=[ds]),
                spec=ServiceSpec(
                    selector=dict(labels), headless=True, publish_not_ready_addresses=False
                ),
            )
        )

    def _cleanup_drained_services(
        self, ds: DisaggregatedSet, slice_idx: int, ready_revisions: set[str], target_revision: str
    ) -> None:
        keep = set(ready_revisions) | {target_revision}
        services = [
            svc
            for svc in self.store.list(
                "Service", ds.meta.namespace, labels={disagg.DS_NAME_LABEL_KEY: ds.meta.name}
            )
            if dsutils.slice_of(svc) == slice_idx
        ]
        for svc in services:
            revision = svc.meta.labels.get(disagg.DS_REVISION_LABEL_KEY, "")
            if revision not in keep:
                self.store.delete("Service", svc.meta.namespace, svc.meta.name)
