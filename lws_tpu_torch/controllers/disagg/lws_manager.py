"""Child-LWS CRUD adapter (≈ pkg/controllers/disaggregatedset/lws_manager.go).

Creates per-role LWS objects with DS name/role/revision labels injected into
both the LWS and its pod templates (so pods are selectable by revision-aware
role services), scales via spec patch, and snapshots initial-replicas.

The port's copy of lws_tpu/controllers/disagg/lws_manager.py.
"""

from __future__ import annotations

from typing import Optional

from lws_tpu_torch.api import disagg
from lws_tpu_torch.api.disagg import DisaggregatedRoleSpec, DisaggregatedSet
from lws_tpu_torch.api.types import LeaderWorkerSet
from lws_tpu_torch.controllers.disagg import utils as dsutils
from lws_tpu_torch.core.store import clone_object, Store, new_meta


class LWSManager:
    def __init__(self, store: Store) -> None:
        self.store = store

    def get(self, namespace: str, name: str) -> Optional[LeaderWorkerSet]:
        obj = self.store.try_get("LeaderWorkerSet", namespace, name)
        return obj if isinstance(obj, LeaderWorkerSet) else None

    def list(
        self, namespace: str, ds_name: str, role: str = "", slice_idx: int | None = None
    ) -> list[LeaderWorkerSet]:
        labels = {disagg.DS_NAME_LABEL_KEY: ds_name}
        if role:
            labels[disagg.DS_ROLE_LABEL_KEY] = role
        out = self.store.list("LeaderWorkerSet", namespace, labels=labels)
        if slice_idx is not None:
            # KEP-846 bucketing: children with no slice label count as slice 0
            # (e.g. state files written before the slices feature).
            out = [l for l in out if dsutils.slice_of(l) == slice_idx]
        return out  # type: ignore[return-value]

    def create(
        self,
        ds: DisaggregatedSet,
        slice_idx: int,
        role: str,
        config: DisaggregatedRoleSpec,
        revision: str,
        replicas: int,
    ) -> LeaderWorkerSet:
        labels = dsutils.generate_labels(ds.meta.name, slice_idx, role, revision)
        spec = clone_object(config.template.spec)
        spec.replicas = replicas
        # Pods inherit the DS identity through their templates
        # (≈ lws_manager.go:59-107 label injection).
        spec.leader_worker_template.worker_template.metadata.labels.update(labels)
        if spec.leader_worker_template.leader_template is not None:
            spec.leader_worker_template.leader_template.metadata.labels.update(labels)
        meta_labels = {**config.template.metadata.labels, **labels}
        annotations = dict(config.template.metadata.annotations)
        lws = LeaderWorkerSet(
            meta=new_meta(
                dsutils.generate_name(ds.meta.name, slice_idx, role, revision),
                ds.meta.namespace,
                labels=meta_labels,
                annotations=annotations,
                owners=[ds],
            ),
            spec=spec,
        )
        return self.store.create(lws)  # type: ignore[return-value]

    def scale(self, namespace: str, name: str, replicas: int) -> None:
        lws = self.store.get("LeaderWorkerSet", namespace, name)
        if lws.spec.replicas != replicas:
            lws.spec.replicas = replicas
            self.store.update(lws)

    def delete(self, namespace: str, name: str) -> None:
        self.store.delete("LeaderWorkerSet", namespace, name)

    def set_initial_replicas(self, namespace: str, name: str, replicas: int) -> None:
        lws = self.get(namespace, name)
        if lws is None:
            return
        if lws.meta.annotations.get(disagg.DS_INITIAL_REPLICAS_ANNOTATION_KEY) == str(replicas):
            return
        lws.meta.annotations[disagg.DS_INITIAL_REPLICAS_ANNOTATION_KEY] = str(replicas)
        self.store.update(lws)
