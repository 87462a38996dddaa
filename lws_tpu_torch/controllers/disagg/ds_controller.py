"""DisaggregatedSet reconciler
(≈ pkg/controllers/disaggregatedset/disaggregatedset_controller.go:53-124).

Four steps: compute target revision -> GC fully-drained old revisions ->
rolling update (executor) or simple create/scale -> revision-aware role
services. Plus status aggregation over the child LWS objects.

The port's copy of lws_tpu/controllers/disagg/ds_controller.py.
"""

from __future__ import annotations

from lws_tpu_torch.api import disagg
from lws_tpu_torch.api.disagg import DisaggregatedSet, RoleStatus
from lws_tpu_torch.controllers.disagg import utils as dsutils
from lws_tpu_torch.controllers.disagg.executor import RollingUpdateExecutor
from lws_tpu_torch.controllers.disagg.lws_manager import LWSManager
from lws_tpu_torch.controllers.disagg.service_manager import ServiceManager
from lws_tpu_torch.core import trace
from lws_tpu_torch.core.events import EventRecorder
from lws_tpu_torch.core.manager import Result
from lws_tpu_torch.core.store import Key, Store


class DSReconciler:
    name = "disaggregatedset"

    def __init__(self, store: Store, recorder: EventRecorder) -> None:
        self.store = store
        self.recorder = recorder
        self.lws_manager = LWSManager(store)
        self.service_manager = ServiceManager(store)
        self.executor = RollingUpdateExecutor(self.lws_manager, recorder)

    def reconcile(self, key: Key) -> Result | None:
        ds = self.store.try_get("DisaggregatedSet", key[1], key[2])
        if ds is None or not isinstance(ds, DisaggregatedSet):
            return None

        revision = dsutils.compute_revision(ds.spec.roles)
        self._scale_down_slices(ds)
        # Each slice is an independent rollout domain (KEP-846). One scan,
        # grouped by slice, instead of O(slices) label-filtered scans.
        want = max(1, ds.spec.slices)
        by_slice: dict[int, list] = {i: [] for i in range(want)}
        for lws in self.lws_manager.list(ds.meta.namespace, ds.meta.name):
            by_slice.setdefault(dsutils.slice_of(lws), []).append(lws)
        for slice_idx in range(want):
            snapshot = by_slice.get(slice_idx, [])
            snapshot = self._cleanup_drained_lws(ds, revision, snapshot)

            old_revisions, new_revision = dsutils.split_revisions(snapshot, revision)
            total_old = sum(
                old_revisions.total_replicas_for_role(role) for role in dsutils.get_role_names(ds)
            )
            with trace.span(
                "reconcile.rollout_step", slice=slice_idx, revision=revision
            ) as step_span:
                if old_revisions and total_old > 0:
                    step_span.set(path="rolling", old_replicas=total_old)
                    self.executor.reconcile(ds, slice_idx, revision, old_revisions, new_revision)
                else:
                    step_span.set(path="simple")
                    self._reconcile_simple(ds, slice_idx, revision)

            with trace.span("reconcile.placement", slice=slice_idx):
                slice_lws = self.lws_manager.list(ds.meta.namespace, ds.meta.name, slice_idx=slice_idx)
                revision_roles = dsutils.group_by_revision(slice_lws)
                self.service_manager.reconcile_services(ds, slice_idx, revision_roles, revision)

        with trace.span("reconcile.status"):
            self._update_status(ds, self.lws_manager.list(ds.meta.namespace, ds.meta.name), revision)
        return None

    # ---- slice scale-down (KEP-846: plain deletion, no drain — slices are
    # independent, there is no cross-slice invariant to protect) -----------
    def _scale_down_slices(self, ds: DisaggregatedSet) -> None:
        want = max(1, ds.spec.slices)
        for lws in self.lws_manager.list(ds.meta.namespace, ds.meta.name):
            if dsutils.slice_of(lws) >= want:
                self.lws_manager.delete(ds.meta.namespace, lws.meta.name)
                self.recorder.event(ds, "Normal", "SliceRemoved", f"Deleted {lws.meta.name}")
        for svc in self.store.list(
            "Service", ds.meta.namespace, labels={disagg.DS_NAME_LABEL_KEY: ds.meta.name}
        ):
            if dsutils.slice_of(svc) >= want:
                self.store.delete("Service", svc.meta.namespace, svc.meta.name)

    # ---- simple path (ref :135-187) ------------------------------------
    def _reconcile_simple(self, ds: DisaggregatedSet, slice_idx: int, revision: str) -> None:
        for role, config in dsutils.get_role_configs(ds).items():
            name = dsutils.generate_name(ds.meta.name, slice_idx, role, revision)
            existing = self.lws_manager.get(ds.meta.namespace, name)
            if existing is None:
                self.lws_manager.create(ds, slice_idx, role, config, revision, replicas=config.replicas)
            elif existing.spec.replicas != config.replicas:
                self.lws_manager.scale(ds.meta.namespace, name, config.replicas)

    # ---- drained-revision GC (ref :193-248) -----------------------------
    def _cleanup_drained_lws(self, ds: DisaggregatedSet, revision: str, snapshot: list) -> list:
        """Deletes fully-drained old revisions; returns the remaining LWS."""
        by_revision: dict[str, list] = {}
        for lws in snapshot:
            lws_revision = lws.meta.labels.get(disagg.DS_REVISION_LABEL_KEY, "")
            if lws_revision == revision:
                continue
            by_revision.setdefault(lws_revision, []).append(lws)
        deleted: set[str] = set()
        for old_revision, lws_list in by_revision.items():
            if any(lws.spec.replicas != 0 for lws in lws_list):
                continue
            for lws in lws_list:
                self.lws_manager.delete(ds.meta.namespace, lws.meta.name)
                deleted.add(lws.meta.name)
                self.recorder.event(ds, "Normal", "LWSDeleted", f"Deleted drained LWS {lws.meta.name}")
        return [lws for lws in snapshot if lws.meta.name not in deleted]

    # ---- status ---------------------------------------------------------
    def _update_status(self, ds: DisaggregatedSet, all_lws, revision: str) -> None:
        fresh = self.store.get("DisaggregatedSet", ds.meta.namespace, ds.meta.name)
        roles: list[RoleStatus] = []
        for role in dsutils.get_role_names(ds):
            replicas = ready = updated = 0
            for lws in all_lws:
                if lws.meta.labels.get(disagg.DS_ROLE_LABEL_KEY) != role:
                    continue
                replicas += lws.status.replicas
                ready += lws.status.ready_replicas
                if lws.meta.labels.get(disagg.DS_REVISION_LABEL_KEY) == revision:
                    # Every group of a target-revision child IS updated,
                    # ready or not (ref disaggregatedset_types.go:89-91).
                    updated += lws.status.replicas
            roles.append(RoleStatus(name=role, replicas=replicas, ready_replicas=ready, updated_replicas=updated))
        from lws_tpu_torch.api.meta import to_plain

        changed = (
            to_plain(fresh.status.roles) != to_plain(roles)
            or fresh.status.current_revision != revision
            or fresh.status.observed_generation != fresh.meta.generation
        )
        if changed:
            fresh.status.roles = roles
            fresh.status.current_revision = revision
            fresh.status.observed_generation = fresh.meta.generation
            self.store.update_status(fresh)
