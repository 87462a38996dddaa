"""Rolling-update executor: drives the planner against the cluster
(≈ pkg/controllers/disaggregatedset/executor.go).

init: snapshot initial-replicas on every old LWS, create 0-replica LWS per
role for the target revision. Steady loop: wait for the new revision to
stabilize (ReadyReplicas == Replicas on all roles), compute ONE planner step,
scale up new, scale down old newest-revision-first with per-role budgets and
the coordinated drain trigger (any role hitting 0 drags its whole revision to
0 — prefill without decode serves nothing).

The port's copy of lws_tpu/controllers/disagg/executor.py.
"""

from __future__ import annotations

from lws_tpu_torch.api.disagg import DisaggregatedSet
from lws_tpu_torch.api.intstr import scaled_value
from lws_tpu_torch.controllers.disagg import utils as dsutils
from lws_tpu_torch.controllers.disagg.lws_manager import LWSManager
from lws_tpu_torch.controllers.disagg.planner import (
    ComputeNextStep,
    RollingUpdateConfig,
    default_rolling_update_config,
)
from lws_tpu_torch.core.events import EventRecorder


class RollingUpdateExecutor:
    def __init__(self, lws_manager: LWSManager, recorder: EventRecorder) -> None:
        self.lws_manager = lws_manager
        self.recorder = recorder

    # ---- entry point (ref executor.go:56-83; slice-scoped per KEP-846) --
    def reconcile(
        self, ds: DisaggregatedSet, slice_idx: int, revision: str, old_revisions, new_revision
    ) -> None:
        role_names = dsutils.get_role_names(ds)
        role_configs = dsutils.get_role_configs(ds)
        if not old_revisions:
            return
        if new_revision is None:
            self._init_rolling_update(ds, slice_idx, revision, role_names, role_configs, old_revisions)
            return
        self._reconcile_rolling_update(ds, slice_idx, old_revisions, new_revision)

    # ---- init (ref :85-123) --------------------------------------------
    def _init_rolling_update(
        self, ds, slice_idx, revision, role_names, role_configs, old_revisions
    ) -> None:
        self.recorder.event(
            ds, "Normal", "RollingUpdateStarted",
            f"Started rolling update of slice {slice_idx} to revision {revision}",
        )
        for group in old_revisions:
            for role, lws in group.roles.items():
                self.lws_manager.set_initial_replicas(
                    ds.meta.namespace, lws.meta.name, dsutils.get_lws_replicas(lws)
                )
        for role in role_names:
            name = dsutils.generate_name(ds.meta.name, slice_idx, role, revision)
            if self.lws_manager.get(ds.meta.namespace, name) is None:
                self.lws_manager.create(ds, slice_idx, role, role_configs[role], revision, replicas=0)

    # ---- one step (ref :130-171) ---------------------------------------
    def _reconcile_rolling_update(self, ds, slice_idx, old_revisions, new_revision) -> None:
        spec_role_names = dsutils.get_role_names(ds)
        spec_role_set = set(spec_role_names)
        old_role_set = {role for g in old_revisions for role in g.roles}
        all_role_names = spec_role_names + sorted(old_role_set - spec_role_set)

        if not self._is_revision_stable(new_revision, spec_role_names):
            return  # child LWS status events retrigger us

        initial_old, current_old, current_new, target_new = self._build_planner_state(
            ds, all_role_names, spec_role_set, old_revisions, new_revision
        )
        config = self._extract_config(ds, all_role_names)

        step = ComputeNextStep(initial_old, current_old, current_new, target_new, config)
        if step is None:
            self.recorder.event(
                ds, "Normal", "RollingUpdateCompleted",
                f"Completed rolling update to revision {new_revision.revision}",
            )
            return

        self._scale_up_new(
            ds, slice_idx, new_revision, all_role_names, spec_role_set, current_new, step.new
        )
        self._scale_down_old(ds, old_revisions, all_role_names, current_old, step.past)

    # ---- planner state (ref :199-260) ----------------------------------
    @staticmethod
    def _build_planner_state(ds, all_role_names, spec_role_set, old_revisions, new_revision):
        n = len(all_role_names)
        initial_old, current_old = [0] * n, [0] * n
        current_new, target_new = [0] * n, [0] * n
        for i, role in enumerate(all_role_names):
            initial_old[i] = old_revisions.total_initial_replicas_for_role(role)
            current_old[i] = old_revisions.total_replicas_for_role(role)
            if role in spec_role_set:
                lws = new_revision.roles.get(role)
                if lws is not None:
                    current_new[i] = dsutils.get_lws_replicas(lws)
                target_new[i] = next(r.replicas for r in ds.spec.roles if r.name == role)
        return initial_old, current_old, current_new, target_new

    @staticmethod
    def _extract_config(ds, all_role_names) -> list[RollingUpdateConfig]:
        config = default_rolling_update_config(len(all_role_names))
        index = {name: i for i, name in enumerate(all_role_names)}
        for role in ds.spec.roles:
            rc = role.template.spec.rollout_strategy.rolling_update_configuration
            if rc is None:
                continue
            i = index[role.name]
            surge = scaled_value(rc.max_surge, role.replicas, True)
            unavail = scaled_value(rc.max_unavailable, role.replicas, False)
            if unavail > 0:
                config[i] = RollingUpdateConfig(max_surge=surge, max_unavailable=unavail)
            elif surge > 0:
                config[i] = RollingUpdateConfig(max_surge=surge, max_unavailable=0)
        return config

    @staticmethod
    def _is_revision_stable(revision_group, role_names) -> bool:
        for role in role_names:
            lws = revision_group.roles.get(role)
            if lws is None:
                return False
            if dsutils.get_lws_replicas(lws) != lws.status.ready_replicas:
                return False
        return True

    # ---- scaling (ref :306-398) ----------------------------------------
    def _scale_up_new(
        self, ds, slice_idx, new_revision, all_role_names, spec_role_set, current, target
    ) -> None:
        for i, role in enumerate(all_role_names):
            if role not in spec_role_set or current[i] >= target[i]:
                continue
            name = dsutils.generate_name(ds.meta.name, slice_idx, role, new_revision.revision)
            self.lws_manager.scale(ds.meta.namespace, name, target[i])
            self.recorder.event(
                ds, "Normal", "ScalingUp",
                f"Scaling up {role} LWS {name} from {current[i]} to {target[i]} replicas",
            )

    def _scale_down_old(self, ds, old_revisions, role_names, current, target) -> None:
        budget = [current[i] - target[i] for i in range(len(role_names))]
        newest_first = sorted(old_revisions, key=lambda g: -g.newest_creation())
        for group in newest_first:
            if all(b <= 0 for b in budget):
                break
            new_replicas: dict[str, int] = {}
            planned: dict[str, int] = {}
            triggers: set[str] = set()
            for i, role in enumerate(role_names):
                lws = group.roles.get(role)
                if lws is None:
                    continue
                replicas = dsutils.get_lws_replicas(lws)
                drain = min(max(0, budget[i]), replicas)
                planned[role] = drain
                new_replicas[role] = replicas - drain
                if new_replicas[role] == 0:
                    triggers.add(role)
            # Coordinated drain: if any role of this revision hits 0, drain
            # the whole revision to 0 (ref :368-377).
            if triggers:
                for role in role_names:
                    if role in group.roles:
                        new_replicas[role] = 0
            for i, role in enumerate(role_names):
                lws = group.roles.get(role)
                if lws is None:
                    continue
                replicas = dsutils.get_lws_replicas(lws)
                if replicas <= new_replicas[role]:
                    continue
                self.lws_manager.scale(ds.meta.namespace, lws.meta.name, new_replicas[role])
                self.recorder.event(
                    ds, "Normal", "ScalingDown",
                    f"Scaling down {role} LWS {lws.meta.name} from {replicas} to {new_replicas[role]} replicas",
                )
                if role in triggers or not triggers:
                    budget[i] -= planned[role]
