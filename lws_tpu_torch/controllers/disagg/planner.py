"""DisaggregatedSet rollout planner — stateless pure math
(behavioral parity with pkg/controllers/disaggregatedset/planner.go:320).

The planner discretizes a linear interpolation between initialOld and target:

    newAtStep(i) = ceil(i * target / totalSteps)              # 0 -> target
    oldAtStep(i) = initialOld - floor(i * initialOld / totalSteps)  # -> 0

The controller is stateless, so the current step index is derived from the
observed replica counts each call. Invariants:
  * decoupling — each step changes EITHER old OR new, never both;
  * surge — old + new <= target + maxSurge per role;
  * availability floor — old never drops below target - maxUnavailable - new;
  * orphan prevention — no role sits at 0 while a sibling still serves
    (drain all-to-zero together or hold at 1);
  * abnormal-state correction and a force-drain fallback.

The port's copy of lws_tpu/controllers/disagg/planner.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

RoleReplicaState = list[int]


@dataclass
class UpdateStep:
    past: RoleReplicaState
    new: RoleReplicaState


@dataclass
class RollingUpdateConfig:
    max_surge: int = 1
    max_unavailable: int = 0


def default_rolling_update_config(num_roles: int) -> list[RollingUpdateConfig]:
    return [RollingUpdateConfig(max_surge=1, max_unavailable=0) for _ in range(num_roles)]


def _batch_size(max_surge: int, max_unavailable: int) -> int:
    if max_surge > 0:
        return max_surge
    return max(1, max_unavailable)


def compute_total_steps(
    initial_old: RoleReplicaState, target: RoleReplicaState, config: list[RollingUpdateConfig]
) -> int:
    total = 0
    for i in range(len(initial_old)):
        max_replicas = max(initial_old[i], target[i], 0)
        steps = -(-max_replicas // _batch_size(config[i].max_surge, config[i].max_unavailable))
        total = max(total, steps)
    return total


def compute_next_new_replicas(
    target: RoleReplicaState, current_new: RoleReplicaState, total_steps: int
) -> RoleReplicaState:
    n = len(target)
    if total_steps == 0:
        return list(target)

    def step_index(current: int, target_val: int) -> int:
        if target_val == 0:
            return total_steps
        return int(current * total_steps / target_val)

    min_step = min((step_index(current_new[i], target[i]) for i in range(n)), default=total_steps)
    next_step = min_step + 1

    def compute(target_val: int, current_val: int) -> int:
        progress = next_step * target_val / total_steps
        return max(min(math.ceil(progress), target_val), current_val)

    return [compute(target[i], current_new[i]) for i in range(n)]


def compute_next_old_replicas(
    initial_old: RoleReplicaState, current_old: RoleReplicaState, total_steps: int
) -> RoleReplicaState:
    n = len(initial_old)
    if total_steps == 0:
        return [0] * n

    def step_index(removed: int, source: int) -> int:
        if source == 0:
            return 0
        return int(removed * total_steps / source)

    max_step = 0
    for i in range(n):
        if initial_old[i] == 0:
            continue
        max_step = max(max_step, step_index(initial_old[i] - current_old[i], initial_old[i]))
    next_step = max_step + 1

    def compute(source: int, current: int) -> int:
        progress = next_step * source / total_steps
        return min(max(0, source - math.floor(progress)), current)

    return [compute(initial_old[i], current_old[i]) for i in range(n)]


def _correct_abnormal_state(
    current_old: RoleReplicaState, current_new: RoleReplicaState, initial_old: RoleReplicaState
) -> Optional[UpdateStep]:
    expected_old = [min(initial_old[i], current_old[i]) for i in range(len(initial_old))]
    if any(current_old[i] > expected_old[i] for i in range(len(initial_old))):
        return UpdateStep(past=expected_old, new=list(current_new))
    return None


def _is_complete(current_old, current_new, target_new) -> bool:
    return all(
        current_old[i] == 0 and current_new[i] >= target_new[i] for i in range(len(current_old))
    )


def _is_new_at_target(current_new, target_new) -> bool:
    return all(current_new[i] >= target_new[i] for i in range(len(current_new)))


def _can_scale_up(current_old, next_new, target_new, config) -> bool:
    for i in range(len(current_old)):
        if target_new[i] == 0:
            continue
        if current_old[i] + next_new[i] > target_new[i] + config[i].max_surge:
            return False
    return True


def _compute_min_old(initial_old, current_new, target_new, config) -> list[int]:
    min_old = [0] * len(initial_old)
    for i in range(len(initial_old)):
        if initial_old[i] >= target_new[i]:
            min_old[i] = max(0, target_new[i] - config[i].max_unavailable - current_new[i])
    return min_old


def _try_scale_up(current_old, current_new, next_new, target_new, config) -> Optional[UpdateStep]:
    if not any(next_new[i] > current_new[i] for i in range(len(current_new))):
        return None
    if not _can_scale_up(current_old, next_new, target_new, config):
        return None
    return UpdateStep(past=list(current_old), new=list(next_new))


def _try_proportional_drain(
    initial_old, current_old, current_new, target_new, min_old, total_steps, config
) -> Optional[UpdateStep]:
    next_old = compute_next_old_replicas(initial_old, current_old, total_steps)
    for i in range(len(next_old)):
        next_old[i] = max(next_old[i], min_old[i])
    _apply_orphan_prevention(next_old, current_new, initial_old, target_new, config)
    if not any(next_old[i] < current_old[i] for i in range(len(next_old))):
        return None
    return UpdateStep(past=next_old, new=list(current_new))


def _can_drain_all_to_zero(next_new, initial_old, target, config) -> bool:
    for i in range(len(target)):
        if initial_old[i] >= target[i]:
            if next_new[i] < target[i] - config[i].max_unavailable:
                return False
    return True


def _apply_orphan_prevention(next_old, current_new, initial_old, target, config) -> None:
    any_zero = False
    all_zero = True
    for i in range(len(next_old)):
        if initial_old[i] == 0:
            continue
        if next_old[i] == 0:
            any_zero = True
        else:
            all_zero = False
    if not any_zero or all_zero:
        return
    if _can_drain_all_to_zero(current_new, initial_old, target, config):
        for i in range(len(next_old)):
            next_old[i] = 0
        return
    for i in range(len(next_old)):
        if next_old[i] == 0 and initial_old[i] > 0:
            next_old[i] = 1


def _try_force_drain(current_old, next_new, initial_old, target_new, config) -> Optional[UpdateStep]:
    drained = [0] * len(current_old)
    needs_drain = False
    for i in range(len(current_old)):
        max_old = target_new[i] + config[i].max_surge - next_new[i]
        drained[i] = max(0, min(current_old[i], max_old))
        if initial_old[i] >= target_new[i]:
            floor_for_role = max(0, target_new[i] - config[i].max_unavailable - next_new[i])
            drained[i] = max(drained[i], floor_for_role)
        if drained[i] < current_old[i]:
            needs_drain = True
    if not needs_drain:
        return None
    _apply_orphan_prevention(drained, next_new, initial_old, target_new, config)
    return UpdateStep(past=drained, new=list(next_new))


def ComputeNextStep(
    initial_old: RoleReplicaState,
    current_old: RoleReplicaState,
    current_new: RoleReplicaState,
    target_new: RoleReplicaState,
    config: list[RollingUpdateConfig],
) -> Optional[UpdateStep]:
    if _is_complete(current_old, current_new, target_new):
        return None
    total_steps = compute_total_steps(initial_old, target_new, config)
    if total_steps == 0:
        return None
    step = _correct_abnormal_state(current_old, current_new, initial_old)
    if step is not None:
        return step
    if _is_new_at_target(current_new, target_new):
        return UpdateStep(past=[0] * len(initial_old), new=list(current_new))

    next_new = compute_next_new_replicas(target_new, current_new, total_steps)
    min_old = _compute_min_old(initial_old, current_new, target_new, config)

    step = _try_scale_up(current_old, current_new, next_new, target_new, config)
    if step is not None:
        return step
    step = _try_proportional_drain(
        initial_old, current_old, current_new, target_new, min_old, total_steps, config
    )
    if step is not None:
        return step
    return _try_force_drain(current_old, next_new, initial_old, target_new, config)


def ComputeAllSteps(
    initial_old: RoleReplicaState, target: RoleReplicaState, config: list[RollingUpdateConfig]
) -> list[UpdateStep]:
    """Full-rollout simulator (test/tooling; ≈ planner.go:355-385)."""
    n = len(initial_old)
    current_old = list(initial_old)
    current_new = [0] * n
    max_replicas = max([0] + [max(initial_old[i], target[i]) for i in range(n)])
    max_steps = max_replicas * 2 + 10
    steps = [UpdateStep(past=list(initial_old), new=[0] * n)]
    for _ in range(max_steps):
        nxt = ComputeNextStep(initial_old, current_old, current_new, target, config)
        if nxt is None:
            break
        steps.append(nxt)
        current_old = nxt.past
        current_new = nxt.new
    return steps
