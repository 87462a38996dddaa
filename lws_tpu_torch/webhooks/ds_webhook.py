"""DisaggregatedSet validation
(≈ pkg/webhooks/disaggregatedset/disaggregatedset_webhook.go + CRD CEL rules).

The port's copy of lws_tpu/webhooks/ds_webhook.py.
"""

from __future__ import annotations

from typing import Optional

from lws_tpu_torch.api.disagg import MAX_ROLES, MAX_SLICES, MIN_ROLES, DisaggregatedSet
from lws_tpu_torch.api.types import RolloutStrategyType
from lws_tpu_torch.core.store import AdmissionError, Store
from lws_tpu_torch.webhooks.lws_webhook import DNS1035


def validate_ds(ds: DisaggregatedSet, old: Optional[DisaggregatedSet]) -> None:
    if not DNS1035.match(ds.meta.name):
        raise AdmissionError(f"invalid name {ds.meta.name!r}: must be a valid DNS-1035 label")
    roles = ds.spec.roles
    if not (1 <= ds.spec.slices <= MAX_SLICES):
        raise AdmissionError(f"slices must be between 1 and {MAX_SLICES}")
    # Derived names must stay valid DNS labels: the longest is the private
    # service `<ds>-<slice>-<rev8>-<role>-prv` — reject at DS admission rather
    # than crash-looping reconcile when the child LWS is refused.
    slice_digits = len(str(max(1, ds.spec.slices) - 1))
    for r in roles:
        derived = len(ds.meta.name) + 1 + slice_digits + 1 + 8 + 1 + len(r.name) + 4
        if derived > 63:
            raise AdmissionError(
                f"name {ds.meta.name!r} + role {r.name!r} too long: derived service name "
                f"would be {derived} chars (max 63)"
            )
    if not (MIN_ROLES <= len(roles) <= MAX_ROLES):
        raise AdmissionError(f"roles must have between {MIN_ROLES} and {MAX_ROLES} entries")
    names = [r.name for r in roles]
    if len(set(names)) != len(names):
        raise AdmissionError("role names must be unique")
    for r in roles:
        if not DNS1035.match(r.name):
            raise AdmissionError(f"invalid role name {r.name!r}")
        if r.replicas < 0:
            raise AdmissionError(f"role {r.name}: replicas must be >= 0")
        strategy = r.template.spec.rollout_strategy
        # DS owns the cross-role rollout: per-role partitions are forbidden
        # (ref disaggregatedset_webhook.go:78-102).
        if strategy.type not in (None, RolloutStrategyType.ROLLING_UPDATE):
            raise AdmissionError(f"role {r.name}: rolloutStrategy.type must be RollingUpdate")
        rc = strategy.rolling_update_configuration
        if rc is not None and rc.partition not in (0, None):
            raise AdmissionError(
                f"role {r.name}: partition is not allowed (DisaggregatedSet owns cross-role rollout)"
            )
    # CEL rule: replicas all-zero or all-nonzero (disaggregatedset_types.go:62-73).
    zero = [r.name for r in roles if r.replicas == 0]
    if zero and len(zero) != len(roles):
        raise AdmissionError(
            f"role replicas must be all-zero or all-nonzero (zero roles: {zero})"
        )


def register_ds_webhooks(store: Store) -> None:
    store.register_validator("DisaggregatedSet", validate_ds)
