"""LWS defaulting + validation (≈ pkg/webhooks/leaderworkerset_webhook.go).

The port's copy of lws_tpu/webhooks/lws_webhook.py.
"""

from __future__ import annotations

import re
from typing import Optional

from lws_tpu_torch.api.intstr import scaled_value, validate as validate_intstr
from lws_tpu_torch.api.meta import to_plain
from lws_tpu_torch.api.types import (
    LeaderWorkerSet,
    NetworkConfig,
    RestartPolicy,
    RollingUpdateConfiguration,
    RolloutStrategy,
    RolloutStrategyType,
    StartupPolicy,
    SubdomainPolicy,
    SubGroupPolicyType,
)
from lws_tpu_torch.core.store import AdmissionError, Store

MAX_INT32 = 2**31 - 1
# DNS-1035: the LWS name becomes a service name and a pod-name prefix.
DNS1035 = re.compile(r"^[a-z]([-a-z0-9]*[a-z0-9])?$")


def default_lws(lws: LeaderWorkerSet, old: Optional[LeaderWorkerSet]) -> None:
    """≈ :52-85 Default."""
    spec = lws.spec
    if spec.replicas is None:  # type: ignore[comparison-overlap]
        spec.replicas = 1
    if spec.leader_worker_template.size is None:  # type: ignore[comparison-overlap]
        spec.leader_worker_template.size = 1
    if spec.leader_worker_template.restart_policy == RestartPolicy.DEPRECATED_DEFAULT:
        spec.leader_worker_template.restart_policy = RestartPolicy.NONE
    if spec.rollout_strategy is None:  # type: ignore[comparison-overlap]
        spec.rollout_strategy = RolloutStrategy()
    if spec.rollout_strategy.type is None:  # type: ignore[comparison-overlap]
        spec.rollout_strategy.type = RolloutStrategyType.ROLLING_UPDATE
    if spec.rollout_strategy.rolling_update_configuration is None:
        spec.rollout_strategy.rolling_update_configuration = RollingUpdateConfiguration(
            partition=0, max_unavailable=1, max_surge=0
        )
    if spec.startup_policy is None:  # type: ignore[comparison-overlap]
        spec.startup_policy = StartupPolicy.LEADER_CREATED
    if spec.network_config is None:
        spec.network_config = NetworkConfig(subdomain_policy=SubdomainPolicy.SHARED)
    elif spec.network_config.subdomain_policy is None:
        spec.network_config.subdomain_policy = SubdomainPolicy.SHARED
    sgp = spec.leader_worker_template.sub_group_policy
    if sgp is not None and sgp.type is None:
        sgp.type = SubGroupPolicyType.LEADER_WORKER


def validate_lws(lws: LeaderWorkerSet, old: Optional[LeaderWorkerSet]) -> None:
    """≈ :92-256 ValidateCreate/ValidateUpdate."""
    if not DNS1035.match(lws.meta.name) or len(lws.meta.name) > 63:
        raise AdmissionError(
            f"invalid name {lws.meta.name!r}: must be a valid DNS-1035 label (it becomes the service name)"
        )
    spec = lws.spec
    if spec.replicas < 0:
        raise AdmissionError("replicas must be >= 0")
    size = spec.leader_worker_template.size
    if size < 1:
        raise AdmissionError("size must be >= 1")
    if spec.replicas * size > MAX_INT32:
        raise AdmissionError("replicas x size must not exceed MaxInt32")

    cfg = spec.rollout_strategy.rolling_update_configuration
    if cfg is not None:
        try:
            validate_intstr(cfg.max_unavailable, "maxUnavailable")
            validate_intstr(cfg.max_surge, "maxSurge")
        except ValueError as e:
            raise AdmissionError(str(e)) from e
        if cfg.partition < 0:
            raise AdmissionError("partition must be >= 0")
        mu = scaled_value(cfg.max_unavailable, spec.replicas, False)
        ms = scaled_value(cfg.max_surge, spec.replicas, True)
        if isinstance(cfg.max_unavailable, int) and isinstance(cfg.max_surge, int):
            if cfg.max_unavailable == 0 and cfg.max_surge == 0:
                raise AdmissionError("maxUnavailable and maxSurge must not both be 0")
        elif mu == 0 and ms == 0 and spec.replicas > 0:
            raise AdmissionError("maxUnavailable and maxSurge must not both resolve to 0")

    sgp = spec.leader_worker_template.sub_group_policy
    if sgp is not None:
        sgs = sgp.sub_group_size
        if sgs is None or sgs < 1:
            raise AdmissionError("subGroupSize must be >= 1")
        if sgs > size:
            raise AdmissionError("subGroupSize must not be greater than size")
        if (sgp.type or SubGroupPolicyType.LEADER_WORKER) == SubGroupPolicyType.LEADER_EXCLUDED:
            if (size - 1) % sgs != 0:
                raise AdmissionError("LeaderExcluded requires size-1 divisible by subGroupSize")
            leader_template = (
                spec.leader_worker_template.leader_template
                or spec.leader_worker_template.worker_template
            )
            if leader_template.spec.requests_tpus():
                raise AdmissionError(
                    "LeaderExcluded subgroups require a leader that does not request TPUs "
                    "(the leader is outside every subgroup's TPU hostname window)"
                )
        elif size % sgs != 0 and (size - 1) % sgs != 0:
            raise AdmissionError("size or size-1 must be divisible by subGroupSize")

    if spec.network_config is not None and spec.network_config.subdomain_policy is None:
        raise AdmissionError("subdomainPolicy must not be null")

    if old is not None:
        if to_plain(old.spec.leader_worker_template.sub_group_policy) != to_plain(sgp):
            raise AdmissionError("subGroupPolicy is immutable")


def register_lws_webhooks(store: Store) -> None:
    store.register_mutator("LeaderWorkerSet", default_lws)
    store.register_validator("LeaderWorkerSet", validate_lws)
