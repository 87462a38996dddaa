"""Autoscaler: native HPA equivalent driving the LWS scale subresource.

The reference exposes a scale subresource + hpaPodSelector and delegates the
loop to Kubernetes HPA (ref leaderworkerset_types.go:111-122,416); here the
loop is first-class. Workloads report load by annotating their leader pod
(METRIC_ANNOTATION_PREFIX + metric name); the controller averages over leader
pods — the same "leader aggregates group metrics" model the reference docs
describe.

The port's copy of lws_tpu/api/autoscaler.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject

METRIC_ANNOTATION_PREFIX = "metrics.lws.tpu/"


@dataclass
class AutoscalerSpec:
    target: str = ""  # LeaderWorkerSet name in the same namespace
    min_replicas: int = 1
    max_replicas: int = 10
    metric: str = "inflight"
    # Desired average metric value per group.
    target_value: float = 1.0
    # Consecutive observations below target required before scaling down.
    scale_down_stabilization: int = 3


@dataclass
class AutoscalerStatus:
    desired_replicas: int = 0
    last_metric_value: float = 0.0
    below_target_observations: int = 0
    # Fingerprint of the last processed (pod, value, resourceVersion) set —
    # one control-loop step per fresh observation, even at steady values.
    last_observation: str = ""


@dataclass
class Autoscaler(TypedObject):
    kind = "Autoscaler"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: AutoscalerSpec = field(default_factory=AutoscalerSpec)
    status: AutoscalerStatus = field(default_factory=AutoscalerStatus)
