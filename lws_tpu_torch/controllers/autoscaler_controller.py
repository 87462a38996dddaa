"""Autoscaler controller: the HPA loop over the LWS scale subresource.

desired = ceil(current * avgMetric / target), clamped to [min, max]; scale-up
is immediate, scale-down waits for `scale_down_stabilization` consecutive
below-target observations (flap damping). Metrics arrive as annotations on
ready leader pods — exactly the pods status.hpa_pod_selector selects.

The port's copy of lws_tpu/controllers/autoscaler_controller.py.
"""

from __future__ import annotations

import math

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.autoscaler import METRIC_ANNOTATION_PREFIX, Autoscaler
from lws_tpu_torch.api.types import LeaderWorkerSet
from lws_tpu_torch.core.events import EventRecorder
from lws_tpu_torch.core.manager import Result
from lws_tpu_torch.core.store import Key, Store
from lws_tpu_torch.utils.podutils import pod_running_and_ready


class AutoscalerReconciler:
    name = "autoscaler"

    def __init__(self, store: Store, recorder: EventRecorder) -> None:
        self.store = store
        self.recorder = recorder

    def reconcile(self, key: Key) -> Result | None:
        asc = self.store.try_get("Autoscaler", key[1], key[2])
        if asc is None or not isinstance(asc, Autoscaler):
            return None
        lws = self.store.try_get("LeaderWorkerSet", asc.meta.namespace, asc.spec.target)
        if lws is None or not isinstance(lws, LeaderWorkerSet):
            return None

        leaders = [
            p
            for p in self.store.list(
                "Pod",
                asc.meta.namespace,
                labels={
                    contract.SET_NAME_LABEL_KEY: lws.meta.name,
                    contract.WORKER_INDEX_LABEL_KEY: "0",
                },
            )
            if pod_running_and_ready(p)
        ]
        if not leaders:
            return None
        annotation = METRIC_ANNOTATION_PREFIX + asc.spec.metric
        reported: list[float] = []
        missing = 0
        fingerprint_parts = []
        for p in leaders:
            raw = p.meta.annotations.get(annotation)
            fingerprint_parts.append((p.meta.name, raw, p.meta.resource_version))
            try:
                reported.append(float(raw))  # type: ignore[arg-type]
            except (TypeError, ValueError):
                missing += 1
        if not reported or asc.spec.target_value <= 0:
            return None
        n = len(reported) + missing
        avg = sum(reported) / len(reported)

        # One control-loop step per *fresh* observation: our own status writes
        # retrigger reconcile and must not burn the stabilization window, but
        # a re-report of the SAME value (steady load) is new data — so the
        # dedup key is the (pod, value, resourceVersion) set, not the average.
        from lws_tpu_torch.utils.common import stable_hash

        observation = stable_hash(sorted(map(list, fingerprint_parts)))
        if observation == asc.status.last_observation:
            return None
        asc.status.last_observation = observation

        current = lws.spec.replicas
        target = asc.spec.target_value
        # HPA convention, two safeguards against compounding through freshly
        # started leaders: (a) the scale direction must survive a conservative
        # assumption about unreported pods (missing = 0 for scale-up, = target
        # for scale-down); (b) the ratio scales the OBSERVED leader count n,
        # not spec.replicas — pods still materializing carry no signal.
        if avg > target:
            adj = sum(reported) / n
            desired = math.ceil(n * adj / target) if adj > target else current
            desired = max(desired, current)
        elif avg < target and n == current:
            # Scale down only with full leader coverage: a half-started fleet
            # must not shrink the spec it hasn't caught up to yet.
            adj = (sum(reported) + missing * target) / n
            desired = math.ceil(n * adj / target) if adj < target else current
            desired = min(desired, current)
        else:
            desired = current
        desired = max(asc.spec.min_replicas, min(asc.spec.max_replicas, desired))

        asc.status.last_metric_value = avg
        if desired > current:
            asc.status.below_target_observations = 0
            self._scale(lws, desired, asc)
        elif desired < current:
            asc.status.below_target_observations += 1
            if asc.status.below_target_observations >= asc.spec.scale_down_stabilization:
                asc.status.below_target_observations = 0
                self._scale(lws, desired, asc)
        else:
            asc.status.below_target_observations = 0
        asc.status.desired_replicas = desired
        self.store.update_status(asc)
        return None

    def _scale(self, lws: LeaderWorkerSet, replicas: int, asc: Autoscaler) -> None:
        fresh = self.store.get("LeaderWorkerSet", lws.meta.namespace, lws.meta.name)
        if fresh.spec.replicas == replicas:
            return
        old = fresh.spec.replicas
        fresh.spec.replicas = replicas
        self.store.update(fresh)
        self.recorder.event(
            asc, "Normal", "Scaled", f"scaled {lws.meta.name} from {old} to {replicas} replicas"
        )
        # Provenance feed: the move lands in the flight-recorder ring (and
        # through it the rollout timeline), so a replica change is always
        # attributable — `lws-tpu why` joins it to the decision that fed
        # this autoscaler its annotations.
        from lws_tpu_torch.core import flightrecorder

        flightrecorder.record(
            "autoscaler_scaled", autoscaler=asc.meta.name,
            lws=f"{lws.meta.namespace}/{lws.meta.name}",
            from_replicas=old, to_replicas=replicas,
        )
