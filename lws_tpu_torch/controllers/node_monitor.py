"""Node failure detection: the TPU-preemption analog of pod-level failure.

When a node goes NotReady (slice preempted/maintenance), every pod bound to
it is marked Failed — which trips the group's all-or-nothing restart policy
(SURVEY §3.5) so the whole group reschedules onto healthy capacity. The
reference relies on the kubelet/node-lifecycle controller for this; here it
is first-class.

The port's copy of lws_tpu/controllers/node_monitor.py.
"""

from __future__ import annotations

from lws_tpu_torch.api.node import Node
from lws_tpu_torch.api.pod import PodPhase
from lws_tpu_torch.core.events import EventRecorder
from lws_tpu_torch.core.manager import Result
from lws_tpu_torch.core.store import Key, Store


def evict_pods_on_node(store: Store, node_name: str, message: str, recorder=None, reason: str = "Evicted") -> list[str]:
    """Fail every running pod bound to `node_name` (shared by the node
    monitor and the drain endpoint). Conflict-retries per pod; pods deleted
    underneath (sibling eviction via restart policy) are skipped; completed
    pods are left alone. Pods still contended after all retries raise
    ValueError (drain returns 422: re-issue the idempotent drain) rather than
    silently surviving the drain."""
    from lws_tpu_torch.core.store import ConflictError, NotFoundError

    evicted: list[str] = []
    contended: list[str] = []
    # Node binding index, not a fleet scan: this runs per NotReady node on
    # the reconcile path, and only the node's own pods matter.
    for pod in store.bound_to_node(node_name):
        if pod.status.phase in (
            PodPhase.FAILED, PodPhase.SUCCEEDED,  # kubectl drain ignores completed pods
        ):
            continue
        for _ in range(5):
            try:
                fresh = store.get("Pod", pod.meta.namespace, pod.meta.name)
            except NotFoundError:
                break  # already deleted (e.g. group teardown beat us)
            if fresh.status.phase in (PodPhase.FAILED, PodPhase.SUCCEEDED):
                break
            fresh.status.phase = PodPhase.FAILED
            fresh.status.ready = False
            fresh.status.message = message
            try:
                store.update_status(fresh)
                evicted.append(fresh.meta.name)
                if recorder is not None:
                    recorder.event(fresh, "Warning", reason, message)
                break
            except ConflictError:
                continue
        else:
            contended.append(pod.meta.name)
    if contended:
        raise ValueError(
            f"could not evict {', '.join(sorted(contended))} from {node_name} "
            "(persistent write contention); retry the drain"
        )
    return evicted


class NodeMonitor:
    name = "node-monitor"

    def __init__(self, store: Store, recorder: EventRecorder) -> None:
        self.store = store
        self.recorder = recorder

    def reconcile(self, key: Key) -> Result | None:
        node = self.store.try_get("Node", key[1], key[2])
        if node is None or not isinstance(node, Node):
            return None
        if node.status.ready:
            return None
        try:
            evict_pods_on_node(
                self.store, node.meta.name, f"node {node.meta.name} not ready",
                recorder=self.recorder, reason="NodeFailure",
            )
        except ValueError:
            return Result(requeue=True)  # contended pods: try again
        return None
