"""Node: one TPU host (a machine attached to part of a slice).

The scheduler (lws_tpu_torch.sched) binds pods to nodes honoring nodeSelector,
affinity topology domains, chip capacity, and gang constraints. Topology
labels model GKE's `cloud.google.com/gke-tpu-topology` world: all hosts of one
ICI-connected slice share NODE_TPU_SLICE_LABEL.

The port's copy of lws_tpu/api/node.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject

# Nodes are cluster-scoped hardware: they live under this canonical
# pseudo-namespace in the Store so lookups stay O(1) by name.
CLUSTER_NAMESPACE = "_cluster"


@dataclass
class NodeStatus:
    ready: bool = True


@dataclass
class NodeSpec:
    # resource name -> capacity, e.g. {"google.com/tpu": 4, "cpu": 8}
    capacity: dict[str, int] = field(default_factory=dict)
    unschedulable: bool = False


@dataclass
class Node(TypedObject):
    kind = "Node"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)
