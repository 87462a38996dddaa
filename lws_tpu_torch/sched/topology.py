"""TPU fleet topology model: build Node objects for multi-host slices.

A vXe/vXp slice of H hosts shows up as H Nodes sharing one
NODE_TPU_SLICE_LABEL value, each with chips_per_host chips
(e.g. v5e 4x4 = 4 hosts x 4 chips; v5p-16 = 2 hosts x 4 chips).

The port's copy of lws_tpu/sched/topology.py.
"""

from __future__ import annotations

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.node import CLUSTER_NAMESPACE, Node, NodeSpec
from lws_tpu_torch.core.store import new_meta


def slice_host_count(topology: str, chips_per_host: int = 4) -> int:
    """'4x4' -> 16 chips -> 4 hosts; '2x2x4' (v5p) -> 16 chips -> 4 hosts."""
    chips = 1
    for part in topology.lower().split("x"):
        chips *= int(part)
    return max(1, chips // chips_per_host)


def make_slice_nodes(
    slice_name: str,
    topology: str = "4x4",
    chips_per_host: int = 4,
    accelerator: str = "v5e",
    namespace: str = CLUSTER_NAMESPACE,
) -> list[Node]:
    hosts = slice_host_count(topology, chips_per_host)
    nodes = []
    for h in range(hosts):
        nodes.append(
            Node(
                meta=new_meta(
                    f"{slice_name}-host-{h}",
                    namespace,
                    labels={
                        contract.NODE_TPU_SLICE_LABEL: slice_name,
                        contract.NODE_TPU_TOPOLOGY_LABEL: topology,
                        contract.NODE_TPU_ACCELERATOR_LABEL: accelerator,
                    },
                ),
                spec=NodeSpec(capacity={contract.TPU_RESOURCE_NAME: chips_per_host, "pods": 8}),
            )
        )
    return nodes
