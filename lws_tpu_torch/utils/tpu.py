"""TPU bootstrap env synthesis (behavioral parity with
pkg/utils/accelerators/tpu.go).

Writes the libtpu multi-host contract into TPU-requesting containers:
  TPU_WORKER_HOSTNAMES   all hosts of the (sub)group, rank order == ICI order
  TPU_WORKER_ID          this host's rank within the (sub)group
  TPU_NAME               the group's leader pod name (slice identity)
  TPU_PROCESS_ADDRESSES  host:port list, TPU_PROCESS_PORT default 8476

Rank ordering rules (the hard part, ref tpu.go:99-299):
  * whole-group: leader gets id 0 iff it requests TPUs; otherwise workers are
    shifted down by one (leader is not a TPU worker).
  * multiple TPU containers per pod interleave ids: pod j's container i gets
    id j*numContainers+i, ports default+i.
  * subgroup: each subgroup [sgs*idx+1, sgs*(idx+1)] gets its own hostname
    window; windows shift left by one when the leader (which then joins
    subgroup 0) itself holds TPUs.

The port's copy of lws_tpu/utils/tpu.py.
"""

from __future__ import annotations

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.groupset import parent_name_and_ordinal
from lws_tpu_torch.api.pod import Container, EnvVar, Pod


def pod_requests_tpus(pod: Pod) -> bool:
    return pod.spec.requests_tpus()


def _tpu_containers(pod: Pod) -> list[Container]:
    return [c for c in pod.spec.containers if c.tpu_chips() > 0] + [
        c for c in pod.spec.init_containers if c.tpu_chips() > 0
    ]


def add_tpu_annotations(leader_pod: Pod, annotations: dict[str, str]) -> None:
    """≈ tpu.go:302-306 — propagate leader-requests-tpus to worker metadata."""
    if pod_requests_tpus(leader_pod):
        annotations[contract.LEADER_REQUESTS_TPUS_ANNOTATION_KEY] = "true"


def add_tpu_variables(pod: Pod, size: int) -> None:
    """Entry point (≈ tpu.go:201 AddTPUVariables)."""
    if contract.SUBGROUP_SIZE_ANNOTATION_KEY in pod.meta.annotations:
        _add_tpu_variables_subgroup(pod)
        return

    containers = _tpu_containers(pod)
    if not containers:
        return
    for name in (contract.TPU_WORKER_HOSTNAMES, contract.TPU_WORKER_ID):
        if containers[0].env_value(name)[0]:
            return  # already injected

    is_leader = pod.meta.labels.get(contract.WORKER_INDEX_LABEL_KEY) == "0"
    leader_requests = (
        pod.meta.annotations.get(contract.LEADER_REQUESTS_TPUS_ANNOTATION_KEY) == "true"
    )
    if is_leader:
        leader_pod_name = pod.meta.name
        pod_worker_index = 0
    else:
        leader_pod_name, ordinal = parent_name_and_ordinal(pod.meta.name)
        if leader_pod_name is None:
            raise ValueError(f"parsing parent name from pod {pod.meta.name}")
        # Leader without TPUs is not a TPU worker: shift worker ids down.
        pod_worker_index = ordinal if leader_requests else ordinal - 1

    n = len(containers)
    ports: list[str] = []
    for i, c in enumerate(containers):
        found, val = c.env_value(contract.TPU_PROCESS_PORT)
        ports.append(val if found else str(contract.TPU_PROCESS_DEFAULT_PORT + i))

    subdomain = pod.spec.subdomain
    hostnames: list[str] = []
    addresses: list[str] = []
    if leader_requests or is_leader:
        leader_host = f"{leader_pod_name}.{subdomain}"
        for i in range(n):
            hostnames.append(leader_host)
            addresses.append(f"{leader_host}:{ports[i]}")
    for i in range(1, size):
        host = f"{leader_pod_name}-{i}.{subdomain}"
        for j in range(n):
            hostnames.append(host)
            addresses.append(f"{host}:{ports[j]}")

    for i, c in enumerate(containers):
        worker_id = pod_worker_index * n + i
        had_port = c.env_value(contract.TPU_PROCESS_PORT)[0]
        c.env.extend(
            [
                EnvVar(contract.TPU_WORKER_HOSTNAMES, ",".join(hostnames)),
                EnvVar(contract.TPU_WORKER_ID, str(worker_id)),
                EnvVar(contract.TPU_NAME, leader_pod_name),
                EnvVar(contract.TPU_PROCESS_ADDRESSES, ",".join(addresses)),
            ]
        )
        if not had_port:
            c.env.append(EnvVar(contract.TPU_PROCESS_PORT, ports[i]))


def _add_tpu_variables_subgroup(pod: Pod) -> None:
    """≈ tpu.go:99-198 addTPUVariablesSubGroup.

    Deviation from the reference (deliberate): a leader pod that itself
    requests TPUs gets TPU_WORKER_ID=0 even when the leader-requests-tpus
    annotation wasn't propagated onto it — the reference computes
    (0-1)%sgs = -1 there (tpu.go:126-129), which misassembles the ICI ring.
    """
    containers = _tpu_containers(pod)
    if not containers:
        return
    container = containers[0]
    for name in (contract.TPU_WORKER_HOSTNAMES, contract.TPU_WORKER_ID):
        if container.env_value(name)[0]:
            return

    annotations, labels = pod.meta.annotations, pod.meta.labels
    if contract.SUBGROUP_INDEX_LABEL_KEY not in labels:
        # A TPU-holding pod outside any subgroup (e.g. a LeaderExcluded leader,
        # which admission normally rejects) gets no subgroup TPU env.
        return
    sgs = int(annotations[contract.SUBGROUP_SIZE_ANNOTATION_KEY])
    sub_index = int(labels[contract.SUBGROUP_INDEX_LABEL_KEY])
    worker_index = int(labels[contract.WORKER_INDEX_LABEL_KEY])
    is_leader = labels.get(contract.WORKER_INDEX_LABEL_KEY) == "0"
    leader_requests = (
        annotations.get(contract.LEADER_REQUESTS_TPUS_ANNOTATION_KEY) == "true"
        or is_leader  # the leader reaching this path holds TPUs itself
    )

    tpu_worker_id = worker_index % sgs if leader_requests else (worker_index - 1) % sgs

    found_port, port = container.env_value(contract.TPU_PROCESS_PORT)
    if not found_port:
        port = str(contract.TPU_PROCESS_DEFAULT_PORT)

    start = sgs * sub_index + 1
    end = sgs * (sub_index + 1)
    subdomain = pod.spec.subdomain
    hostnames: list[str] = []
    addresses: list[str] = []

    if is_leader:
        leader_name = pod.meta.name
        hostnames.append(f"{leader_name}.{subdomain}")
        addresses.append(f"{leader_name}.{subdomain}:{port}")
        end -= 1
    else:
        leader_name, _ = parent_name_and_ordinal(pod.meta.name)
        if leader_name is None:
            raise ValueError(f"parsing parent name from pod {pod.meta.name}")
        if annotations.get(contract.LEADER_REQUESTS_TPUS_ANNOTATION_KEY) == "true" and sub_index == 0:
            # Leader holds TPUs and lives in subgroup 0: include it and shift
            # the window left by one.
            end -= 1
            hostnames.append(f"{leader_name}.{subdomain}")
            addresses.append(f"{leader_name}.{subdomain}:{port}")
        elif annotations.get(contract.LEADER_REQUESTS_TPUS_ANNOTATION_KEY) == "true":
            # Subsequent subgroups shift too.
            start -= 1
            end -= 1

    for i in range(start, end + 1):
        hostnames.append(f"{leader_name}-{i}.{subdomain}")
        addresses.append(f"{leader_name}-{i}.{subdomain}:{port}")

    container.env.extend(
        [
            EnvVar(contract.TPU_WORKER_HOSTNAMES, ",".join(hostnames)),
            EnvVar(contract.TPU_WORKER_ID, str(tpu_worker_id)),
            EnvVar(contract.TPU_NAME, leader_name),
            EnvVar(contract.TPU_PROCESS_ADDRESSES, ",".join(addresses)),
        ]
    )
    if not found_port:
        container.env.append(EnvVar(contract.TPU_PROCESS_PORT, port))


def get_subgroup_index(pod_count: int, subgroup_size: int, worker_index: int) -> int:
    """Worker's subgroup (≈ pod_webhook.go:249-255 getSubGroupIndex): when
    (size-1) divides evenly the leader is the 'extra pod' folded into subgroup
    0, so workers shift down by one."""
    if (pod_count - 1) % subgroup_size == 0:
        return (worker_index - 1) // subgroup_size
    return worker_index // subgroup_size
