"""Pod helpers + generic bootstrap env injection (≈ pkg/utils/pod/pod_utils.go).

`add_lws_variables` writes the generic group contract into every container:
LWS_LEADER_ADDRESS (always first — later vars may interpolate it), LWS_GROUP_SIZE,
LWS_WORKER_INDEX — plus the JAX-native coordinator triple so workloads can call
`jax.distributed.initialize()` with zero glue (this framework's addition; the
reference leaves that to the workload, ref docs/examples/vllm/TPU/lws.yaml:30-34).

The port's copy of lws_tpu/utils/podutils.py.
"""

from __future__ import annotations

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.pod import Container, EnvVar, Pod


def is_leader_pod(pod: Pod) -> bool:
    """≈ pod_utils.go:53 LeaderPod (worker-index label == "0")."""
    return pod.meta.labels.get(contract.WORKER_INDEX_LABEL_KEY) == "0"


def container_restarted(pod: Pod) -> bool:
    """≈ pod_utils.go:29-45 ContainerRestarted."""
    return pod.status.container_restarts > 0


def pod_running_and_ready(pod: Pod) -> bool:
    """≈ pod_utils.go:58 PodRunningAndReady."""
    from lws_tpu_torch.api.pod import PodPhase

    return pod.status.phase == PodPhase.RUNNING and pod.status.ready


def add_env_vars_if_not_exists(c: Container, first: EnvVar, *rest: EnvVar) -> None:
    """Prepend [first, *rest] to the container env; existing vars with the
    same names are dropped so the injected value wins and sits first
    (≈ pod_utils.go:108-129 addEnvVarsIfNotExists)."""
    injected = [first, *rest]
    names = {e.name for e in injected}
    c.env = injected + [e for e in c.env if e.name not in names]


def leader_pod_name(lws_name: str, group_index: int | str) -> str:
    return f"{lws_name}-{group_index}"


def worker_pod_name(lws_name: str, group_index: int | str, worker_index: int | str) -> str:
    return f"{lws_name}-{group_index}-{worker_index}"


def add_lws_variables(pod: Pod) -> None:
    """≈ pod_utils.go:131-179 AddLWSVariables + JAX coordinator extension."""
    labels, annotations = pod.meta.labels, pod.meta.annotations
    lws_name = labels.get(contract.SET_NAME_LABEL_KEY)
    group_index = labels.get(contract.GROUP_INDEX_LABEL_KEY)
    worker_index = labels.get(contract.WORKER_INDEX_LABEL_KEY)
    size = annotations.get(contract.SIZE_ANNOTATION_KEY)
    if lws_name is None:
        raise ValueError(f"pod {pod.meta.name}: no set-name label")
    if group_index is None:
        raise ValueError(f"pod {pod.meta.name}: no group-index label")
    if worker_index is None:
        raise ValueError(f"pod {pod.meta.name}: no worker-index label")
    if size is None:
        raise ValueError(f"pod {pod.meta.name}: no size annotation")

    leader_address = (
        f"{lws_name}-{group_index}.{pod.spec.subdomain}.{pod.meta.namespace}"
    )
    leader_env = EnvVar(contract.LWS_LEADER_ADDRESS, leader_address)
    rest = [
        EnvVar(contract.LWS_GROUP_SIZE, size),
        EnvVar(contract.LWS_WORKER_INDEX, worker_index),
        # JAX-native bootstrap: coordinator on the leader, well-known port.
        EnvVar(
            contract.JAX_COORDINATOR_ADDRESS,
            f"{leader_address}:{contract.JAX_COORDINATOR_PORT_DEFAULT}",
        ),
        EnvVar(contract.JAX_NUM_PROCESSES, size),
        EnvVar(contract.JAX_PROCESS_ID, worker_index),
    ]
    sub_size = annotations.get(contract.SUBGROUP_SIZE_ANNOTATION_KEY)
    sub_index = labels.get(contract.SUBGROUP_INDEX_LABEL_KEY)
    if sub_size is not None and sub_index is not None:
        rest.append(EnvVar(contract.LWS_SUBGROUP_SIZE, sub_size))
        rest.append(EnvVar(contract.LWS_SUBGROUP_INDEX, sub_index))

    # Serving revision for worker-side telemetry: DS revision first, then the
    # template-revision hash — the same precedence the fleet scraper applies
    # to pod labels (runtime/fleet.py), so worker-local and fleet-injected
    # `revision` label values always agree.
    from lws_tpu_torch.api import disagg

    revision = (labels.get(disagg.DS_REVISION_LABEL_KEY)
                or labels.get(contract.REVISION_LABEL_KEY))
    if revision:
        rest.append(EnvVar(contract.LWS_TPU_REVISION, revision))

    for c in pod.spec.containers:
        add_env_vars_if_not_exists(c, leader_env, *rest)
    for c in pod.spec.init_containers:
        add_env_vars_if_not_exists(c, leader_env, *rest)
