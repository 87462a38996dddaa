"""Process-group bootstrap from the injected env contract: the port of
lws_tpu/parallel/bootstrap.py.

The control plane publishes (coordinator, world size, rank) to every member
of a group as JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID,
over the generic LWS_LEADER_ADDRESS / LWS_GROUP_SIZE / LWS_WORKER_INDEX
contract. `bootstrap_info_from_env` reads them exactly as the JAX package
does; `initialize_from_env` starts torch.distributed from them: the
coordinator is the TCP store (rank 0 listens there), `num_processes` the
world size, `process_id` the rank. Every rank is one process that owns one
device: NCCL when that device is a GPU, gloo when it is the CPU. There is
no gloo-on-CUDA substitute, and a failed init raises.

The JAX package's `assert_platform_from_env` (pinning JAX_PLATFORMS inside
a worker) has no counterpart: the port's `device` argument takes its place.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch

from lws_tpu_torch._device import DeviceLike, resolve_device
from lws_tpu_torch.parallel import contract


@dataclass(frozen=True)
class BootstrapInfo:
    coordinator_address: str
    num_processes: int
    process_id: int
    subgroup_size: Optional[int] = None
    subgroup_index: Optional[int] = None

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def bootstrap_info_from_env(env: Optional[dict[str, str]] = None) -> BootstrapInfo:
    e = os.environ if env is None else env
    coordinator = e.get(contract.JAX_COORDINATOR_ADDRESS)
    if coordinator is None:
        leader = e.get(contract.LWS_LEADER_ADDRESS)
        coordinator = (
            f"{leader}:{contract.JAX_COORDINATOR_PORT_DEFAULT}" if leader else "localhost:0"
        )
    num = int(e.get(contract.JAX_NUM_PROCESSES, e.get(contract.LWS_GROUP_SIZE, "1")))
    pid = int(e.get(contract.JAX_PROCESS_ID, e.get(contract.LWS_WORKER_INDEX, "0")))
    sub_size = e.get(contract.LWS_SUBGROUP_SIZE)
    sub_index = e.get(contract.LWS_SUBGROUP_INDEX)
    return BootstrapInfo(
        coordinator_address=coordinator,
        num_processes=num,
        process_id=pid,
        subgroup_size=int(sub_size) if sub_size is not None else None,
        subgroup_index=int(sub_index) if sub_index is not None else None,
    )


def local_device(info: BootstrapInfo, device: DeviceLike = None) -> torch.device:
    """The device this rank owns: `device` as given, or the GPU
    `cuda:<process_id mod visible cards>` (a group whose members share a
    host takes one card each). Raises without a GPU unless the caller asks
    for the CPU."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")  # raises without a GPU
    return torch.device("cuda", info.process_id % torch.cuda.device_count())


def initialize_from_env(env: Optional[dict[str, str]] = None, device: DeviceLike = None,
                        group_of_one: bool = False, timeout_s: float = 300.0) -> BootstrapInfo:
    """Start torch.distributed from the env contract. A no-op for a single
    process, unless `group_of_one`: then a one-rank group starts too, so a
    mesh over one process still runs its collectives. On a GPU the rank's
    card (local_device) becomes the current device before anything is
    allocated, and the group runs NCCL; on the CPU it runs gloo."""
    info = bootstrap_info_from_env(env)
    if not (info.is_distributed or group_of_one):
        return info
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("initialize_from_env: torch.distributed is already initialized")
    dev = local_device(info, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize_from_env: a rank owns a GPU or the CPU, not {dev}")
    timeout = datetime.timedelta(seconds=timeout_s)
    # NCCL binds the rank's card (device_id) instead of guessing it from the rank.
    bind = {"device_id": dev} if backend == "nccl" else {}
    if info.num_processes == 1:
        # No peer to meet: an in-process store (a one-rank group needs no port).
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                timeout=timeout, **bind)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{info.coordinator_address}",
                                world_size=info.num_processes, rank=info.process_id,
                                timeout=timeout, **bind)
    return info
