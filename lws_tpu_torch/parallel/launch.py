"""Start a group's members as processes on one host, each with the env
contract the control plane would give it.

`group_env` is that contract for member `rank` of a local group (the
leader on 127.0.0.1, the coordinator at a free port); `spawn_group` starts
members with torch.multiprocessing (spawn), sets each one's contract in its
environment and calls `fn(rank, *args)`, which bootstraps from it like any
worker (initialize_from_env). The caller may run some ranks itself (rank 0
beside its own children, say) and joins the rest with `join`.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, Optional, Sequence

from lws_tpu_torch.parallel import contract


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group_env(rank: int, world: int, port: int, host: str = "127.0.0.1") -> dict[str, str]:
    """The bootstrap env of member `rank` of a `world`-member group whose
    leader is `host` and whose coordinator listens at `port`."""
    return {
        contract.LWS_LEADER_ADDRESS: host,
        contract.LWS_GROUP_SIZE: str(world),
        contract.LWS_WORKER_INDEX: str(rank),
        contract.JAX_COORDINATOR_ADDRESS: f"{host}:{port}",
        contract.JAX_NUM_PROCESSES: str(world),
        contract.JAX_PROCESS_ID: str(rank),
    }


def _member(i: int, fn: Callable, envs: list, args: tuple) -> None:
    env = envs[i]
    os.environ.update(env)
    fn(int(env[contract.JAX_PROCESS_ID]), *args)


def spawn_group(fn: Callable, world: int, args: tuple = (), ranks: Optional[Sequence[int]] = None,
                port: Optional[int] = None):
    """Start the members `ranks` (default all of 0..world-1) of a
    `world`-member group, each calling fn(rank, *args) with its contract in
    os.environ. `fn` must be importable by name (spawn). Returns (the
    torch.multiprocessing context, the contract env of every rank); a rank
    the caller runs itself takes its env from the second."""
    import torch.multiprocessing as mp

    port = free_port() if port is None else port
    envs = [group_env(r, world, port) for r in range(world)]
    ranks = list(range(world)) if ranks is None else list(ranks)
    ctx = mp.start_processes(_member, args=(fn, [envs[r] for r in ranks], args),
                             nprocs=len(ranks), join=False, start_method="spawn")
    return ctx, envs


def join(ctx, timeout_s: float = 600.0) -> None:
    """Wait for every member started by spawn_group; raises when one fails
    (with its traceback) or when `timeout_s` passes (the members are then
    killed)."""
    import time

    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"spawn_group: members still running after {timeout_s} s")
