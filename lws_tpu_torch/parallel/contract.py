"""The env names of the group contract that the port's bootstrap reads,
taken from the one source, `lws_tpu_torch/api/contract.py` (the control
plane's contract), and pinned to the JAX package's values by
tests/test_torch_parallel.py.

The control plane injects the generic LWS_* contract into every member of a
group, and the JAX_* names derived from it (coordinator = the leader's
address at JAX_COORDINATOR_PORT_DEFAULT); the port reads the same names, so
one pod template starts either package's workers.
"""

from lws_tpu_torch.api.contract import (  # noqa: F401
    JAX_COORDINATOR_ADDRESS,
    JAX_COORDINATOR_PORT_DEFAULT,
    JAX_NUM_PROCESSES,
    JAX_PROCESS_ID,
    LWS_GROUP_SIZE,
    LWS_LEADER_ADDRESS,
    LWS_SUBGROUP_INDEX,
    LWS_SUBGROUP_SIZE,
    LWS_WORKER_INDEX,
)
