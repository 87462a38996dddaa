"""The env names of the group contract that the port's bootstrap reads: the
port's own copy of the bootstrap constants of lws_tpu/api/contract.py
(:58-60 and :80-86), pinned to the JAX package's values by
tests/test_torch_parallel.py.

The control plane injects the generic LWS_* contract into every member of a
group, and the JAX_* names derived from it (coordinator = the leader's
address at JAX_COORDINATOR_PORT_DEFAULT); the port reads the same names, so
one pod template starts either package's workers.
"""

# Generic bootstrap env.
LWS_LEADER_ADDRESS = "LWS_LEADER_ADDRESS"
LWS_GROUP_SIZE = "LWS_GROUP_SIZE"
LWS_WORKER_INDEX = "LWS_WORKER_INDEX"

# Coordinator, world size and rank, as the control plane names them.
JAX_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
JAX_COORDINATOR_PORT_DEFAULT = 8471
JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
JAX_PROCESS_ID = "JAX_PROCESS_ID"

# Subgroup topology hints (subgroup i = pipeline stage i).
LWS_SUBGROUP_SIZE = "LWS_SUBGROUP_SIZE"
LWS_SUBGROUP_INDEX = "LWS_SUBGROUP_INDEX"
