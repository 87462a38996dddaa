"""The wire contract: label/annotation keys + bootstrap env variables.

This is the protocol between controllers <-> admission <-> workers. Semantics
mirror the reference contract (ref: api/leaderworkerset/v1/leaderworkerset_types.go:26-99,
pkg/utils/accelerators/tpu.go:33-41) with a framework-native label domain.

The *environment variable* names are kept byte-identical to the reference
(`LWS_*`, `TPU_*`) because they are the external contract that libtpu / JAX /
vLLM-TPU workloads already consume; additionally this framework publishes
JAX-native coordinator variables so `jax.distributed.initialize()` works with
zero workload glue.

The port's copy of lws_tpu/api/contract.py.
"""

DOMAIN = "leaderworkerset.lws.tpu"

# ---- labels ----------------------------------------------------------------
# LWS name on every owned resource (pods/services/groupsets).
SET_NAME_LABEL_KEY = f"{DOMAIN}/name"
# Which group (replica) a pod/groupset belongs to.
GROUP_INDEX_LABEL_KEY = f"{DOMAIN}/group-index"
# Identity of the pod within its group: "0" == leader.
WORKER_INDEX_LABEL_KEY = f"{DOMAIN}/worker-index"
# sha1 unique key shared by every pod of one group (exclusive placement).
GROUP_UNIQUE_HASH_LABEL_KEY = f"{DOMAIN}/group-key"
# Template revision the resource was built from.
REVISION_LABEL_KEY = f"{DOMAIN}/template-revision-hash"
# Subgroup identity (only when subGroupPolicy set).
SUBGROUP_INDEX_LABEL_KEY = f"{DOMAIN}/subgroup-index"
SUBGROUP_UNIQUE_HASH_LABEL_KEY = f"{DOMAIN}/subgroup-key"

# ---- annotations -----------------------------------------------------------
# 1:1 exclusive scheduling topology (whole group shares one slice).
EXCLUSIVE_KEY_ANNOTATION_KEY = f"{DOMAIN}/exclusive-topology"
# 1:1 exclusive scheduling topology per subgroup (sub-slice).
SUBGROUP_EXCLUSIVE_KEY_ANNOTATION_KEY = f"{DOMAIN}/subgroup-exclusive-topology"
# Group size (== spec.leaderWorkerTemplate.size) on pods/groupsets.
SIZE_ANNOTATION_KEY = f"{DOMAIN}/size"
# LWS replicas on the leader groupset.
REPLICAS_ANNOTATION_KEY = f"{DOMAIN}/replicas"
# Leader pod name on worker pods.
LEADER_POD_NAME_ANNOTATION_KEY = f"{DOMAIN}/leader-name"
# Subgroup config propagated to pods.
SUBGROUP_SIZE_ANNOTATION_KEY = f"{DOMAIN}/subgroup-size"
SUBGROUP_POLICY_TYPE_ANNOTATION_KEY = f"{DOMAIN}/subgroup-policy-type"
# Subdomain policy on leader pods.
SUBDOMAIN_POLICY_ANNOTATION_KEY = f"{DOMAIN}/subdomainPolicy"
# Set when the leader pod itself requests TPU chips (shifts worker ids).
LEADER_REQUESTS_TPUS_ANNOTATION_KEY = f"{DOMAIN}/leader-requests-tpus"
# Opt-in: restart group on failure only after all pods left Pending.
RECREATE_GROUP_AFTER_START_ANNOTATION_KEY = f"{DOMAIN}/experimental-recreate-group-after-start"
# Fail-fast restart budget (reference KEP-820, implemented here first-class):
# max group recreations before the LWS goes terminally Failed.
MAX_GROUP_RESTARTS_ANNOTATION_KEY = f"{DOMAIN}/max-group-restarts"
# Rolling count of group recreations, kept on the leader pod's groupset.
GROUP_RESTARTS_ANNOTATION_KEY = f"{DOMAIN}/group-restarts"

# ---- generic bootstrap env (byte-identical to reference) -------------------
LWS_LEADER_ADDRESS = "LWS_LEADER_ADDRESS"
LWS_GROUP_SIZE = "LWS_GROUP_SIZE"
LWS_WORKER_INDEX = "LWS_WORKER_INDEX"

# ---- serving observability env (new in this framework) ---------------------
# The template-revision hash the pod was built from, injected so worker-side
# SLO series and journey records carry the serving revision end-to-end
# (core/slo.py reads it; obs/rollout.py folds fleet series by it).
LWS_TPU_REVISION = "LWS_TPU_REVISION"

# ---- TPU bootstrap env (byte-identical to reference; consumed by libtpu) ---
TPU_RESOURCE_NAME = "google.com/tpu"
TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
TPU_PROCESS_ADDRESSES = "TPU_PROCESS_ADDRESSES"
TPU_PROCESS_PORT = "TPU_PROCESS_PORT"
TPU_PROCESS_DEFAULT_PORT = 8476
TPU_WORKER_ID = "TPU_WORKER_ID"
TPU_NAME = "TPU_NAME"

# ---- JAX-native bootstrap env (new in this framework) ----------------------
# jax.distributed.initialize(coordinator_address=..., num_processes=...,
# process_id=...) reads these via lws_tpu_torch.parallel.bootstrap.
JAX_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
JAX_COORDINATOR_PORT_DEFAULT = 8471
JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
JAX_PROCESS_ID = "JAX_PROCESS_ID"
# Subgroup topology hints for sub-slice mesh axes (TPxPP).
LWS_SUBGROUP_SIZE = "LWS_SUBGROUP_SIZE"
LWS_SUBGROUP_INDEX = "LWS_SUBGROUP_INDEX"

# ---- node topology labels (scheduler) --------------------------------------
# Physical slice topology of a TPU host, e.g. "4x4" (ref: GKE
# cloud.google.com/gke-tpu-topology).
NODE_TPU_TOPOLOGY_LABEL = "tpu.lws/topology"
# Slice identity: all hosts of one ICI-connected slice share this value.
NODE_TPU_SLICE_LABEL = "tpu.lws/slice"
# Accelerator generation, e.g. "v5e", "v5p".
NODE_TPU_ACCELERATOR_LABEL = "tpu.lws/accelerator"

# ---- internal labels (framework-owned kinds) -------------------------------
# Pod-template hash the GroupSet controller uses for its own rolling updates
# (distinct from the LWS-level template revision above).
GROUPSET_POD_REVISION_LABEL_KEY = "groupset.lws.tpu/pod-revision"

# ---- gang scheduling -------------------------------------------------------
# PodGroup a pod belongs to; injected by the scheduler provider
# (≈ volcano.sh/group-name, ref pkg/schedulerprovider/volcano_provider.go:103-109).
POD_GROUP_ANNOTATION_KEY = "gang.lws.tpu/pod-group"
