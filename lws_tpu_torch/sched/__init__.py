"""L5 scheduling: slice-aware pod scheduler + gang-scheduling providers.

The reference delegates binding to kube-scheduler and gang admission to
Volcano (pkg/schedulerprovider/); here both are native and TPU-topology-aware:
a slice (NODE_TPU_SLICE_LABEL domain) is the atomic placement unit.

The port's copy of lws_tpu/sched/__init__.py.
"""

from lws_tpu_torch.sched.provider import GangSchedulerProvider, SchedulerProvider, get_pod_group_name  # noqa: F401
from lws_tpu_torch.sched.scheduler import Scheduler  # noqa: F401
from lws_tpu_torch.sched.topology import make_slice_nodes  # noqa: F401
