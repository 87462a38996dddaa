"""DisaggregatedSet controller suite (≈ pkg/controllers/disaggregatedset/):
pure-math rollout planner, rolling-update executor, LWS/service managers, and
the DS reconciler. On TPU, roles (prefill/decode) land on independent slice
pools; revision-aware per-role services publish KV-transfer endpoints.

The port's copy of lws_tpu/controllers/disagg/__init__.py.
"""

from lws_tpu_torch.controllers.disagg.planner import (  # noqa: F401
    ComputeAllSteps,
    ComputeNextStep,
    RollingUpdateConfig,
    UpdateStep,
)
from lws_tpu_torch.controllers.disagg.ds_controller import DSReconciler  # noqa: F401
