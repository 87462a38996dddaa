"""L2 admission: defaulting + validation for LWS/DS, pod mutation
(≈ pkg/webhooks/). Registered as store admission hooks — synchronous, inside
the write path, exactly like webhooks sit inside the apiserver request path.

The port's copy of lws_tpu/webhooks/__init__.py.
"""

from lws_tpu_torch.webhooks.lws_webhook import register_lws_webhooks  # noqa: F401
from lws_tpu_torch.webhooks.pod_webhook import register_pod_webhooks  # noqa: F401
