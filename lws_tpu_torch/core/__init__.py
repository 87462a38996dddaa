"""Core control-plane runtime (the port's copy of lws_tpu/core): versioned
object store with watches + owner GC (≈ kube-apiserver/etcd), admission
chain (≈ webhook admission), level-triggered reconciler manager with
per-controller workqueues (≈ controller-runtime), event recorder, and
rendezvous DNS view (≈ headless-service DNS). The names JAX's package
exports; none of them imports torch.
"""

from lws_tpu_torch.core.store import AdmissionError, ConflictError, NotFoundError, Store, WatchEvent  # noqa: F401
from lws_tpu_torch.core.manager import Manager, Reconciler, Result  # noqa: F401
from lws_tpu_torch.core.events import EventRecorder  # noqa: F401
from lws_tpu_torch.core.dns import DnsView  # noqa: F401
from lws_tpu_torch.core import metrics, trace  # noqa: F401
