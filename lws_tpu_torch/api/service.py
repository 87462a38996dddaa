"""Headless Service: the rendezvous plane (≈ corev1.Service, ClusterIP None).

`publish_not_ready_addresses=True` is load-bearing: every pod gets a stable
name `<pod>.<subdomain>.<ns>` *before* it is ready, so distributed init can
rendezvous during startup (ref pkg/utils/controller/controller_utils.go:33-65).
Resolution is implemented by lws_tpu_torch.core.dns.DnsView.

The port's copy of lws_tpu/api/service.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject


@dataclass
class ServiceSpec:
    selector: dict[str, str] = field(default_factory=dict)
    headless: bool = True
    publish_not_ready_addresses: bool = True


@dataclass
class Service(TypedObject):
    kind = "Service"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
