"""Rendezvous DNS view over headless Services (≈ cluster DNS for
`<pod>.<subdomain>.<namespace>`).

Publishing before readiness is the point: distributed JAX init must resolve
every peer while pods are still starting
(ref pkg/utils/controller/controller_utils.go:48-51 PublishNotReadyAddresses).

The port's copy of lws_tpu/core/dns.py.
"""

from __future__ import annotations

from typing import Optional

from lws_tpu_torch.api.pod import Pod
from lws_tpu_torch.api.service import Service
from lws_tpu_torch.core.store import Store


def pod_fqdn(pod_name: str, subdomain: str, namespace: str = "default") -> str:
    return f"{pod_name}.{subdomain}.{namespace}"


class DnsView:
    def __init__(self, store: Store) -> None:
        self.store = store

    def resolve(self, fqdn: str) -> Optional[Pod]:
        """Resolve `<pod>.<subdomain>.<ns>` to its Pod, honoring the backing
        Service's selector + publish_not_ready_addresses."""
        parts = fqdn.split(".")
        if len(parts) != 3:
            return None
        pod_name, subdomain, namespace = parts
        svc = self.store.try_get("Service", namespace, subdomain)
        if svc is None or not isinstance(svc, Service) or not svc.spec.headless:
            return None
        pod = self.store.try_get("Pod", namespace, pod_name)
        if pod is None or not isinstance(pod, Pod):
            return None
        if pod.spec.subdomain != subdomain:
            return None
        for k, v in svc.spec.selector.items():
            if pod.meta.labels.get(k) != v:
                return None
        if not svc.spec.publish_not_ready_addresses and not pod.status.ready:
            return None
        return pod

    def address(self, fqdn: str) -> Optional[str]:
        pod = self.resolve(fqdn)
        if pod is None:
            return None
        return pod.status.address or fqdn

    def endpoints(self, service: Service) -> list[Pod]:
        pods = self.store.list("Pod", service.meta.namespace, labels=service.spec.selector)
        if not service.spec.publish_not_ready_addresses:
            pods = [p for p in pods if p.status.ready]
        return [p for p in pods if p.spec.subdomain == service.meta.name]
