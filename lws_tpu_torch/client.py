"""A minimal HTTP client of the control plane's API server: the port's copy
of the part of lws_tpu/client.py:RemoteClient that endpoint discovery and
the disaggregated workers call (`get` and `list`), and the workload-side
metric push the autoscaler reads (`report_metric`)."""

from __future__ import annotations

import json
import platform
import ssl
import urllib.error
import urllib.request
from typing import Optional


class ApiError(Exception):
    def __init__(self, code: int, detail: str) -> None:
        super().__init__(f"{code}: {detail}")
        self.code = code
        self.detail = detail


def client_context(ca_cert_path: Optional[str]) -> ssl.SSLContext:
    """TLS client context: verify against the given CA bundle, or (None) do
    not verify (the CLI's --insecure)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if ca_cert_path:
        ctx.load_verify_locations(ca_cert_path)
        return ctx
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


class RemoteClient:
    """HTTP(S) client of a running API server. Methods raise ApiError on a
    non-2xx reply."""

    def __init__(self, base_url: str, ca_cert: Optional[str] = None,
                 insecure: bool = False, token: Optional[str] = None) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        # https trust: an explicit CA bundle, else explicit insecure, else
        # the system store (no flag never means "no verification").
        self._context = None
        if self.base_url.startswith("https://") and (ca_cert or insecure):
            self._context = client_context(None if insecure else ca_cert)

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        headers = {"User-Agent": f"lws-tpu-torch ({platform.system().lower()}/"
                                 f"{platform.machine()})"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(self.base_url + path, data=body, method=method,
                                     headers=headers)
        try:
            # Above the server's 60 s long-poll window: a partitioned API
            # server fails the call instead of hanging it.
            with urllib.request.urlopen(req, timeout=90, context=self._context) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            detail = e.read().decode()
            try:
                detail = json.loads(detail).get("error", detail)
            except ValueError:
                pass
            raise ApiError(e.code, detail) from None

    def list(self, kind: str) -> list[dict]:
        return self._request("GET", f"/apis/{kind}")

    def get(self, kind: str, namespace: str, name: str) -> dict:
        return self._request("GET", f"/apis/{kind}/{namespace}/{name}")

    def report_metric(self, namespace: str, pod: str, metrics: dict) -> dict:
        """Annotate a pod with workload metrics ({name: number}) for the
        autoscaler (`POST /report-metric/{ns}/{pod}`)."""
        return self._request("POST", f"/report-metric/{namespace}/{pod}",
                             json.dumps(metrics).encode())
