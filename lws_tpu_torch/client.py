"""Typed clients (≈ client-go generated clientset): the port's copy of
lws_tpu/client.py, whole.

`Client` wraps an in-process Store (what controller code and tests use).
`RemoteClient` speaks the ApiServer's HTTP(S) API — the out-of-process
clientset — and `Informer` maintains a list+watch-synchronized local cache
over it (≈ client-go informers/listers: resync-on-expiry, event handlers).
The disaggregated workers' endpoint discovery reads through `RemoteClient`
and the workload-side metric push (`report_metric`) feeds the autoscaler.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Optional
from urllib.parse import quote, urlencode

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.disagg import DisaggregatedSet
from lws_tpu_torch.api.pod import Pod
from lws_tpu_torch.api.types import LeaderWorkerSet
from lws_tpu_torch.core.store import Store


class Client:
    def __init__(self, store: Store, namespace: str = "default") -> None:
        self.store = store
        self.namespace = namespace

    # ---- LeaderWorkerSet ----------------------------------------------
    def create_lws(self, lws: LeaderWorkerSet) -> LeaderWorkerSet:
        return self.store.create(lws)  # type: ignore[return-value]

    def get_lws(self, name: str) -> Optional[LeaderWorkerSet]:
        return self.store.try_get("LeaderWorkerSet", self.namespace, name)  # type: ignore[return-value]

    def list_lws(self) -> list[LeaderWorkerSet]:
        return self.store.list("LeaderWorkerSet", self.namespace)  # type: ignore[return-value]

    def update_lws(self, lws: LeaderWorkerSet) -> LeaderWorkerSet:
        return self.store.update(lws)  # type: ignore[return-value]

    def delete_lws(self, name: str) -> None:
        self.store.delete("LeaderWorkerSet", self.namespace, name)

    def scale_lws(self, name: str, replicas: int) -> LeaderWorkerSet:
        """The scale subresource (≈ leaderworkerset_types.go:416): what an
        HPA-equivalent autoscaler drives, selecting leader pods via
        status.hpa_pod_selector."""
        lws = self.store.get("LeaderWorkerSet", self.namespace, name)
        lws.spec.replicas = replicas
        return self.store.update(lws)  # type: ignore[return-value]

    # ---- DisaggregatedSet ---------------------------------------------
    def create_ds(self, ds: DisaggregatedSet) -> DisaggregatedSet:
        return self.store.create(ds)  # type: ignore[return-value]

    def get_ds(self, name: str) -> Optional[DisaggregatedSet]:
        return self.store.try_get("DisaggregatedSet", self.namespace, name)  # type: ignore[return-value]

    def update_ds(self, ds: DisaggregatedSet) -> DisaggregatedSet:
        return self.store.update(ds)  # type: ignore[return-value]

    def delete_ds(self, name: str) -> None:
        self.store.delete("DisaggregatedSet", self.namespace, name)

    # ---- pods / observation -------------------------------------------
    def pods_of(self, lws_name: str) -> list[Pod]:
        return self.store.list(  # type: ignore[return-value]
            "Pod", self.namespace, labels={contract.SET_NAME_LABEL_KEY: lws_name}
        )

    def leader_pods_of(self, lws_name: str) -> list[Pod]:
        return self.store.list(  # type: ignore[return-value]
            "Pod",
            self.namespace,
            labels={contract.SET_NAME_LABEL_KEY: lws_name, contract.WORKER_INDEX_LABEL_KEY: "0"},
        )


class ApiError(Exception):
    def __init__(self, code: int, detail: str) -> None:
        super().__init__(f"{code}: {detail}")
        self.code = code
        self.detail = detail


class RemoteClient:
    """HTTP(S) clientset against a running ApiServer (reference parity:
    client-go/clientset/versioned). All methods raise ApiError on non-2xx."""

    def __init__(self, base_url: str, ca_cert: Optional[str] = None,
                 insecure: bool = False, token: Optional[str] = None) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        # https trust: an explicit CA bundle, else explicit insecure, else
        # the system store (no flag never means "no verification").
        self._context = None
        if self.base_url.startswith("https://") and (ca_cert or insecure):
            from lws_tpu_torch.core.certs import client_context

            self._context = client_context(None if insecure else ca_cert)

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        from lws_tpu_torch.version import user_agent

        headers = {"User-Agent": user_agent()}  # ref useragent.go:36
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(self.base_url + path, data=body, method=method,
                                     headers=headers)
        try:
            # Above the server's 60 s /watch long-poll window: a partitioned
            # API server fails the call instead of hanging the informer, but
            # a healthy long poll never trips it.
            with urllib.request.urlopen(req, timeout=90, context=self._context) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            detail = e.read().decode()
            try:
                detail = json.loads(detail).get("error", detail)
            except ValueError:
                pass
            raise ApiError(e.code, detail) from None

    # -- objects ---------------------------------------------------------

    def list(self, kind: str) -> list[dict]:
        return self._request("GET", f"/apis/{kind}")

    def get(self, kind: str, namespace: str, name: str) -> dict:
        return self._request("GET", f"/apis/{kind}/{namespace}/{name}")

    def delete(self, kind: str, namespace: str, name: str) -> dict:
        return self._request("DELETE", f"/apis/{kind}/{namespace}/{name}")

    def apply(self, manifest_yaml: str) -> dict:
        return self._request("POST", "/apply", manifest_yaml.encode())

    def apply_object(self, obj) -> dict:
        import yaml

        from lws_tpu_torch.manifest import to_manifest

        return self.apply(yaml.safe_dump(to_manifest(obj), sort_keys=False))

    def server_side_apply(
        self, kind: str, namespace: str, name: str, fields: dict,
        field_manager: str, force: bool = False,
    ) -> dict:
        """Server-side apply: merge the partial plain field tree, claiming
        per-field ownership under `field_manager` (Store.apply semantics;
        409 with the conflicting fields+owners when another manager owns one
        and force is false)."""
        q = f"fieldManager={quote(field_manager)}&force={'true' if force else 'false'}"
        return self._request("POST", f"/apis/{kind}/{namespace}/{name}/apply?{q}",
                             json.dumps(fields).encode())

    # -- subresources ----------------------------------------------------

    def scale(self, namespace: str, name: str, replicas: int) -> dict:
        body = json.dumps({"replicas": replicas}).encode()
        return self._request("POST", f"/scale/{namespace}/{name}", body)

    def cordon(self, node: str, unschedulable: bool = True) -> dict:
        body = json.dumps({"unschedulable": unschedulable}).encode()
        return self._request("POST", f"/cordon/{node}", body)

    def drain(self, node: str) -> dict:
        return self._request("POST", f"/drain/{node}", b"{}")

    def report_metric(self, namespace: str, pod: str, metrics: dict) -> dict:
        """Annotate a pod with workload metrics ({name: number}) for the
        autoscaler (`POST /report-metric/{ns}/{pod}`)."""
        return self._request("POST", f"/report-metric/{namespace}/{pod}",
                             json.dumps(metrics).encode())

    def events(self, namespace: Optional[str] = None,
               name: Optional[str] = None) -> list[dict]:
        q = {k: v for k, v in (("namespace", namespace), ("name", name)) if v}
        suffix = f"?{urlencode(q)}" if q else ""
        return self._request("GET", f"/events{suffix}")

    # -- watch -----------------------------------------------------------

    def watch(self, since: int, timeout: float = 30.0) -> dict:
        """One long-poll: {"events": [...], "next": seq} or {"expired": True}."""
        return self._request("GET", f"/watch?since={since}&timeout={timeout}")

    def current_seq(self) -> int:
        return self._request("GET", "/watch?since=-1")["next"]


class Informer:
    """List+watch cache over a RemoteClient (≈ client-go shared informer +
    lister): `sync()` pulls pending events into the local cache, relisting
    when the server's watch window expired. Deterministic — call `sync()`
    yourself or use `start()` for a background thread."""

    KINDS = ("LeaderWorkerSet", "DisaggregatedSet", "GroupSet", "Pod",
             "Service", "Node", "PodGroup", "Autoscaler")

    def __init__(self, client: RemoteClient, kinds: Optional[tuple[str, ...]] = None,
                 on_event=None) -> None:
        self.client = client
        self.kinds = kinds or self.KINDS
        self.on_event = on_event
        self.cache: dict[tuple[str, str, str], dict] = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = None
        self._thread = None

    @staticmethod
    def _key(manifest: dict) -> tuple[str, str, str]:
        meta = manifest.get("metadata", {})
        return (manifest["kind"], meta.get("namespace", "default"), meta["name"])

    @staticmethod
    def _rv(manifest: dict) -> int:
        try:
            return int(manifest.get("metadata", {}).get("resourceVersion", 0))
        except (TypeError, ValueError):
            return 0

    def relist(self) -> None:
        # Bookmark FIRST, list second: events racing the relist are replayed
        # onto the fresh cache (replay is idempotent), never lost.
        seq = self.client.current_seq()
        cache: dict[tuple[str, str, str], dict] = {}
        for kind in self.kinds:
            for manifest in self.client.list(kind):
                cache[self._key(manifest)] = manifest
        with self._lock:
            self._seq = seq
            self.cache = cache

    def sync(self, timeout: float = 0.0) -> int:
        """Apply events since the last bookmark; returns how many applied."""
        with self._lock:
            seq = self._seq  # a relist on another thread may be moving the bookmark
        out = self.client.watch(seq, timeout=timeout)
        if out.get("expired"):
            self.relist()
            return 0
        applied = 0
        with self._lock:
            for ev in out["events"]:
                manifest = ev["object"]
                if manifest["kind"] not in self.kinds:
                    continue
                key = self._key(manifest)
                if ev["type"] == "DELETED":
                    self.cache.pop(key, None)
                else:
                    # Per-object staleness guard: a relist racing the watch
                    # stream can land a newer version in the cache before an
                    # older queued event is applied; never move backwards.
                    cached = self.cache.get(key)
                    if cached is not None and self._rv(cached) > self._rv(manifest):
                        continue
                    self.cache[key] = manifest
                applied += 1
                if self.on_event:
                    self.on_event(ev["type"], manifest)
            self._seq = out["next"]
        return applied

    def get(self, kind: str, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            return self.cache.get((kind, namespace, name))

    def list(self, kind: str) -> list[dict]:
        with self._lock:
            return [m for (k, _, _), m in self.cache.items() if k == kind]

    def start(self, poll_timeout: float = 10.0) -> None:
        self.relist()
        self._stop = threading.Event()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.sync(timeout=poll_timeout)
                except (ApiError, OSError):
                    self._stop.wait(1.0)  # server briefly away: retry

        self._thread = threading.Thread(target=loop, daemon=True, name="informer")
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
