"""YAML/dict manifest codec: the user-facing declarative format
(camelCase, shaped like the reference CRDs so reference users feel at home —
ref config/samples/leaderworkerset_tpu.yaml, docs/examples/vllm/TPU/lws.yaml).

`from_manifest(dict) -> TypedObject` and `to_manifest(obj) -> dict` cover
LeaderWorkerSet, DisaggregatedSet, and Node.

The port's copy of lws_tpu/manifest.py.
"""

from __future__ import annotations

import re

from typing import Any, Optional

from lws_tpu_torch.api.disagg import (
    DisaggregatedRoleSpec,
    DisaggregatedSet,
    DisaggregatedSetSpec,
    LeaderWorkerSetTemplateSpec,
    TemplateObjectMeta,
)
from lws_tpu_torch.api.meta import ObjectMeta, to_plain
from lws_tpu_torch.api.node import CLUSTER_NAMESPACE, Node, NodeSpec
from lws_tpu_torch.api.pod import (
    Container,
    EnvVar,
    PodSpec,
    PodTemplateSpec,
    TemplateMeta,
    VolumeClaimTemplate,
)
from lws_tpu_torch.api.types import (
    LeaderWorkerSet,
    LeaderWorkerSetSpec,
    LeaderWorkerTemplate,
    NetworkConfig,
    RestartPolicy,
    RollingUpdateConfiguration,
    RolloutStrategy,
    RolloutStrategyType,
    StartupPolicy,
    SubdomainPolicy,
    SubGroupPolicy,
    SubGroupPolicyType,
)

API_GROUP = "lws.tpu/v1"


def _meta(raw: dict, default_namespace: str = "default") -> ObjectMeta:
    m = raw.get("metadata", {})
    return ObjectMeta(
        name=m.get("name", ""),
        namespace=m.get("namespace", default_namespace),
        labels=dict(m.get("labels", {})),
        annotations=dict(m.get("annotations", {})),
    )


_QUANTITY_RE = re.compile(r"^([0-9.eE+-]+?)(m|[kKMGTPE]i?|)$")
_QUANTITY_SUFFIX = {
    "": 1, "m": 1e-3,
    "k": 1e3, "K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}


def _quantity(value) -> int:
    """Parse a k8s resource quantity ("4", "100m", "1Gi") to base units.
    Sub-unit values (milli) floor to 0 — only whole-chip resources
    (google.com/tpu) participate in scheduling here."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _QUANTITY_RE.match(str(value).strip())
    if not m:
        raise ValueError(f"invalid resource quantity {value!r}")
    return int(float(m.group(1)) * _QUANTITY_SUFFIX[m.group(2)])


def _resources(raw: Optional[dict]) -> dict[str, int]:
    """Accept both the flat form (`resources: {google.com/tpu: 4}`) and the
    k8s nested form (`resources: {limits: {...}, requests: {...}}`) that
    reference manifests use (limits win over requests, as in kube)."""
    raw = raw or {}
    if raw and set(raw) <= {"limits", "requests"} and all(
        isinstance(v, dict) for v in raw.values()
    ):
        merged = dict(raw.get("requests") or {})
        merged.update(raw.get("limits") or {})
        raw = merged
    return {k: _quantity(v) for k, v in raw.items()}


def _container(raw: dict) -> Container:
    return Container(
        name=raw.get("name", "main"),
        image=raw.get("image", ""),
        command=list(raw.get("command", [])),
        env=[EnvVar(e["name"], str(e.get("value", ""))) for e in raw.get("env", [])],
        resources=_resources(raw.get("resources")),
        ports={k: int(v) for k, v in (raw.get("ports", {}) or {}).items()},
    )


def _pod_template(raw: Optional[dict]) -> PodTemplateSpec:
    raw = raw or {}
    meta = raw.get("metadata", {})
    spec = raw.get("spec", {})
    return PodTemplateSpec(
        metadata=TemplateMeta(
            labels=dict(meta.get("labels", {})),
            annotations=dict(meta.get("annotations", {})),
        ),
        spec=PodSpec(
            containers=[_container(c) for c in spec.get("containers", [{}])],
            init_containers=[_container(c) for c in spec.get("initContainers", [])],
            node_selector=dict(spec.get("nodeSelector", {})),
        ),
    )


def _vcts(raw: list) -> list[VolumeClaimTemplate]:
    return [
        VolumeClaimTemplate(
            name=v["name"],
            storage=str(v.get("storage", "")),
            storage_class=v.get("storageClass", ""),
            access_modes=list(v.get("accessModes", ["ReadWriteOnce"])),
        )
        for v in raw
    ]


def _lws_spec(raw: dict) -> LeaderWorkerSetSpec:
    lwt_raw = raw.get("leaderWorkerTemplate", {})
    lwt = LeaderWorkerTemplate(
        worker_template=_pod_template(lwt_raw.get("workerTemplate")),
        leader_template=(
            _pod_template(lwt_raw["leaderTemplate"]) if lwt_raw.get("leaderTemplate") else None
        ),
        size=int(lwt_raw.get("size", 1)),
        restart_policy=RestartPolicy(lwt_raw.get("restartPolicy", "RecreateGroupOnPodRestart")),
        volume_claim_templates=_vcts(lwt_raw.get("volumeClaimTemplates", [])),
    )
    sgp = lwt_raw.get("subGroupPolicy")
    if sgp:
        lwt.sub_group_policy = SubGroupPolicy(
            type=SubGroupPolicyType(sgp["subGroupPolicyType"]) if sgp.get("subGroupPolicyType") else None,
            sub_group_size=int(sgp["subGroupSize"]) if sgp.get("subGroupSize") is not None else None,
        )
    pvc_pol = lwt_raw.get("persistentVolumeClaimRetentionPolicy")
    if pvc_pol:
        lwt.pvc_retention_policy_when_deleted = pvc_pol.get("whenDeleted", "Retain")
        lwt.pvc_retention_policy_when_scaled = pvc_pol.get("whenScaled", "Retain")

    spec = LeaderWorkerSetSpec(
        replicas=int(raw.get("replicas", 1)),
        leader_worker_template=lwt,
        startup_policy=StartupPolicy(raw.get("startupPolicy", "LeaderCreated")),
    )
    rs = raw.get("rolloutStrategy")
    if rs:
        ruc = rs.get("rollingUpdateConfiguration")
        spec.rollout_strategy = RolloutStrategy(
            type=RolloutStrategyType(rs.get("type", "RollingUpdate")),
            rolling_update_configuration=RollingUpdateConfiguration(
                partition=int(ruc.get("partition", 0)),
                max_unavailable=_int_or_percent(ruc.get("maxUnavailable", 1)),
                max_surge=_int_or_percent(ruc.get("maxSurge", 0)),
            )
            if ruc
            else None,
        )
    nc = raw.get("networkConfig")
    if nc:
        spec.network_config = NetworkConfig(
            subdomain_policy=SubdomainPolicy(nc["subdomainPolicy"]) if nc.get("subdomainPolicy") else None
        )
    return spec


def _int_or_percent(v):
    if isinstance(v, str) and not v.endswith("%"):
        return int(v)
    return v


_OPAQUE_KEYS = frozenset({
    # Free-form maps whose keys are user data, not field names.
    "labels", "annotations", "nodeSelector", "node_selector",
    "resources", "ports", "capacity", "metrics",
})


def _spec_key_styles(spec) -> tuple[bool, bool]:
    """Recursively scan FIELD-NAME keys for (snake_case, camelCase) markers,
    skipping free-form maps (labels etc.) whose keys are user-chosen."""
    snake = camel = False
    stack = [spec]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            for k, v in x.items():
                if "_" in k:
                    snake = True
                elif k != k.lower():
                    camel = True
                if k not in _OPAQUE_KEYS:
                    stack.append(v)
        elif isinstance(x, list):
            stack.extend(x)
    return snake, camel


def _is_native_manifest(raw: dict) -> bool:
    """`to_manifest` output (GET /apis, `get -o yaml`) carries the store's
    snake_case plain form; hand-written k8s-style manifests use camelCase.
    Routing on the STRUCTURE (never on resourceVersion presence — kubectl
    exports keep it too) lets `get | apply` round-trip with full fidelity
    while camelCase manifests always take the k8s parser."""
    spec = raw.get("spec")
    if not isinstance(spec, dict):
        return False
    snake, camel = _spec_key_styles(spec)
    if snake and camel:
        raise ValueError(
            "manifest mixes snake_case and camelCase field names; "
            "use one form consistently"
        )
    if snake:
        return True
    if camel:
        return False
    # Structurally ambiguous (e.g. a bare Node spec): both parsers agree on
    # these shapes; prefer the native path only for our own exports.
    return "resourceVersion" in raw.get("metadata", {})


def _from_native_manifest(raw: dict):
    from lws_tpu_torch.core.serialize import _registry, from_plain

    cls = _registry().get(raw.get("kind"))
    if cls is None:
        raise ValueError(f"unknown kind {raw.get('kind')!r}")
    m = raw.get("metadata", {})
    plain: dict = {
        "meta": {
            "name": m.get("name", ""),
            "namespace": m.get("namespace", "default"),
            "labels": dict(m.get("labels", {})),
            "annotations": dict(m.get("annotations", {})),
        },
        "spec": raw.get("spec") or {},
    }
    if "status" in raw and raw["status"] is not None:
        plain["status"] = raw["status"]
    obj = from_plain(cls, plain)
    return obj


def from_manifest(raw: dict):
    kind = raw.get("kind")
    if kind in ("LeaderWorkerSet", "DisaggregatedSet", "Node", "Autoscaler") and _is_native_manifest(raw):
        return _from_native_manifest(raw)
    if kind == "LeaderWorkerSet":
        return LeaderWorkerSet(meta=_meta(raw), spec=_lws_spec(raw.get("spec", {})))
    if kind == "DisaggregatedSet":
        spec = raw.get("spec", {})
        roles = []
        for r in spec.get("roles", []):
            tmpl = r.get("template", {})
            roles.append(
                DisaggregatedRoleSpec(
                    name=r["name"],
                    replicas=int(r.get("replicas", 1)),
                    template=LeaderWorkerSetTemplateSpec(
                        metadata=TemplateObjectMeta(
                            labels=dict(tmpl.get("metadata", {}).get("labels", {})),
                            annotations=dict(tmpl.get("metadata", {}).get("annotations", {})),
                        ),
                        spec=_lws_spec(tmpl.get("spec", {})),
                    ),
                )
            )
        return DisaggregatedSet(
            meta=_meta(raw),
            spec=DisaggregatedSetSpec(roles=roles, slices=int(spec.get("slices", 1))),
        )
    if kind == "Node":
        spec = raw.get("spec", {})
        return Node(
            meta=_meta(raw, default_namespace=CLUSTER_NAMESPACE),
            spec=NodeSpec(capacity={k: int(v) for k, v in spec.get("capacity", {}).items()}),
        )
    if kind == "Autoscaler":
        from lws_tpu_torch.api.autoscaler import Autoscaler, AutoscalerSpec

        spec = raw.get("spec", {})
        return Autoscaler(
            meta=_meta(raw),
            spec=AutoscalerSpec(
                target=spec.get("target", ""),
                min_replicas=int(spec.get("minReplicas", 1)),
                max_replicas=int(spec.get("maxReplicas", 10)),
                metric=spec.get("metric", "inflight"),
                target_value=float(spec.get("targetValue", 1.0)),
                scale_down_stabilization=int(spec.get("scaleDownStabilization", 3)),
            ),
        )
    raise ValueError(f"unsupported manifest kind {kind!r}")


def load_manifests(path: str) -> list:
    """Load one or more `---`-separated YAML documents."""
    import yaml

    with open(path) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    return [from_manifest(d) for d in docs]


def to_manifest(obj) -> dict:
    """Plain-dict view of any stored object (for `get -o yaml` / API)."""
    out: dict[str, Any] = {
        "apiVersion": API_GROUP,
        "kind": obj.kind,
        "metadata": {
            "name": obj.meta.name,
            "namespace": obj.meta.namespace,
            "uid": obj.meta.uid,
            "resourceVersion": obj.meta.resource_version,
            "generation": obj.meta.generation,
            "labels": dict(obj.meta.labels),
            "annotations": dict(obj.meta.annotations),
        },
        "spec": to_plain(getattr(obj, "spec", None)),
    }
    status = getattr(obj, "status", None)
    if status is not None:
        out["status"] = to_plain(status)
    return out
