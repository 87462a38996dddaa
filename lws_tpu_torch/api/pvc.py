"""PersistentVolumeClaim: per-pod durable storage handle (≈ corev1.PVC).

Created by the GroupSet controller from volume_claim_templates, named
`<template>-<pod>`; retention policies mirror
StatefulSetPersistentVolumeClaimRetentionPolicy (ref
leaderworkerset_types.go:178-188, KEP-622).

The port's copy of lws_tpu/api/pvc.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject


@dataclass
class PVCSpec:
    storage: str = ""
    storage_class: str = ""
    access_modes: list[str] = field(default_factory=lambda: ["ReadWriteOnce"])


@dataclass
class PersistentVolumeClaim(TypedObject):
    kind = "PersistentVolumeClaim"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PVCSpec = field(default_factory=PVCSpec)
