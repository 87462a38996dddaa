"""Lease: the coordination primitive behind controller-manager HA.

The reference gets leader election from controller-runtime's resourcelock
(a coordination.k8s.io/Lease renewed by the active manager; standbys take
over when it expires) — enabled by default via the `leader-elect*` flags
(reference cmd/main.go:95-106, default lease 15s / renew 10s / retry 2s).
Here the Lease is a first-class Store object so election shares the same
optimistic-concurrency and watch machinery as everything else.

The port's copy of lws_tpu/api/lease.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from lws_tpu_torch.api.meta import ObjectMeta, TypedObject

DEFAULT_LEASE_NAME = "lws-tpu-controller"
DEFAULT_LEASE_DURATION_S = 15.0
DEFAULT_RENEW_DEADLINE_S = 10.0
DEFAULT_RETRY_PERIOD_S = 2.0


@dataclass
class LeaseSpec:
    holder_identity: Optional[str] = None
    lease_duration_s: float = DEFAULT_LEASE_DURATION_S
    # Monotonic-ish timestamps written by the holder (injectable clock in the
    # elector keeps tests deterministic).
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0


@dataclass
class Lease(TypedObject):
    kind = "Lease"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)
