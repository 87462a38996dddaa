"""Core helpers (≈ pkg/utils/utils.go): the port's copy of
lws_tpu/utils/common.py, whole."""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


def env_float(name: str, default: float) -> float:
    """Float env knob with a safe fallback (shared by the SLO targets and
    the watchdog windows — one parse rule for every telemetry tunable)."""
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def sha1_hash(s: str) -> str:
    """≈ utils.go:39 Sha1Hash."""
    return hashlib.sha1(s.encode()).hexdigest()


def nonzero(v: int) -> int:
    """Clamp negatives to 0 (≈ utils.go:45 NonZeroValue)."""
    return max(0, v)


def sort_by_index(
    index_fn: Callable[[T], int], items: list[T], length: int
) -> list[Optional[T]]:
    """Place items at their index in a fixed-length list; missing slots are
    None (≈ utils.go:53-71 SortByIndex). Indices outside [0, length) dropped."""
    out: list[Optional[T]] = [None] * length
    for item in items:
        try:
            idx = index_fn(item)
        except (ValueError, KeyError, TypeError):
            continue
        if 0 <= idx < length:
            out[idx] = item
    return out


def group_resource_total(leader_resources: dict[str, int], worker_resources: dict[str, int], size: int) -> dict[str, int]:
    """Whole-group resource sum: leader + (size-1) x worker — used as gang
    minResources (≈ utils.go:84-103 CalculatePGMinResources)."""
    total = dict(leader_resources)
    for k, v in worker_resources.items():
        total[k] = total.get(k, 0) + v * (size - 1)
    return total


def stable_hash(obj) -> str:
    """Canonical short hash of any plain-able object (shared by revision
    hashing and groupset template hashing so the two can never diverge)."""
    import json

    from lws_tpu_torch.api.meta import to_plain

    canonical = json.dumps(to_plain(obj), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode()).hexdigest()[:10]
