"""Int-or-percent values for maxSurge/maxUnavailable (≈ k8s intstr).

ref: RollingUpdateConfiguration in api/leaderworkerset/v1/leaderworkerset_types.go:267-312
(absolute ints, or "30%" strings — percent of total; surge rounds up,
unavailable rounds down).

The port's copy of lws_tpu/api/intstr.py.
"""

from __future__ import annotations

import math
from typing import Union

IntOrPercent = Union[int, str]


def is_percent(value: IntOrPercent) -> bool:
    return isinstance(value, str)


def parse_percent(value: str) -> int:
    s = value.strip()
    if not s.endswith("%"):
        raise ValueError(f"invalid percentage value {value!r}")
    return int(s[:-1])


def scaled_value(value: IntOrPercent, total: int, round_up: bool) -> int:
    """≈ intstr.GetScaledValueFromIntOrPercent."""
    if isinstance(value, int):
        return value
    pct = parse_percent(value)
    v = pct * total / 100.0
    return math.ceil(v) if round_up else math.floor(v)


def validate(value: IntOrPercent, name: str) -> None:
    if isinstance(value, int):
        if value < 0:
            raise ValueError(f"{name} must be >= 0, got {value}")
        return
    pct = parse_percent(value)
    if pct < 0 or pct > 100:
        raise ValueError(f"{name} percentage must be in [0%,100%], got {value!r}")
