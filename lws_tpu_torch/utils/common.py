"""The port's copy of lws_tpu/utils/common.py, trimmed to `env_float` (the
one helper the telemetry copies call)."""

from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    """Float env knob with a safe fallback (shared by the SLO targets and
    the watchdog windows — one parse rule for every telemetry tunable)."""
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default
