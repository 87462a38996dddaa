"""Version + user-agent (≈ pkg/utils/useragent + pkg/version): identifies
this control plane in logs/API calls.

The port's copy of lws_tpu/version.py.
"""

from __future__ import annotations

import platform

VERSION = "0.1.0"
GIT_COMMIT = "unknown"  # stamped by packaging


def user_agent() -> str:
    """`lws-tpu/<version> (<os>/<arch>) <commit>` (≈ useragent.go:36)."""
    return f"lws-tpu/{VERSION} ({platform.system().lower()}/{platform.machine()}) {GIT_COMMIT}"
