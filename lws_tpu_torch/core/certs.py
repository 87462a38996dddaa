"""TLS for the CLI's client side: the port's copy of lws_tpu/core/certs.py,
trimmed to `client_context` (the `--cacert`/`--insecure` flags of
`python -m lws_tpu_torch`). Left out: `CertManager`, which mints and
rotates the API server's serving certificates on the control plane's side.
"""

from __future__ import annotations

import ssl
from typing import Optional


def client_context(ca_cert_path: Optional[str]) -> ssl.SSLContext:
    """Client-side context: verify against the given CA bundle, or (when
    None) disable verification — the CLI's `--insecure`."""
    if ca_cert_path:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(ca_cert_path)
        return ctx
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx
