"""Static-token authentication + role authorization for the HTTP API.

The reference serves its metrics endpoint behind controller-runtime's
authn/authz filters (ref cmd/main.go:336-348 `filters.WithAuthenticationAndAuthorization`)
and ships RBAC rules for its API surface (ref config/rbac/role.yaml). This is
the native equivalent for a self-hosted control plane: a kube-apiserver-style
static token file (`--token-auth-file` semantics) plus two roles.

Token file format — one entry per line, CSV like the apiserver's:

    <token>,<name>,<role>        # role: admin | view
    # comments and blank lines ignored

`admin` may do anything; `view` is read-only (GET). /healthz and /readyz stay
open (probes must not need credentials — same carve-out the reference makes
for its health endpoints vs the filtered metrics endpoint).

The port's copy of lws_tpu/core/auth.py.
"""

from __future__ import annotations

import hmac
import os
import secrets
from dataclasses import dataclass
from typing import Optional

ROLE_ADMIN = "admin"
ROLE_VIEW = "view"
_ROLES = (ROLE_ADMIN, ROLE_VIEW)

# Liveness probes stay unauthenticated (kubelet has no credential).
OPEN_PATHS = ("/healthz", "/readyz")


@dataclass(frozen=True)
class TokenEntry:
    token: str
    name: str
    role: str


class TokenAuth:
    def __init__(self, entries: list[TokenEntry]) -> None:
        if not entries:
            raise ValueError("token file has no entries")
        self.entries = entries

    @classmethod
    def load(cls, path: str) -> "TokenAuth":
        entries = []
        with open(path) as f:
            for lineno, raw in enumerate(f, 1):
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) == 1:
                    parts += ["default", ROLE_ADMIN]
                elif len(parts) == 2:
                    parts.append(ROLE_ADMIN)
                token, name, role = parts[:3]
                if role not in _ROLES:
                    raise ValueError(
                        f"{path}:{lineno}: unknown role {role!r} (one of {_ROLES})"
                    )
                if not token:
                    raise ValueError(f"{path}:{lineno}: empty token")
                entries.append(TokenEntry(token, name, role))
        return cls(entries)

    # -- authn/authz -------------------------------------------------------
    def authenticate(self, authorization: Optional[str]) -> Optional[TokenEntry]:
        """Resolve an `Authorization: Bearer <token>` header; None = reject."""
        if not authorization or not authorization.startswith("Bearer "):
            return None
        presented = authorization[len("Bearer "):].strip()
        # Compare as bytes: compare_digest(str, str) raises TypeError on
        # non-ASCII, and header values are latin-1-decoded attacker input —
        # a crafted token must yield 401, not a crashed handler.
        presented_b = presented.encode("utf-8", "surrogateescape")
        for entry in self.entries:
            # Constant-time comparison: the API port may face a hostile net.
            if hmac.compare_digest(entry.token.encode(), presented_b):
                return entry
        return None

    @staticmethod
    def authorize(entry: TokenEntry, method: str) -> bool:
        if entry.role == ROLE_ADMIN:
            return True
        return method == "GET"  # view: read-only


def generate_token() -> str:
    return secrets.token_urlsafe(32)


def write_bootstrap_tokens(path: str) -> dict[str, str]:
    """Create a fresh token file (mode 0600 from birth) with one admin and
    one view token; returns {role: token}."""
    tokens = {ROLE_ADMIN: generate_token(), ROLE_VIEW: generate_token()}
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write("# lws-tpu API tokens: <token>,<name>,<role>\n")
        for role, token in tokens.items():
            f.write(f"{token},{role},{role}\n")
    return tokens
