"""Certificate management: TLS for the control plane's HTTP API.

The reference embeds open-policy-agent/cert-controller to self-sign webhook
serving certs, rotate them, and publish the CA bundle into its webhook
configurations, gating controller startup on `certsReady`
(reference pkg/cert/cert.go:36-62, cmd/main.go:164-181,192-197). Here the
admission path is in-process, so the TLS surface is the API server itself:

- `CertManager.ensure()` creates a self-signed CA plus a CA-signed serving
  cert/key under `cert_dir` (ca.crt / server.crt / server.key) if absent or
  nearing expiry (rotation at 2/3 of lifetime, like cert-controller's
  lookahead), and returns the paths;
- `ApiServer(..., tls=CertManager(...))` serves HTTPS with it;
- clients trust it via the published `ca.crt` (CLI `--cacert`), the moral
  equivalent of the CA-bundle patch.

The port's copy of lws_tpu/core/certs.py.
"""

from __future__ import annotations

import datetime
import os
import ssl
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class CertPaths:
    ca_cert: Path
    server_cert: Path
    server_key: Path


class CertManager:
    def __init__(
        self,
        cert_dir: str,
        common_name: str = "lws-tpu-api",
        dns_names: tuple[str, ...] = ("localhost",),
        ip_addresses: tuple[str, ...] = ("127.0.0.1",),
        validity_s: int = 90 * 24 * 3600,
    ) -> None:
        self.cert_dir = Path(cert_dir)
        self.common_name = common_name
        self.dns_names = dns_names
        self.ip_addresses = ip_addresses
        self.validity_s = validity_s
        self.paths = CertPaths(
            ca_cert=self.cert_dir / "ca.crt",
            server_cert=self.cert_dir / "server.crt",
            server_key=self.cert_dir / "server.key",
        )

    # -- lifecycle --------------------------------------------------------

    def ensure(self) -> CertPaths:
        """Create or rotate the CA + serving cert; idempotent."""
        if not self._valid():
            self._generate()
        return self.paths

    def needs_rotation(self) -> bool:
        return not self._valid()

    def server_context(self) -> ssl.SSLContext:
        self.ensure()
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(str(self.paths.server_cert), str(self.paths.server_key))
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """A context trusting (only) this manager's CA — what a client built
        from the published bundle uses."""
        self.ensure()
        return client_context(str(self.paths.ca_cert))

    # -- internals --------------------------------------------------------

    def _valid(self) -> bool:
        from cryptography import x509

        for path in (self.paths.ca_cert, self.paths.server_cert, self.paths.server_key):
            if not path.exists():
                return False
        cert = x509.load_pem_x509_certificate(self.paths.server_cert.read_bytes())
        now = datetime.datetime.now(datetime.timezone.utc)
        lifetime = cert.not_valid_after_utc - cert.not_valid_before_utc
        # Rotate once 2/3 of the lifetime is behind us (cert-controller-style
        # lookahead: never serve into the expiry window).
        return now < cert.not_valid_before_utc + lifetime * 2 / 3

    def _generate(self) -> None:
        import ipaddress

        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID

        self.cert_dir.mkdir(parents=True, exist_ok=True)
        now = datetime.datetime.now(datetime.timezone.utc)
        not_after = now + datetime.timedelta(seconds=self.validity_s)

        ca_key = ec.generate_private_key(ec.SECP256R1())
        ca_name = x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, f"{self.common_name}-ca")]
        )
        ca_cert = (
            x509.CertificateBuilder()
            .subject_name(ca_name)
            .issuer_name(ca_name)
            .public_key(ca_key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(not_after)
            .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
            .sign(ca_key, hashes.SHA256())
        )

        key = ec.generate_private_key(ec.SECP256R1())
        sans: list[x509.GeneralName] = [x509.DNSName(d) for d in self.dns_names]
        sans += [x509.IPAddress(ipaddress.ip_address(ip)) for ip in self.ip_addresses]
        cert = (
            x509.CertificateBuilder()
            .subject_name(
                x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, self.common_name)])
            )
            .issuer_name(ca_name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(not_after)
            .add_extension(x509.SubjectAlternativeName(sans), critical=False)
            .sign(ca_key, hashes.SHA256())
        )

        self.paths.ca_cert.write_bytes(
            ca_cert.public_bytes(serialization.Encoding.PEM)
        )
        self.paths.server_cert.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
        # 0600 from creation: a create-then-chmod sequence leaves a window
        # where the private key is readable under a permissive umask.
        key_pem = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )
        fd = os.open(
            self.paths.server_key, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600
        )
        try:
            # O_CREAT's mode only applies to brand-new files; when rotating
            # over an existing (possibly permissive) key file, tighten BEFORE
            # the new key bytes land.
            os.fchmod(fd, 0o600)
            os.write(fd, key_pem)
        finally:
            os.close(fd)


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
