"""The port's token auth, certificates and install bundle
(lws_tpu_torch/core/auth.py, core/certs.py, the ApiServer's `auth=` and
`tls=`, and `python -m lws_tpu_torch install`) against the JAX package's,
on the CPU.

Every case of tests/test_certs.py and tests/test_auth_install.py runs on
both packages with the same inputs:
- the API servers over the same token file answer the same status for
  every (token, method, path) of one table;
- `CertManager` writes the same files with the same modes, names,
  validity window and rotation point; a running HTTPS server of either
  rotates the same way;
- `install` renders the same bundle. Normalized, and only these: the
  bundle's root directory, the package name in commands (the port's
  Kubernetes Deployment names its command, `python -m lws_tpu_torch`,
  where JAX's relies on its image's entrypoint), and the random tokens,
  keys and certificate serials.
"""

from __future__ import annotations

import argparse
import json
import os
import ssl
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml
from cryptography import x509

from lws_tpu import cli as jcli
from lws_tpu import client as jclient
from lws_tpu.core import auth as jauth
from lws_tpu.core import certs as jcerts
from lws_tpu.runtime import ControlPlane as JControlPlane
from lws_tpu.runtime.server import ApiServer as JApiServer
from lws_tpu_torch import cli as pcli
from lws_tpu_torch import client as pclient
from lws_tpu_torch.core import auth as pauth
from lws_tpu_torch.core import certs as pcerts
from lws_tpu_torch.runtime import ControlPlane as PControlPlane
from lws_tpu_torch.runtime.server import ApiServer as PApiServer
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_fleet import port_planes_restored  # noqa: F401

# Every test here leaves both packages' process planes as it found them.
pytestmark = pytest.mark.usefixtures("jax_planes_restored", "port_planes_restored")

JAX = SimpleNamespace(name="jax", auth=jauth, certs=jcerts, ControlPlane=JControlPlane,
                      ApiServer=JApiServer, client=jclient, cli=jcli)
PORT = SimpleNamespace(name="port", auth=pauth, certs=pcerts, ControlPlane=PControlPlane,
                       ApiServer=PApiServer, client=pclient, cli=pcli)
SIDES = (JAX, PORT)

LWS_YAML = b"""
apiVersion: leaderworkerset.x-k8s.io/v1
kind: LeaderWorkerSet
metadata: {name: authy}
spec:
  replicas: 1
  leaderWorkerTemplate: {size: 2}
"""


@pytest.fixture(autouse=True)
def no_cli_credentials(monkeypatch):
    for c in (pcli, jcli):
        monkeypatch.setattr(c, "_TOKEN", None)
        monkeypatch.setattr(c, "_TLS_CONTEXT", None)


# ---------------------------------------------------------------------------
# Token auth: tests/test_auth_install.py's cases on both API servers


@pytest.fixture
def authed_servers(tmp_path):
    """A JAX and a port ApiServer behind one token file (one admin and one
    view token, written by the port's write_bootstrap_tokens)."""
    path = str(tmp_path / "tokens.csv")
    tokens = pauth.write_bootstrap_tokens(path)
    servers = []
    for side in SIDES:
        srv = side.ApiServer(side.ControlPlane(auto_ready=True), port=0,
                             auth=side.auth.TokenAuth.load(path))
        srv.start()
        servers.append(srv)
    yield [s.port for s in servers], tokens
    for s in servers:
        s.stop()


def _req(port, method, path, token=None, body=None):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            status, text = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    try:
        return status, json.loads(text or "{}")
    except ValueError:
        return status, "<text>"


def same(ports, method, path, token=None, body=None):
    got = [_req(p, method, path, token, body) for p in ports]
    assert got[1] == got[0], (method, path)
    return got[0]


def test_health_probes_stay_open(authed_servers):
    ports, _ = authed_servers
    for path in ("/healthz", "/readyz"):
        assert same(ports, "GET", path) == (200, "<text>")


def test_no_token_is_401(authed_servers):
    ports, _ = authed_servers
    assert same(ports, "GET", "/apis/lws")[0] == 401
    assert same(ports, "GET", "/metrics")[0] == 401


def test_wrong_token_is_401(authed_servers):
    ports, _ = authed_servers
    assert same(ports, "GET", "/apis/lws", token="not-a-real-token")[0] == 401


def test_admin_can_write_view_cannot(authed_servers):
    ports, tokens = authed_servers
    status, out = same(ports, "POST", "/apply", tokens["admin"], LWS_YAML)
    assert status == 200 and out["applied"] == ["LeaderWorkerSet/authy"]
    status, objs = _req(ports[1], "GET", "/apis/lws", tokens["view"])
    assert status == 200 and [o["metadata"]["name"] for o in objs] == ["authy"]
    assert same(ports, "POST", "/apply", tokens["view"], LWS_YAML)[0] == 403
    assert same(ports, "DELETE", "/apis/lws/default/authy", tokens["view"])[0] == 403


def test_non_ascii_token_is_rejected_not_crash(authed_servers):
    ports, _ = authed_servers
    assert same(ports, "GET", "/apis/lws", token="caf\xe9-token")[0] == 401


# Every route family by method, once per kind of credential.
TABLE_ROUTES = (
    ("GET", "/healthz"), ("GET", "/readyz"), ("GET", "/healthz?x=1"), ("GET", "/apis/lws"),
    ("GET", "/apis/lws/default/authy"), ("GET", "/metrics"), ("GET", "/events"),
    ("GET", "/watch?since=-1"), ("GET", "/debug/faults"), ("GET", "/nowhere"),
    ("POST", "/apply"), ("POST", "/scale/default/authy"), ("POST", "/cordon/n1"),
    ("POST", "/drain/n1"), ("POST", "/report-metric/default/p"), ("POST", "/healthz"),
    ("DELETE", "/apis/lws/default/authy"), ("DELETE", "/healthz"),
)


def test_the_token_method_path_table_equals_jax_s(authed_servers):
    """(credential, method, path) -> status on both servers: none, a wrong
    token, a malformed header, the view token, then the admin token (whose
    writes land, so the last rows run against the same objects)."""
    ports, tokens = authed_servers
    table = {}
    for who, token in (("none", None), ("wrong", "nope"), ("view", tokens["view"]),
                       ("admin", tokens["admin"])):
        for method, path in TABLE_ROUTES:
            body = {"POST": LWS_YAML if path == "/apply" else b"{}"}.get(method)
            table[who, method, path] = same(ports, method, path, token, body)[0]
    # Basic credentials and a bare token are not bearer tokens.
    for header in (f"Basic {tokens['admin']}", tokens["admin"]):
        got = []
        for p in ports:
            req = urllib.request.Request(f"http://127.0.0.1:{p}/apis/lws",
                                         headers={"Authorization": header})
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    got.append(resp.status)
            except urllib.error.HTTPError as e:
                got.append(e.code)
        assert got == [401, 401]
    assert {s for (who, m, p), s in table.items() if who in ("none", "wrong")
            and not p.startswith(("/healthz", "/readyz"))} == {401}
    # The view role may only GET; the probes' paths stay open to any method.
    assert {table["view", m, p] for m, p in TABLE_ROUTES
            if m != "GET" and p != "/healthz"} == {403}
    assert table["admin", "POST", "/apply"] == 200


def test_remote_client_sends_token(authed_servers):
    ports, tokens = authed_servers
    for side, port in zip(SIDES, ports):
        ok = side.client.RemoteClient(f"http://127.0.0.1:{port}", token=tokens["admin"])
        if side is JAX:
            ok.apply(LWS_YAML.decode())
        else:  # the port's client carries get and list; apply through the JAX one
            jclient.RemoteClient(f"http://127.0.0.1:{port}", token=tokens["admin"]).apply(
                LWS_YAML.decode())
        assert [o["metadata"]["name"] for o in ok.list("LeaderWorkerSet")] == ["authy"]
        anon = side.client.RemoteClient(f"http://127.0.0.1:{port}")
        with pytest.raises(side.client.ApiError) as e:
            anon.list("LeaderWorkerSet")
        assert e.value.code == 401


def test_token_file_parsing(tmp_path):
    p = tmp_path / "tokens.csv"
    p.write_text("# comment\n\nsecret-a,alice,admin\nsecret-v,bob,view\nbare-token\n")
    seen = []
    for side in SIDES:
        auth = side.auth.TokenAuth.load(str(p))
        assert auth.authenticate("Bearer secret-a").role == "admin"
        assert auth.authenticate("Bearer bare-token").role == "admin"  # default
        assert auth.authenticate("Bearer nope") is None
        assert auth.authenticate(None) is None
        assert not side.auth.TokenAuth.authorize(auth.authenticate("Bearer secret-v"), "POST")
        seen.append([(e.token, e.name, e.role) for e in auth.entries])
    assert seen[1] == seen[0]
    for bad, text in (("bad.csv", "tok,joe,superuser\n"), ("empty.csv", "# none\n"),
                      ("blank.csv", ",joe,view\n")):
        (tmp_path / bad).write_text(text)
        errors = []
        for side in SIDES:
            with pytest.raises(ValueError) as e:
                side.auth.TokenAuth.load(str(tmp_path / bad))
            errors.append(str(e.value))
        assert errors[1] == errors[0]


def test_bootstrap_tokens_are_private_and_parse_alike(tmp_path):
    for side in SIDES:
        path = tmp_path / f"{side.name}.csv"
        tokens = side.auth.write_bootstrap_tokens(str(path))
        assert path.stat().st_mode & 0o777 == 0o600
        lines = path.read_text().splitlines()
        assert lines[0] == "# lws-tpu API tokens: <token>,<name>,<role>"
        assert [ln.split(",")[1:] for ln in lines[1:]] == [["admin", "admin"], ["view", "view"]]
        for other in SIDES:  # each package reads the other's file
            auth = other.auth.TokenAuth.load(str(path))
            assert {e.role: e.token for e in auth.entries} == tokens


# ---------------------------------------------------------------------------
# Certificates: tests/test_certs.py's cases on both packages


def cert_facts(paths) -> dict:
    """What CertManager decides about its files (not the random keys)."""
    ca = x509.load_pem_x509_certificate(paths.ca_cert.read_bytes())
    srv = x509.load_pem_x509_certificate(paths.server_cert.read_bytes())
    san = srv.extensions.get_extension_for_class(x509.SubjectAlternativeName).value
    return {
        "files": sorted(p.name for p in paths.ca_cert.parent.iterdir()),
        "key_mode": oct(paths.server_key.stat().st_mode & 0o777),
        "ca_subject": ca.subject.rfc4514_string(),
        "ca_is_ca": ca.extensions.get_extension_for_class(x509.BasicConstraints).value.ca,
        "subject": srv.subject.rfc4514_string(),
        "issuer": srv.issuer.rfc4514_string(),
        "dns": san.get_values_for_type(x509.DNSName),
        "ips": [str(ip) for ip in san.get_values_for_type(x509.IPAddress)],
        "lifetime_s": (srv.not_valid_after_utc - srv.not_valid_before_utc).total_seconds(),
        "ca_lifetime_s": (ca.not_valid_after_utc - ca.not_valid_before_utc).total_seconds(),
        "signature": srv.signature_hash_algorithm.name,
        "key_curve": srv.public_key().curve.name,
    }


def test_ensure_generates_and_is_idempotent(tmp_path):
    facts = []
    for side in SIDES:
        mgr = side.certs.CertManager(str(tmp_path / side.name / "pki"))
        paths = mgr.ensure()
        assert paths.ca_cert.exists() and paths.server_cert.exists()
        assert paths.server_key.stat().st_mode & 0o777 == 0o600
        before = paths.server_cert.read_bytes()
        mgr.ensure()
        assert paths.server_cert.read_bytes() == before  # no spurious rotation
        assert not mgr.needs_rotation()
        facts.append(cert_facts(paths))
    assert facts[1] == facts[0]
    # Each package trusts (and does not rotate) the other's files.
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        mgr = reader.certs.CertManager(str(tmp_path / writer.name / "pki"))
        before = mgr.paths.server_cert.read_bytes()
        assert not mgr.needs_rotation() and mgr.ensure().server_cert.read_bytes() == before


def test_rotation_past_two_thirds_lifetime(tmp_path):
    mgrs = [side.certs.CertManager(str(tmp_path / side.name), validity_s=1) for side in SIDES]
    first = [m.ensure().server_cert.read_bytes() for m in mgrs]
    time.sleep(1.1)
    assert [m.needs_rotation() for m in mgrs] == [True, True]
    assert all(m.ensure().server_cert.read_bytes() != f for m, f in zip(mgrs, first))
    assert cert_facts(mgrs[1].paths) == cert_facts(mgrs[0].paths)


def test_https_api_round_trip(tmp_path):
    for side in SIDES:
        cp = side.ControlPlane(auto_ready=True)
        server = side.ApiServer(cp, port=0, tls=side.certs.CertManager(str(tmp_path / side.name)))
        server.start()
        base = f"https://127.0.0.1:{server.port}"
        try:
            ctx = side.certs.client_context(str(tmp_path / side.name / "ca.crt"))
            req = urllib.request.Request(base + "/apply", data=LWS_YAML, method="POST")
            with urllib.request.urlopen(req, context=ctx) as r:
                assert json.loads(r.read())["applied"] == ["LeaderWorkerSet/authy"]
            with urllib.request.urlopen(base + "/apis/lws", context=ctx) as r:
                assert json.loads(r.read())[0]["metadata"]["name"] == "authy"
            # The default trust store does not know the self-signed CA...
            with pytest.raises(urllib.error.URLError) as e:
                urllib.request.urlopen(base + "/healthz", context=ssl.create_default_context())
            assert isinstance(e.value.reason, ssl.SSLError)
            # ...and --insecure skips verification.
            with urllib.request.urlopen(base + "/healthz",
                                        context=side.certs.client_context(None)) as r:
                assert r.read() == b"ok"
            # The CLI over https with --cacert, as the JAX package's.
            rc = side.cli.main(["--cacert", str(tmp_path / side.name / "ca.crt"), "get", "lws",
                                "--server", base])
            assert rc == 0
        finally:
            server.stop()


def test_running_server_rotates_certs(tmp_path):
    """Rotation reaches clients of a running server of either package: the
    listener wraps per connection, so a regenerated cert/CA applies without
    a restart."""
    servers, mgrs, old = [], [], []
    for side in SIDES:
        mgr = side.certs.CertManager(str(tmp_path / side.name), validity_s=3)
        srv = side.ApiServer(side.ControlPlane(), port=0, tls=mgr)
        srv.start()
        servers.append(srv)
        mgrs.append(mgr)
    try:
        for side, srv, mgr in zip(SIDES, servers, mgrs):
            ctx = side.certs.client_context(str(mgr.paths.ca_cert))
            with urllib.request.urlopen(f"https://127.0.0.1:{srv.port}/healthz",
                                        context=ctx) as r:
                assert r.read() == b"ok"
            old.append(ctx)
        time.sleep(2.1)  # past 2/3 of the 3 s lifetime: rotation due
        for side, srv, mgr, ctx in zip(SIDES, servers, mgrs, old):
            base = f"https://127.0.0.1:{srv.port}/healthz"
            with pytest.raises(urllib.error.URLError):
                urllib.request.urlopen(base, context=ctx)
            new_ctx = side.certs.client_context(str(mgr.paths.ca_cert))
            with urllib.request.urlopen(base, context=new_ctx) as r:
                assert r.read() == b"ok"
    finally:
        for srv in servers:
            srv.stop()


# ---------------------------------------------------------------------------
# The install bundle: tests/test_auth_install.py's cases on both packages


def bundle(root) -> dict:
    """The bundle's files, normalized: its root, the package name, the
    random token values (kept as their count and roles), and the PEM
    material (kept as cert_facts)."""
    root = str(root)
    out = {}
    tokens = {}
    for line in open(os.path.join(root, "tokens.csv")).read().splitlines()[1:]:
        token, name, role = line.split(",")
        tokens[token] = f"<{role}-token>"
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if rel.startswith("tls"):
                continue
            text = open(path).read().replace(root, "<root>")
            for token, label in tokens.items():
                text = text.replace(token, label)
            text = text.replace("lws_tpu_torch", "lws_tpu")
            # The port's Deployment names its command; JAX's image has it.
            text = text.replace("        command: [python, -m, lws_tpu]\n", "")
            # The port closes the readiness probe's flow mapping; JAX's
            # template leaves one brace open.
            text = text.replace("scheme: HTTPS}}\n", "scheme: HTTPS}\n")
            out[rel] = (text, oct(os.stat(path).st_mode & 0o777))
    out["dirs"] = sorted(os.path.relpath(d, root) for d, _, _ in os.walk(root))
    out["tls"] = cert_facts(pcerts.CertPaths(
        *(Path(root, "tls", n) for n in ("ca.crt", "server.crt", "server.key"))))
    return out


def install_both(tmp_path, capsys, *argv) -> dict:
    got = {}
    for side in SIDES:
        root = tmp_path / side.name / "bundle"
        rc = side.cli.main(["install", str(root), *argv])
        printed = capsys.readouterr().out.replace(str(root), "<root>")
        token = next(e.token for e in pauth.TokenAuth.load(str(root / "tokens.csv")).entries
                     if e.role == "admin")
        got[side.name] = (rc, printed.replace(token[:8], "<admin>"), bundle(root))
    assert got["port"] == got["jax"]
    return got["port"]


def test_install_renders_bundle(tmp_path, capsys):
    rc, _, files = install_both(tmp_path, capsys)
    assert rc == 0
    root = tmp_path / "port" / "bundle"
    for name in ("config.yaml", "tokens.csv", "start.sh", "lws-tpu.service",
                 "README.md", "kubernetes/deployment.yaml", "state", "tls"):
        assert (root / name).exists(), name
    assert (root / "tokens.csv").stat().st_mode & 0o777 == 0o600
    auth = pauth.TokenAuth.load(str(root / "tokens.csv"))
    assert {e.role for e in auth.entries} == {"admin", "view"}
    from lws_tpu_torch.config import load_configuration

    cfg = load_configuration(str(root / "config.yaml"))
    assert cfg.enable_scheduler and cfg.backend == "local"
    unit = (root / "lws-tpu.service").read_text()
    assert f"--state-dir {root}/state" in unit and "--token-file" in unit
    for name in ("start.sh", "lws-tpu.service"):
        assert "-m lws_tpu_torch serve " in (root / name).read_text(), name
    deployment = (root / "kubernetes" / "deployment.yaml").read_text()
    assert "command: [python, -m, lws_tpu_torch]" in deployment
    docs = list(yaml.safe_load_all(deployment))
    assert [d["kind"] for d in docs] == ["Deployment", "Service"]
    container = docs[0]["spec"]["template"]["spec"]["containers"][0]
    assert container["readinessProbe"] == {"httpGet": {
        "path": "/readyz", "port": container["ports"][0]["containerPort"],
        "scheme": "HTTPS"}}


def test_install_rerun_preserves_tokens(tmp_path, capsys):
    install_both(tmp_path, capsys)
    before = {s.name: (tmp_path / s.name / "bundle" / "tokens.csv").read_text() for s in SIDES}
    rc, printed, _ = install_both(tmp_path, capsys)
    assert rc == 0 and "preserved existing tokens" in printed
    for s in SIDES:
        assert (tmp_path / s.name / "bundle" / "tokens.csv").read_text() == before[s.name]


def test_install_values_parameterized(tmp_path):
    (tmp_path / "vals.yaml").write_text("port: 7443\nreplicaCount: 5\n")
    got = {}
    for side in SIDES:
        root = tmp_path / side.name / "bundle"
        args = argparse.Namespace(
            dir=str(root), port=None, backend=None, python="python3",
            set=["namespace=prod", "enablePrometheus=true"], values=str(tmp_path / "vals.yaml"))
        assert side.cli.cmd_install(args) == 0
        got[side.name] = bundle(root)
    assert got["port"] == got["jax"]
    root = tmp_path / "port" / "bundle"
    dep = (root / "kubernetes" / "deployment.yaml").read_text()
    assert "namespace: prod" in dep and "replicas: 5" in dep and "containerPort: 7443" in dep
    assert "prometheus.io/scrape" in dep
    assert "port: 7443" in (root / "config.yaml").read_text()
    vals = (root / "values.yaml").read_text()
    assert "replicaCount: 5" in vals and "namespace: prod" in vals
    readme = (root / "README.md").read_text()
    assert "https://127.0.0.1:7443" in readme and "None" not in readme
    for values, sets, kw in ((str(tmp_path / "vals.yaml"), ["port=1234"], {"port": 999}),
                             (str(tmp_path / "vals.yaml"), ["port=1234"], {}),
                             (None, ["backend=fake", "schedulerProvider="], {})):
        want = jcli.resolve_install_values(values, sets, **kw)
        assert pcli.resolve_install_values(values, sets, **kw) == want
    assert pcli.INSTALL_VALUES == jcli.INSTALL_VALUES


@pytest.mark.parametrize("values,sets", [
    (None, ["bogus=1"]), (None, ["enablePrometheus=maybe"]), ("null.yaml", None),
    ("bad.yaml", None), ("list.yaml", None), (None, ["backend=locall"]),
    (None, ["serviceType=External"]), (None, ["noequals"]), (None, ["port=x"]),
], ids=lambda v: str(v))
def test_install_values_error_paths(tmp_path, values, sets):
    (tmp_path / "null.yaml").write_text("port:\n")
    (tmp_path / "bad.yaml").write_text("port: [1,2\n")
    (tmp_path / "list.yaml").write_text("- a\n")
    path = str(tmp_path / values) if values else None
    errors = []
    for side in SIDES:
        with pytest.raises(ValueError) as e:
            side.cli.resolve_install_values(path, sets)
        errors.append(str(e.value))
    assert errors[1] == errors[0]
