"""The port's API server and control-plane commands (lws_tpu_torch's
runtime/server.py, cli.py serve|apply|get|delete|scale|logs|events) against
the JAX package's.

A JAX ApiServer over a JAX ControlPlane and a port ApiServer over a port
ControlPlane hold the same state; every included route gets the same
requests and must answer with the same codes and bodies, and the commands
of `python -m lws_tpu_torch` must print what `python -m lws_tpu` prints.
Normalized, and only these: `uid`, `resourceVersion`,
`last_transition_time` and the events' `timestamp`, with the age the
`events` command prints from it (random ids and wall clocks). Node
maintenance (`/cordon`, `/drain`) and the durability, TLS and auth options
are held to JAX in tests/test_torch_maintenance.py,
tests/test_torch_wal.py, tests/test_torch_election.py and
tests/test_torch_auth_certs.py.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from lws_tpu import cli as jcli
from lws_tpu.runtime.server import ApiServer as JApiServer
from lws_tpu_torch import cli as pcli
from lws_tpu_torch.runtime.server import ApiServer as PApiServer
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_control_plane import KINDS, PORT, ROOT, Both, state
from tests.test_torch_fleet import port_planes_restored  # noqa: F401

# Every test here leaves the port's process planes as it found them
# (tests/test_torch_fleet.py:port_planes_restored).
pytestmark = pytest.mark.usefixtures("port_planes_restored")

REPO = Path(ROOT)
NORMALIZED = frozenset({"uid", "resourceVersion", "last_transition_time", "timestamp"})
LWS_YAML = """\
apiVersion: lws.tpu/v1
kind: LeaderWorkerSet
metadata:
  name: web
spec:
  replicas: 2
  leaderWorkerTemplate:
    size: 2
    workerTemplate:
      spec:
        containers:
        - name: w
          image: v1
          command: [python, -c, pass]
"""


def normalize(x):
    if isinstance(x, dict):
        return {k: ("<normalized>" if k in NORMALIZED else normalize(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [normalize(v) for v in x]
    return x


def call(base: str, method: str, path: str, body: bytes | None = None,
         headers: dict | None = None):
    req = urllib.request.Request(base + path, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def decoded(answer):
    code, ctype, body = answer
    if ctype == "application/json":
        return code, ctype, normalize(json.loads(body))
    return code, ctype, body


class Servers:
    """Both planes (tests/test_torch_control_plane.Both) behind their API
    servers; the planes are stepped with run_until_stable by the test."""

    def __init__(self, watch_buffer: int = 4096) -> None:
        self.both = Both()
        self.logs = {("default", "web-0"): "hello from web-0\n"}
        self.servers = []
        for (side, cp), Server in zip(self.both.sides, (JApiServer, PApiServer)):
            cp.log_provider = lambda ns, name: self.logs.get((ns, name))
            srv = Server(cp, port=0, watch_buffer=watch_buffer)
            srv.start()
            self.servers.append(srv)
        self.urls = [f"http://127.0.0.1:{s.port}" for s in self.servers]

    def same(self, method: str, path: str, body: bytes | None = None, **kw):
        """One request to both servers; the answers must be equal."""
        want, got = (decoded(call(u, method, path, body, **kw)) for u in self.urls)
        assert got == want, (method, path)
        return want

    def settle(self) -> None:
        self.both.do(lambda side, cp: None)

    def close(self) -> None:
        for s in self.servers:
            s.stop()


@pytest.fixture
def servers(jax_planes_restored):
    s = Servers()
    yield s
    s.close()


def test_every_included_route_answers_as_jax_does(servers):
    s = servers
    for path in ("/healthz", "/readyz"):
        assert s.same("GET", path)[:2] == (200, "text/plain")
    assert s.same("GET", "/apis/pods") == (200, "application/json", [])
    s.same("GET", "/apis/nonsense")
    assert s.same("POST", "/apply", LWS_YAML.encode())[2] == {"applied": ["LeaderWorkerSet/web"]}
    s.settle()
    for kind in ("pods", "lws", "LeaderWorkerSet", "groupsets", "services", "revisions"):
        assert s.same("GET", f"/apis/{kind}")[0] == 200
    assert s.same("GET", "/apis/lws/default/web")[0] == 200
    assert s.same("GET", "/apis/lws/default/nope")[0] == 404
    # Re-apply with a change, scale, server-side apply.
    s.same("POST", "/apply", LWS_YAML.replace("image: v1", "image: v2").encode())
    s.settle()
    assert s.same("POST", "/scale/default/web", b'{"replicas": 3}')[2] == {
        "scaled": "web", "replicas": 3}
    s.settle()
    s.same("POST", "/scale/default/nope", b'{"replicas": 3}')
    s.same("POST", "/scale/default/web", b'{"replica": 3}')
    ssa = json.dumps({"spec": {"replicas": 2}}).encode()
    assert s.same("POST", "/apis/lws/default/web/apply?fieldManager=hpa", ssa)[0] == 200
    s.settle()
    assert s.same("POST", "/apis/lws/default/web/apply?fieldManager=other",
                  json.dumps({"spec": {"replicas": 4}}).encode())[0] == 409
    # Refused by validation, and malformed.
    bad = LWS_YAML.replace("size: 2", "size: 0").replace("name: web", "name: bad")
    assert s.same("POST", "/apply", bad.encode())[0] == 422
    assert s.same("POST", "/apply", b"kind: Nonsense\n")[0] == 422
    assert s.same("POST", "/nowhere", b"{}")[0] == 404
    # Events and logs.
    evs = s.same("GET", "/events")[2]
    assert evs and {e["object"].split("/")[0] for e in evs} >= {"LeaderWorkerSet"}
    s.same("GET", "/events?namespace=default&name=web")
    assert s.same("GET", "/logs/default/web-0")[2] == "hello from web-0\n"
    assert s.same("GET", "/logs/default/web-1")[0] == 404
    # Delete, then the cascade.
    assert s.same("DELETE", "/apis/lws/default/web")[2] == {"deleted": "lws/default/web"}
    s.settle()
    s.same("DELETE", "/apis/lws/default/web")
    assert s.same("DELETE", "/apis/nonsense/default/web")[0] == 404
    assert s.same("GET", "/apis/pods")[2] == []


def test_metrics_carry_the_same_reconcile_counts(servers):
    from lws_tpu.core import metrics as jmetrics

    s = servers
    s.same("POST", "/apply", LWS_YAML.encode())
    s.settle()
    fams = []
    for url in s.urls:
        code, ctype, text = call(url, "GET", "/metrics")
        assert code == 200 and ctype.startswith("text/plain"), (code, ctype)
        fams.append(jmetrics.parse_exposition(text))
    for family in ("lws_reconcile_total", "lws_rollout_progress"):
        want, got = (sorted((n, sorted(lab.items()), v) for n, lab, v, _ in
                            f.get(family, {}).get("samples", [])) for f in fams)
        assert want and got == want, family
    # OpenMetrics negotiation, as JAX's.
    for url in s.urls:
        code, ctype, text = call(url, "GET", "/metrics",
                                 headers={"Accept": "application/openmetrics-text"})
        assert code == 200 and "openmetrics" in ctype and text.endswith("# EOF\n")


def test_watch_bookmarks_long_polls_and_expiry(jax_planes_restored):
    s = Servers(watch_buffer=8)
    try:
        now = s.same("GET", "/watch?since=-1")[2]
        assert now == {"events": [], "next": 0}
        assert s.same("GET", "/watch?since=0&timeout=0.2")[2] == {"events": [], "next": 0}
        s.same("POST", "/apply", LWS_YAML.encode())
        s.settle()
        head = s.same("GET", "/watch?since=-1")[2]["next"]
        assert head > 8
        # A bookmark that fell out of the 8-event ring, and one from the
        # future (a restarted server): both must relist.
        assert s.same("GET", "/watch?since=1")[2] == {"expired": True, "next": head}
        assert s.same("GET", f"/watch?since={head + 5}")[2] == {"expired": True, "next": head}
        batch = s.same("GET", f"/watch?since={head - 3}")[2]
        assert [e["seq"] for e in batch["events"]] == [head - 2, head - 1, head]
        assert s.same("GET", "/watch?since=x")[0] == 400
    finally:
        s.close()


def test_the_left_out_routes_answer_404_on_the_port(servers):
    # Node maintenance, once left out, answers as JAX's: an unknown node is
    # a 404 naming it, a malformed body a 422 (the routes over real nodes:
    # tests/test_torch_maintenance.py).
    for path, body in (("/cordon/n1", b"{}"), ("/drain/n1", b"{}"),
                       ("/cordon/n1", b'{"unschedulable": "yes"}'), ("/cordon/n1", b"[]")):
        code, _, got = servers.same("POST", path, body)
        assert code in (404, 422) and got["error"] != "unknown path", (path, got)
    # The Autoscaler kind applies as JAX's does (the fleet and debug routes:
    # tests/test_torch_fleet.py).
    example = (REPO / "examples" / "autoscaler.yaml").read_bytes()
    assert servers.same("POST", "/apply", example)[:2] == (200, "application/json")
    assert servers.same("GET", "/apis/autoscalers/default/psum-autoscaler")[0] == 200


def test_deferred_options_fail_naming_their_roadmap_item(tmp_path):
    """No option is deferred any more; the name stays from when some were.
    A leader-elected ControlPlane builds its elector and gates its manager
    on it, and `serve --state-file --state-dir` fails with JAX's message
    (the options at work: tests/test_torch_wal.py,
    tests/test_torch_election.py, tests/test_torch_auth_certs.py)."""
    from lws_tpu_torch.runtime import ControlPlane

    cp = ControlPlane(leader_election=True, identity="a")
    assert cp.elector.identity == "a" and cp.manager.gate == cp.elector.is_leader
    argv = ["serve", "--state-file", str(tmp_path / "s.json"), "--state-dir", str(tmp_path)]
    errors = []
    for main in (jcli.main, pcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        errors.append(str(e.value))
    assert errors[1] == errors[0] == "error: --state-file and --state-dir are exclusive"


# ---------------------------------------------------------------------------
# The commands, against the same state.


# A normalized field in the JSON and the YAML that `get` prints, in either
# quoting: YAML single-quotes a uid whose 12 hex digits read as a number
# (all decimal digits: about 1 in 280 uuid4 draws).
UID = re.compile(r'("?)(uid|resourceVersion|last_transition_time)("?): '
                 r'''("[^"]*"|'[^']*'|[0-9a-f.]+)''')


# The age `events` prints in front of each line, from the normalized timestamp.
AGE = re.compile(r"(?m)^[0-9]+s\t")


def printed(main, argv, capsys) -> tuple:
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, AGE.sub("<age>\t", UID.sub(r'\1\2\3: <normalized>', out))


def test_the_commands_print_what_the_jax_package_prints(servers, capsys, tmp_path):
    s = servers
    path = tmp_path / "lws.yaml"
    path.write_text(LWS_YAML)
    ds = REPO / "examples" / "disaggregated-live-demo.yaml"
    steps = [
        ["apply", "-f", str(path)],
        ["apply", "-f", str(ds)],
        ["get", "pods"],
        ["get", "lws"],
        ["get", "DisaggregatedSet"],
        ["get", "lws", "web"],
        ["get", "lws", "web", "-o", "yaml"],
        ["scale", "web", "3"],
        ["get", "pods"],
        ["events"],
        ["events", "web", "-n", "default"],
        ["logs", "web-0"],
        ["logs", "web-1"],
        ["delete", "lws", "default", "web"],
        ["delete", "DisaggregatedSet", "default", "llmd-demo"],
        ["get", "pods"],
    ]
    for argv in steps:
        outs = []
        for main, url in ((jcli.main, s.urls[0]), (pcli.main, s.urls[1]),
                          (pcli.main, s.urls[0])):
            outs.append(printed(main, [*argv, "--server", url.split("//")[1]], capsys))
        assert outs[1] == outs[0], argv
        # The port's client against the JAX server prints the same too.
        assert outs[2][0] == outs[0][0], argv
        if argv[0] not in ("apply", "scale", "delete"):
            assert outs[2] == outs[0], argv
        s.settle()
    assert not any(state(PORT, s.both.sides[1][1])[k] for k in KINDS if k != "Node")


def test_the_commands_as_processes(servers):
    """`python -m lws_tpu_torch get` beside `python -m lws_tpu get`, as a
    user runs them."""
    s = servers
    s.same("POST", "/apply", LWS_YAML.encode())
    s.settle()
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    outs = []
    for pkg, url in (("lws_tpu", s.urls[0]), ("lws_tpu_torch", s.urls[1])):
        proc = subprocess.run([sys.executable, "-m", pkg, "get", "pods", "--server",
                               url.split("//")[1]], cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=120)
        outs.append((proc.returncode, proc.stdout))
    assert outs[1] == outs[0] and outs[0][0] == 0
    assert outs[0][1].count("phase=Running") == 4
    proc = subprocess.run([sys.executable, "-m", "lws_tpu_torch", "get", "pods", "--server",
                           "127.0.0.1:1"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1 and "cannot reach server" in proc.stderr
    assert "jax" not in proc.stderr
