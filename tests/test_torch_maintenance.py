"""The port's node maintenance and rollout planner commands (the API
server's `POST /cordon/{node}` and `POST /drain/{node}`, and `python -m
lws_tpu_torch cordon|drain|plan-steps`) against the JAX package's, on the
CPU.

- cordon and drain: a JAX and a port control plane (the scheduler on,
  gang-scheduled groups over two v5e slices of 2x4 hosts, pods bound
  before they run) behind their API servers. Every step goes to both,
  through the HTTP routes or the commands; the answers and the printed
  output must be equal, and after every step each kind's manifests and the
  recorded events (tests/test_torch_control_plane.py's `Both`, its
  normalization: `uid`, `resourceVersion`, `last_transition_time`).
- plan-steps: the stdout and exit code of each table case are byte-equal.
- install: tests/test_torch_auth_certs.py.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from lws_tpu import cli as jcli
from lws_tpu.runtime.server import ApiServer as JApiServer
from lws_tpu_torch import cli as pcli
from lws_tpu_torch.runtime.server import ApiServer as PApiServer
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_control_plane import Both, add_fleet, apply_doc
from tests.test_torch_fleet import port_planes_restored  # noqa: F401
from tests.test_torch_wal import lws_doc

# Every test here leaves both packages' process planes as it found them.
pytestmark = pytest.mark.usefixtures("jax_planes_restored", "port_planes_restored")


@pytest.fixture(autouse=True)
def no_cli_credentials(monkeypatch):
    for c in (pcli, jcli):
        monkeypatch.setattr(c, "_TOKEN", None)
        monkeypatch.setattr(c, "_TLS_CONTEXT", None)


class Maintained:
    """Both planes over two slices, one gang-scheduled LWS of two groups
    (each two hosts of 4 chips), behind their API servers."""

    def __init__(self) -> None:
        self.both = Both(enable_scheduler=True, require_binding=True, scheduler_provider="gang")
        self.both.do(lambda side, cp: add_fleet(side, cp, slices=2))
        doc = lws_doc(replicas=2, size=2)
        doc["spec"]["leaderWorkerTemplate"]["workerTemplate"]["spec"]["containers"][0][
            "resources"] = {"limits": {"google.com/tpu": 4}}
        self.both.do(apply_doc(doc))
        self.servers = []
        for (_, cp), Server in zip(self.both.sides, (JApiServer, PApiServer)):
            srv = Server(cp, port=0)
            srv.start()
            self.servers.append(srv)

    def post(self, path: str, body: bytes = b"{}"):
        """One POST to both servers, the planes settled after it; the
        answers (code and body) must be equal."""
        got = []
        for srv in self.servers:
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=body,
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    got.append((r.status, json.loads(r.read().decode())))
            except urllib.error.HTTPError as e:
                got.append((e.code, json.loads(e.read().decode())))
        assert got[1] == got[0], path
        self.both.do(lambda side, cp: None)
        return got[0]

    def command(self, capsys, *argv):
        """One command of each CLI against its server, the planes settled
        after it; exit codes and stdout must be equal."""
        got = []
        for main, srv in ((jcli.main, self.servers[0]), (pcli.main, self.servers[1])):
            try:
                rc = main([*argv, "--server", f"127.0.0.1:{srv.port}"])
            except SystemExit as e:
                rc = str(e.code)
            got.append((rc, capsys.readouterr().out))
        assert got[1] == got[0], argv
        self.both.do(lambda side, cp: None)
        return got[0]

    def hosting(self, pod: str = "sample-0") -> str:
        return self.both.read(lambda side, cp: cp.store.get("Pod", "default", pod).spec.node_name)

    def nodes(self) -> dict:
        return self.both.read(lambda side, cp: {
            n.meta.name: n.spec.unschedulable for n in cp.store.list("Node")})

    def pods(self) -> list:
        return self.both.read(lambda side, cp: sorted(
            (p.meta.name, p.spec.node_name, p.status.phase.value) for p in cp.store.list("Pod")))

    def close(self) -> None:
        for srv in self.servers:
            srv.stop()


@pytest.fixture
def planes():
    m = Maintained()
    yield m
    m.close()


def test_http_cordon_and_drain_endpoints(planes):
    """tests/test_config_cli_api.py's route case on both packages."""
    m = planes
    host = m.hosting()
    assert host and all(node for _, node, _ in m.pods())
    code, out = m.post(f"/drain/{host}")
    assert code == 200 and out["node"] == host and "sample" in " ".join(out["evicted"])
    # The group is recreated away from the drained node.
    assert all(node != host for _, node, _ in m.pods())
    assert m.nodes()[host] is True

    code, out = m.post(f"/cordon/{host}", json.dumps({"unschedulable": False}).encode())
    assert code == 200 and out == {"node": host, "unschedulable": False}
    assert m.nodes()[host] is False
    assert m.post("/cordon/" + host)[1] == {"node": host, "unschedulable": True}
    assert m.post("/drain/ghost")[0] == 404
    assert m.post("/cordon/ghost")[0] == 404
    # A string "false" is refused, not coerced to True; so is a non-object.
    assert m.post(f"/cordon/{host}", json.dumps({"unschedulable": "false"}).encode())[0] == 422
    assert m.post(f"/cordon/{host}", b"[1, 2]")[0] == 422
    assert m.post(f"/cordon/{host}", b"not json")[0] == 422
    # The group that was pending while the node was cordoned came back to
    # it; a second drain evicts it again, and one more finds nothing.
    assert m.post(f"/drain/{host}")[0] == 200
    assert all(node != host for _, node, _ in m.pods())
    assert m.post(f"/drain/{host}")[1] == {"node": host, "evicted": []}


def test_the_cordon_and_drain_commands(planes, capsys):
    m = planes
    host = m.hosting("sample-1")
    rc, out = m.command(capsys, "cordon", host)
    assert rc == 0 and json.loads(out) == {"node": host, "unschedulable": True}
    # A cordoned node keeps its pods; a drained one loses them.
    assert any(node == host for _, node, _ in m.pods())
    rc, out = m.command(capsys, "drain", host)
    assert rc == 0 and json.loads(out)["evicted"]
    assert all(node != host for _, node, _ in m.pods())
    rc, out = m.command(capsys, "cordon", host, "--uncordon")
    assert rc == 0 and json.loads(out) == {"node": host, "unschedulable": False}
    assert m.nodes()[host] is False
    rc, _ = m.command(capsys, "drain", "ghost")
    assert rc != 0


@pytest.mark.parametrize("argv", [
    ("--initial", "2,2", "--target", "2,2"),
    ("--initial", "4,4", "--target", "4,4", "--surge", "1,1"),
    ("--initial", "4,2", "--target", "6,3", "--surge", "2,1", "--unavailable", "1,0"),
    ("--initial", "3,5,2", "--target", "1,2,4"),
    ("--initial", "8,8", "--target", "8,8", "--unavailable", "2,2"),
    ("--initial", "0,0", "--target", "3,3"),
    ("--initial", "5", "--target", "0"),
    ("--initial", "2,2", "--target", "2,2,2"),
], ids=lambda a: " ".join(a))
def test_plan_steps_prints_jax_s_table(argv, capsys):
    got = []
    for main in (jcli.main, pcli.main):
        rc = main(["plan-steps", *argv])
        out = capsys.readouterr()
        got.append((rc, out.out, out.err))
    assert got[1] == got[0]
    if len(argv[1].split(",")) == len(argv[3].split(",")):
        assert got[0][0] == 0 and got[0][1].startswith("step  ")
