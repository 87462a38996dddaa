"""The port's `loadgen` command (lws_tpu_torch/cli.py, `python -m
lws_tpu_torch loadgen`) against the JAX package's (`lws_tpu.cli.main`),
in-process on the CPU: the scenario listing byte for byte, the usage
errors' exit codes, a `--spec` run's header line and report, the history
block from `--server`, the requests a `revision_bump` stanza sends to a
live API server, and the refusal to run on the CPU without `--device cpu`.
Then one live run with nothing stubbed: the command as a process against
a pair of the port's disaggregated workers under the JAX control plane and
its ApiServer, whose /metrics/fleet the run samples and reports."""

import copy
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from lws_tpu import cli as jcli
from lws_tpu import loadgen as jloadgen
from lws_tpu.core import flightrecorder as jfr
from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import slo as jslo
from lws_tpu.core import trace as jtrace
from lws_tpu.obs import decisions as jdecisions
from lws_tpu.obs import device as jdevice
from lws_tpu.obs import history as jhistory
from lws_tpu.obs import journey as jjourney
from lws_tpu.obs import recommend as jrecommend
from lws_tpu.obs import rollout as jrollout
from lws_tpu_torch import cli, loadgen
from lws_tpu_torch.core import flightrecorder, metrics, slo, trace
from lws_tpu_torch.obs import journey

REPO = Path(__file__).resolve().parents[1]

# A few requests of steady_poisson's shape (two classes, fixed output
# lengths) at a shorter horizon.
SPEC = {
    "name": "tiny", "horizon_s": 0.6, "max_len": 64, "vocab": 256,
    "arrivals": {"process": "poisson", "rate_rps": 12.0},
    "classes": [
        {"name": "chat", "weight": 0.75, "prompt_len": {"kind": "uniform", "lo": 4, "hi": 12},
         "output_len": 6, "targets": {"ttft_s": 30.0, "itl_s": 30.0, "queue_wait_s": 30.0}},
        {"name": "batch", "weight": 0.25, "prompt_len": {"kind": "uniform", "lo": 12, "hi": 24},
         "output_len": 10, "targets": {"ttft_s": 30.0, "itl_s": 30.0, "queue_wait_s": 30.0}},
    ],
}


@pytest.fixture(autouse=True)
def fresh_process_defaults(monkeypatch):
    """Each package's process-default telemetry swapped for fresh objects
    (the engines report into them, `install_class_targets` writes class
    targets there), the JAX compile ledger's listener kept out, and each
    CLI's token and TLS context unset: the in-process runs leave no state
    for a later test. Each package's `journey._INSTALLED` is put back too:
    an ApiServer started here wires the journey feeds onto the fresh
    objects and sets it, and left set it makes a later `journey.install()`
    in the same process a no-op while the real tracer has no feed."""
    for m, s, t, fr, j in ((metrics, slo, trace, flightrecorder, journey),
                           (jmetrics, jslo, jtrace, jfr, jjourney)):
        monkeypatch.setattr(m, "REGISTRY", m.MetricsRegistry())
        monkeypatch.setattr(s, "RECORDER", s.SLORecorder())
        monkeypatch.setattr(t, "TRACER", t.Tracer())
        monkeypatch.setattr(fr, "RECORDER", fr.FlightRecorder())
        monkeypatch.setattr(j, "_INSTALLED", j._INSTALLED)
    monkeypatch.setattr(jdevice.LEDGER, "_enabled", False)
    for c in (cli, jcli):
        monkeypatch.setattr(c, "_TOKEN", None)
        monkeypatch.setattr(c, "_TLS_CONTEXT", None)


def run_both(capsys, argv: list, port_extra=("--device", "cpu")) -> dict:
    """{"port"|"jax": (rc, stdout, stderr)} of one argv through each CLI."""
    out = {}
    for name, main, extra in (("port", cli.main, list(port_extra)), ("jax", jcli.main, [])):
        rc = main(argv + extra)
        got = capsys.readouterr()
        out[name] = (rc, got.out, got.err)
    return out


class Instant:
    """A target that serves each request at once (the command's plumbing
    around the run does not depend on the engine)."""

    engine = SimpleNamespace(device=torch.device("cpu"))

    def submit(self, req, arrival_wall_t):
        return req.index

    def step(self):
        time.sleep(0.001)

    def poll(self, handle):
        return {"n_tokens": 3, "ttft_after_admit_wall_s": 0.0}


@pytest.fixture
def instant_targets(monkeypatch):
    for lg in (loadgen, jloadgen):
        monkeypatch.setattr(lg, "build_local_target", lambda *a, **k: Instant())


class Stub:
    """An HTTP server that answers from `routes` ({(method, path): body or
    callable}) and records every request as (method, path, JSON body)."""

    def __init__(self, routes: dict) -> None:
        self.requests: list = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _answer(self, method: str) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else None
                stub.requests.append((method, self.path, body))
                got = routes.get((method, self.path))
                if got is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                data = got() if callable(got) else got
                data = data.encode() if isinstance(data, str) else json.dumps(data).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — the http.server hook
                self._answer("GET")

            def do_POST(self):  # noqa: N802
                self._answer("POST")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.addr = f"127.0.0.1:{self.httpd.server_port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def test_loadgen_list_prints_what_jax_prints(capsys):
    got = run_both(capsys, ["loadgen", "--list"], port_extra=())
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0
    assert [ln.split(":")[0] for ln in got["port"][1].splitlines()] == loadgen.scenario_names()


@pytest.mark.parametrize("argv", [
    ["loadgen"],
    ["loadgen", "steady_poisson", "--prefill", "127.0.0.1:1"],
    ["loadgen", "steady_poisson", "--decode", "127.0.0.1:1"],
], ids=["no-scenario", "prefill-without-decode", "decode-without-prefill"])
def test_usage_errors_exit_2_as_in_jax(capsys, argv):
    got = run_both(capsys, argv, port_extra=())
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2 and got["port"][2].startswith("error: ")


def test_a_spec_run_matches_jax(tmp_path, capsys):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(SPEC))
    got = run_both(capsys, ["loadgen", "--spec", str(path), "--seed", "3", "--target", "paged",
                            "--max-wall", "60", "--json"])
    schedule = loadgen.build_schedule(SPEC, 3)
    reports = {}
    for name, (rc, out, _) in got.items():
        assert rc == 0
        header, body = out.split("\n", 1)
        reports[name] = (header, json.loads(body))
    # The header line: describe_scenario and the 12-character digest.
    assert reports["port"][0] == reports["jax"][0] == (
        f"# {loadgen.describe_scenario(SPEC, schedule)} (seed 3, schedule "
        f"{loadgen.schedule_digest(schedule)[:12]})")
    port, jax_ = reports["port"][1], reports["jax"][1]
    assert port.keys() == jax_.keys()
    assert port["classes"].keys() == jax_["classes"].keys() == {"chat", "batch"}
    for klass, stats in port["classes"].items():
        want = jax_["classes"][klass]
        assert stats.keys() == want.keys()
        assert (stats["count"], stats["completed"]) == (want["count"], want["completed"])
        # The spec's output lengths are fixed and neither engine stops a
        # stream early (no stop token), so the token counts match too;
        # latencies differ (other weights, other framework).
        n = sum(r.max_new_tokens for r in schedule if r.klass == klass)
        assert stats["completed"] == stats["count"] and stats["tokens"] == want["tokens"] == n
    assert (port["scenario"], port["seed"]) == (jax_["scenario"], jax_["seed"]) == ("tiny", 3)
    # No kernel ran on the CPU, so no launch line: stderr stays JAX's.
    assert "kernel launches" not in got["port"][2]


def test_the_engine_launch_line_reads_the_engine_and_the_counts():
    target = loadgen.build_local_target("paged", SPEC, device="cpu")
    schedule = loadgen.build_schedule(SPEC, 3)
    loadgen.run_schedule(schedule, target, max_wall_s=60)
    head, _, counts = cli.engine_launch_line(target).partition("; kernel launches ")
    assert head.startswith("# paged engine ")
    facts = json.loads(head[len("# paged engine "):])
    eng = target.engine
    assert facts == {"n_layers": 2, **eng.stats, **eng.stats_prefix}
    assert facts["decode_steps"] > 0
    # The CPU runs the plain versions: no wrapper counted a launch.
    launches = json.loads(counts)
    assert launches.keys() == {"flash_attention", "paged_decode_attention",
                               "paged_decode_attention_int8", "int8_matmul",
                               "int8_decode_attention"} and set(launches.values()) == {0}


def stub_fleet_text() -> str:
    """tests/test_loadgen.py:576-627's /metrics/fleet: one chat series that
    grows with every scrape, 90 % of its tokens on time."""
    stub_fleet_text.hits += 1
    n = stub_fleet_text.hits
    return ("# HELP serving_tokens_total t\n# TYPE serving_tokens_total counter\n"
            f'serving_tokens_total{{engine="disagg",klass="chat",instance="w0"}} {100.0 * n}\n'
            "# HELP serving_goodput_tokens_total g\n"
            "# TYPE serving_goodput_tokens_total counter\n"
            f'serving_goodput_tokens_total{{engine="disagg",klass="chat",instance="w0"}} '
            f"{90.0 * n}\n")


stub_fleet_text.hits = 0


def history_rows(frame: str) -> set:
    lines = frame.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("HISTORY"))
    return {ln.split()[0] for ln in lines[start + 1:]
            if ln and not ln.startswith(("recommendation @", "CANARY", "closed loop"))}


def test_server_appends_the_history_block_as_jax_does(capsys, instant_targets):
    stub = Stub({("GET", "/metrics/fleet"): stub_fleet_text})
    try:
        got = run_both(capsys, ["loadgen", "steady_poisson", "--seed", "3", "--max-wall", "60",
                                "--server", stub.addr])
    finally:
        stub.close()
    rows = {}
    for name, (rc, out, _) in got.items():
        assert rc == 0
        assert "recommendation @" in out and "fleet: GOODPUT%=90%" in out
        rows[name] = history_rows(out)
    assert rows["port"] == rows["jax"] == {"disagg/chat"}


def test_server_json_report_has_the_keys_jax_gives(capsys, instant_targets):
    stub = Stub({("GET", "/metrics/fleet"): stub_fleet_text})
    try:
        got = run_both(capsys, ["loadgen", "steady_poisson", "--seed", "3", "--max-wall", "60",
                                "--server", stub.addr, "--json"])
    finally:
        stub.close()
    reports = {name: json.loads(out.split("\n", 1)[1]) for name, (rc, out, _) in got.items()
               if rc == 0}
    assert reports["port"].keys() == reports["jax"].keys() and "history" in reports["port"]
    assert reports["port"]["history"].keys() == reports["jax"]["history"].keys()
    assert set(reports["port"]["history"]["classes"]) == {"disagg/chat"}


LWS = [{"metadata": {"namespace": ns, "name": name},
        "spec": {"leader_worker_template": {
            "worker_template": {"spec": {"containers": [
                {"name": "w", "env": [{"name": "LWS_TPU_CANARY_STAGE", "value": "stable"},
                                      {"name": "KEEP", "value": "1"}]}]}},
            "leader_template": None}}}
       for ns, name in (("default", "zeta"), ("default", "alpha"))]


def test_revision_bump_sends_what_jax_sends(capsys, instant_targets):
    sent = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        stub = Stub({("GET", "/apis/leaderworkersets"): copy.deepcopy(LWS),
                     ("POST", "/apply"): {}})
        try:
            assert main(["loadgen", "rolling_update", "--seed", "5", "--max-wall", "60",
                         "--server", stub.addr] + extra) == 0
            deadline = time.time() + 10  # the apply runs on its own thread
            while time.time() < deadline and not any(m == "POST" for m, _, _ in
                                                     stub.requests):
                time.sleep(0.05)
        finally:
            stub.close()
        err = capsys.readouterr().err
        assert "# revision bump applied to default/alpha at t>=1s " \
               "(LWS_TPU_CANARY_STAGE=canary)" in err, err
        sent[name] = [r for r in stub.requests if r[1] != "/metrics/fleet"]
    assert sent["port"] == sent["jax"]
    get, post = sent["port"]
    assert get == ("GET", "/apis/leaderworkersets", None)
    env = post[2]["spec"]["leader_worker_template"]["worker_template"]["spec"]["containers"][0]
    assert post[:2] == ("POST", "/apply") and post[2]["metadata"]["name"] == "alpha"
    assert env["env"] == [{"name": "KEEP", "value": "1"},
                          {"name": "LWS_TPU_CANARY_STAGE", "value": "canary"}]


def test_without_a_card_the_command_raises_rather_than_run_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["loadgen", "shared_prefix", "--seed", "0"])
    assert capsys.readouterr().out.startswith("# shared_prefix: poisson over 1.5s")


# ---------------------------------------------------------------------------
# Live: the command as a process against the port's pair under the JAX
# control plane


def _guarded(obj, names) -> dict:
    with obj._lock:
        return copy.deepcopy({n: getattr(obj, n) for n in names})


def _restore(obj, state: dict) -> None:
    with obj._lock:
        for n, v in state.items():
            setattr(obj, n, v)


@pytest.fixture
def jax_planes_restored():
    """The JAX package's process-global planes that an ApiServer's
    /metrics/fleet drives are left as found: the process HISTORY it ingests
    into (with its interval gate), the rollout LEDGER a ControlPlane feeds,
    the DECISIONS ledger, and the default ANALYZER, RECOMMENDER and
    actuators that each fresh ingest evaluates."""
    state = [(obj, _guarded(obj, names)) for obj, names in (
        (jhistory.HISTORY, ("_series", "_per_source", "_last_ingest_t", "_last_ingest_keys",
                            "_dropped")),
        (jrollout.LEDGER, ("_entries", "_per_kind", "_state")),
        (jdecisions.DECISIONS, ("_records", "_by_id", "_seq", "_last_direction",
                                "_last_sig")),
    )]
    defaults = [(m, n, getattr(m, n)) for m, n in (
        (jrollout, "ANALYZER"), (jrecommend, "RECOMMENDER"), (jdecisions, "ACTUATOR"),
        (jdecisions, "ROLLOUT_ACTUATOR"))]
    yield
    for obj, saved in state:
        _restore(obj, saved)
    for m, n, v in defaults:
        setattr(m, n, v)


def fleet_counts(url: str):
    """(the prefill role's TTFT count, the decode role's ITL count) on the
    API server's /metrics/fleet."""
    from tests.test_torch_disagg_telemetry_e2e import http

    code, text = http(f"{url}/metrics/fleet")
    if code != 200:
        return None
    fams = jmetrics.parse_exposition(text)

    def count(family: str, role: str) -> float:
        return sum(v for name, labels, v, _ in fams.get(family, {}).get("samples", [])
                   if name == family + "_count" and labels.get("role") == role
                   and labels.get("engine") == "disagg")

    return count("serving_ttft_seconds", "prefill"), count("serving_itl_seconds", "decode")


# The pair's budgets (tests/test_torch_disagg_telemetry_e2e.py): prompts of
# at most DECODE_MAX_LEN - DECODE_STEPS - 1 = 9 tokens.
PAIR_SPEC = {
    "name": "pair", "horizon_s": 0.8, "max_len": 16, "vocab": 256,
    "arrivals": {"process": "poisson", "rate_rps": 8.0},
    "classes": [{"name": "chat", "prompt_len": {"kind": "uniform", "lo": 3, "hi": 9},
                 "output_len": 6}],
}


def test_loadgen_command_drives_the_port_pair_under_the_api_server(tmp_path,
                                                                    jax_planes_restored):
    from tests.test_torch_disagg_telemetry_e2e import Pair, http, poll

    path = tmp_path / "pair.json"
    path.write_text(json.dumps(PAIR_SPEC))
    n = len(loadgen.build_schedule(PAIR_SPEC, 3))
    pair = Pair(tmp_path, chunk="0")
    try:
        pair.request("warm", np.array([5, 9, 2, 11, 7], dtype=np.int32))
        before = poll(lambda: (lambda c: c if c and min(c) >= 1 else None)(
            fleet_counts(pair.url)), pair.deadline, "both roles' warm-up ledgers", pair.backend)
        proc = subprocess.run(
            [sys.executable, "-m", "lws_tpu_torch", "loadgen", "--spec", str(path), "--seed",
             "3", "--prefill", "%s:%d" % pair.ep["prefill"], "--decode",
             "%s:%d" % pair.ep["decode"], "--server", pair.url, "--json", "--max-wall", "120"],
            cwd=REPO, capture_output=True, text=True, timeout=240,
            env={**os.environ, "PYTHONPATH": str(REPO)})
        assert proc.returncode == 0, proc.stderr[-3000:]
        header, body = proc.stdout.split("\n", 1)
        assert header.startswith("# pair: poisson over 0.8s, classes [chat], %d requests" % n)
        report = json.loads(body)
        assert report["all"]["count"] == report["all"]["completed"] == n
        assert "disagg/chat" in report["history"]["classes"], report["history"]
        # The fleet block the text frame renders, folded from the same
        # surface the command read (its --json report is JAX's, without it).
        code, text = http(f"{pair.url}/metrics/fleet")
        assert code == 200 and "fleet" not in report
        assert loadgen.fold_fleet(metrics.parse_exposition(text))["goodput"] is not None
        # Both roles' ledgers, read back through the fleet view, moved by
        # exactly the requests the run completed.
        want = (before[0] + n, before[1] + n)
        after = poll(lambda: (lambda c: c if c and c[0] >= want[0] and c[1] >= want[1]
                              else None)(fleet_counts(pair.url)),
                     pair.deadline, "the fleet view of the run's requests", pair.backend)
        assert after == want
    finally:
        pair.close()
