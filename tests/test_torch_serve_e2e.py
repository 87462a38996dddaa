"""e2e: `python -m lws_tpu_torch serve` as a process (backend: local) runs two
deployments of the port's workers as real OS processes, on the CPU:

  * a DisaggregatedSet of `python -m lws_tpu_torch.serving.disagg_worker
    prefill|decode --device cpu` at tests/test_torch_disagg_e2e.py's sizes.
    Both roles are found through the port's API server (the `-prv` Service
    records). A prompt equals the single-engine oracle. The decode process
    is SIGKILLed: its pod goes Failed with one container restart, the group
    is recreated (a new pod uid), and a request submitted during the outage
    completes once the new pod is up (its bundle waited unacked on prefill)
    and equals its oracle. `python -m lws_tpu_torch delete` of the DS leaves
    no worker process.
  * a LeaderWorkerSet of size 2 running `python -m
    lws_tpu_torch.runtime.worker psum --device cpu` (the quick start's twin,
    over gloo): both members write their result.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import yaml

from lws_tpu_torch.client import RemoteClient
from lws_tpu_torch.parallel.launch import free_port
from lws_tpu_torch.serving import kv_transport as kt
from lws_tpu_torch.serving.disagg_worker import build_engine
from tests.test_torch_disagg_e2e import DECODE_STEPS, MAX_LEN, free_ports

REPO = Path(__file__).resolve().parent.parent
PID_ANNOTATION = "local.lws.tpu/pid"
PROMPTS = {"first": [5, 9, 2, 11, 7], "outage": [3, 14, 15, 9, 2, 6]}


def pid_alive(pid: int) -> bool:
    """A live process (an exited child its parent has not reaped is not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def poll(fn, deadline: float, what: str, serve=None, interval: float = 0.2):
    while time.monotonic() < deadline:
        got = fn()
        if got is not None and got is not False:
            return got
        if serve is not None:
            serve.alive()
        time.sleep(interval)
    pytest.fail(f"timed out waiting for {what}" + (f"\n{serve.log()[-3000:]}" if serve else ""))


def role(name: str, kv_port: int, api: str) -> dict:
    """One role of the DS: an LWS of size 1 running the port's worker."""
    return {"name": name, "replicas": 1, "template": {"spec": {"leaderWorkerTemplate": {
        "size": 1, "workerTemplate": {"spec": {"containers": [{
            "name": name,
            "command": [sys.executable, "-m", "lws_tpu_torch.serving.disagg_worker", name,
                        "--steps", str(DECODE_STEPS), "--max-len", str(MAX_LEN),
                        "--device", "cpu"],
            "env": [{"name": "LWS_TPU_KV_PORT", "value": str(kv_port)},
                    {"name": "LWS_TPU_API", "value": api},
                    {"name": "LWS_TPU_KV_CHUNK", "value": "2"}]}]}}}}}}


class Serve:
    """`python -m lws_tpu_torch serve` as a process, with its log."""

    def __init__(self, tmp: Path, port: int, manifests: list[dict]) -> None:
        self.port = port
        self.url = f"http://127.0.0.1:{self.port}"
        cfg = tmp / "config.yaml"
        cfg.write_text("apiVersion: config.lws.tpu/v1alpha1\nkind: Configuration\n"
                       "backend: local\nenableScheduler: false\n")
        mf = tmp / "deploy.yaml"
        mf.write_text(yaml.safe_dump_all(manifests, sort_keys=False))
        self.log_path = tmp / "serve.log"
        self._log = open(self.log_path, "w")
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "lws_tpu_torch", "serve", "--config", str(cfg), "-f",
             str(mf), "--port", str(self.port)],
            cwd=REPO, env=env, stdout=self._log, stderr=subprocess.STDOUT)
        self.client = RemoteClient(self.url)

    def log(self) -> str:
        return self.log_path.read_text()

    def alive(self) -> None:
        assert self.proc.poll() is None, f"serve exited {self.proc.returncode}:\n{self.log()}"

    def pods(self) -> list[dict]:
        try:
            return self.client.list("Pod")
        except OSError:
            return []

    def discover(self, ds: str, role: str):
        """`role`'s KV endpoint through the DS's -prv Service, as the decode
        worker finds prefill's; None until the API server answers."""
        try:
            return kt.discover_role_endpoint(self.client, "default", ds, role)
        except OSError:
            return None

    def watch(self, since: int, timeout: float = 1.0) -> dict:
        with urllib.request.urlopen(f"{self.url}/watch?since={since}&timeout={timeout}",
                                    timeout=30) as resp:
            return json.loads(resp.read().decode())

    def cli(self, *argv: str) -> subprocess.CompletedProcess:
        return subprocess.run([sys.executable, "-m", "lws_tpu_torch", *argv, "--server",
                               f"127.0.0.1:{self.port}"], cwd=REPO, capture_output=True,
                              text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()


@pytest.fixture(scope="module")
def oracles():
    engine = build_engine(batch=1, max_len=MAX_LEN, device="cpu")
    return {rid: engine.generate(np.array(p, dtype=np.int32).reshape(1, -1),
                                 max_new_tokens=DECODE_STEPS + 1).tokens
            for rid, p in PROMPTS.items()}


def submit(ep, rid: str, deadline: float) -> None:
    """The pod is Ready once its process lives, which can precede the KV
    port's bind: dial with retries, as a client behind a Service would."""
    def attempt():
        try:
            kt.submit_prompt(ep, rid, kt.arrays_to_bytes(
                prompt=np.array(PROMPTS[rid], dtype=np.int32)))
            return True
        except OSError:
            return None
    poll(attempt, deadline, f"prefill to accept {rid}")


def result(ep, rid: str, deadline: float, serve: Serve):
    def attempt():
        try:
            got = kt.pull_result(ep, rid)
        except OSError:
            return None
        return None if got is None else kt.bytes_to_arrays(got[1])["tokens"]
    return poll(attempt, deadline, f"the result of {rid}", serve)


def test_serve_deploys_the_port_workers_and_recreates_a_killed_group(tmp_path, oracles):
    prefill_port, decode_port = free_ports(2)
    port = free_port()
    api = f"http://127.0.0.1:{port}"
    psum_files = [tmp_path / "psum-0.txt", tmp_path / "psum-0-1.txt"]
    manifests = [
        {"apiVersion": "lws.tpu/v1", "kind": "DisaggregatedSet", "metadata": {"name": "pair"},
         "spec": {"roles": [role("prefill", prefill_port, api),
                            role("decode", decode_port, api)]}},
        {"apiVersion": "lws.tpu/v1", "kind": "LeaderWorkerSet", "metadata": {"name": "psum"},
         "spec": {"replicas": 1, "leaderWorkerTemplate": {"size": 2, "workerTemplate": {
             "spec": {"containers": [{
                 "name": "worker",
                 "command": [sys.executable, "-m", "lws_tpu_torch.runtime.worker", "psum",
                             "--device", "cpu"],
                 "env": [{"name": "LWS_TPU_RESULT_FILE",
                          "value": str(tmp_path / "$(POD_NAME).txt")},
                         # A free coordinator port: the contract's 8471 is the
                         # one the JAX package's e2e tests bind.
                         {"name": "JAX_COORDINATOR_ADDRESS",
                          "value": f"psum-0:{free_port()}"}]}]}}}}},
    ]
    serve = Serve(tmp_path, port, manifests)
    pids = set()
    try:
        deadline = time.monotonic() + 150
        eps = {r: poll(lambda r=r: serve.discover("pair", r), deadline,
                       f"the {r} -prv endpoint", serve)
               for r in ("prefill", "decode")}
        assert eps == {"prefill": ("127.0.0.1", prefill_port),
                       "decode": ("127.0.0.1", decode_port)}
        pre = next(p for p in serve.pods() if "-prefill-" in p["metadata"]["name"])
        dec = next(p for p in serve.pods() if "-decode-" in p["metadata"]["name"])
        pids |= {int(p["metadata"]["annotations"][PID_ANNOTATION]) for p in (pre, dec)}
        submit(eps["prefill"], "first", deadline)
        np.testing.assert_array_equal(result(eps["decode"], "first", deadline, serve),
                                      oracles["first"])
        # The psum group ran alongside: both members wrote their result.
        poll(lambda: all(f.exists() for f in psum_files), deadline, "the psum results", serve)
        for f in psum_files:
            assert "total=3.0 expected=3.0 ok=True" in f.read_text(), f.read_text()

        # SIGKILL the decode process: the whole group is recreated.
        since = serve.watch(-1)["next"]
        old_uid, old_pid = dec["metadata"]["uid"], int(dec["metadata"]["annotations"][PID_ANNOTATION])
        os.kill(old_pid, signal.SIGKILL)
        poll(lambda: not pid_alive(old_pid) or None, deadline, "the decode process to die")
        submit(eps["prefill"], "outage", deadline)
        failed = []

        def saw_failure():
            nonlocal since
            batch = serve.watch(since)
            since = batch.get("next", since)
            failed.extend(e for e in batch.get("events", [])
                          if e["object"]["kind"] == "Pod"
                          and e["object"]["metadata"]["uid"] == old_uid
                          and (e["object"].get("status") or {}).get("phase") == "Failed")
            return failed or None

        poll(saw_failure, deadline, "the killed pod to go Failed", serve, interval=0)
        assert failed[0]["object"]["status"]["container_restarts"] == 1, failed[0]
        new = poll(lambda: (lambda p: p if p and p["metadata"]["uid"] != old_uid
                            and (p.get("status") or {}).get("ready") else None)(
            next((p for p in serve.pods() if "-decode-" in p["metadata"]["name"]), None)),
            deadline, "the recreated decode pod", serve)
        assert new["metadata"]["name"] == dec["metadata"]["name"]
        pids.add(int(new["metadata"]["annotations"][PID_ANNOTATION]))
        np.testing.assert_array_equal(result(eps["decode"], "outage", deadline, serve),
                                      oracles["outage"])
        logs = serve.cli("logs", new["metadata"]["name"])
        assert logs.returncode == 0 and "[decode] finished outage" in logs.stdout, logs
        assert "finished first" not in logs.stdout

        listed = serve.cli("get", "Pod")
        assert listed.returncode == 0, listed.stderr
        names = sorted(line.split("\t")[0] for line in listed.stdout.splitlines())
        assert names == sorted(f"default/{p['metadata']['name']}" for p in serve.pods())
        assert sum("pair-" in n for n in names) == 2
        ds = serve.cli("get", "DisaggregatedSet")
        assert ds.returncode == 0 and ds.stdout.split("\t")[0] == "default/pair", ds

        gone = serve.cli("delete", "DisaggregatedSet", "default", "pair")
        assert gone.returncode == 0 and json.loads(gone.stdout) == {
            "deleted": "DisaggregatedSet/default/pair"}, gone
        workers = {int(p["metadata"]["annotations"][PID_ANNOTATION]) for p in (pre, new)}
        poll(lambda: not any(pid_alive(p) for p in workers) or None,
             time.monotonic() + 60, "the workers to exit after the delete", serve)
        assert not [p for p in serve.pods() if p["metadata"]["name"].startswith("pair-")]
    finally:
        serve.stop()
        for pid in pids:
            if pid_alive(pid):
                os.kill(pid, signal.SIGKILL)
    assert not [p for p in pids if pid_alive(p)]
