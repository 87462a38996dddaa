"""e2e: the port's disaggregated workers' telemetry plane under the JAX
control plane, on the CPU: the twin of tests/test_e2e_disagg.py:306-420.

Each role's pod declares `LWS_TPU_METRICS_PORT` (the decode role also
`LWS_TPU_PROFILE_HZ`). The JAX ApiServer's fleet collector scrapes both
port workers: /metrics/fleet carries the prefill leg's TTFT and the decode
leg's ITL under distinct instances, with trace exemplars;
`/debug/request/req1` fleet-joins a completed prefill leg whose `kv.gather`
span comes from the prefill instance (the monolithic path's finish-after-
gather order). `POST /debug/faults` arms a decode failure live: the
raise leaves that bundle unacked, it is redelivered, and the request
completes equal to the single-engine oracle with one trip. A poison bundle
(more rows than the decode role's max_len) ends its request errored, and
its journey is kept as such. `POST /debug/drain` ends the prefill worker
with code 0.

At `LWS_TPU_TP=2` (gloo) only tp rank 0 of each role listens on the
telemetry port, and a streamed handoff's chunk timelines annotate both
legs' journeys."""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from lws_tpu.api.disagg import (
    DS_ROLE_LABEL_KEY,
    DisaggregatedRoleSpec,
    DisaggregatedSet,
    DisaggregatedSetSpec,
    LeaderWorkerSetTemplateSpec,
)
from lws_tpu.api.pod import Container, EnvVar, PodSpec, PodTemplateSpec
from lws_tpu.api.types import LeaderWorkerSetSpec, LeaderWorkerTemplate
from lws_tpu.core.metrics import parse_exposition
from lws_tpu.core.store import new_meta
from lws_tpu.runtime import ControlPlane
from lws_tpu.runtime.server import ApiServer
from lws_tpu_torch.client import RemoteClient
from lws_tpu_torch.serving import kv_transport as kt
from tests.test_e2e_local import make_backend
from tests.test_torch_disagg_e2e import DECODE_STEPS, MAX_LEN, free_ports, oracle  # noqa: F401
from tests.test_torch_disagg_tp_e2e import DECODE_MAX_LEN, POISON, alive, children, wait_result


def role_spec(role: str, kv_port: int, metrics_port: int, api_url: str, chunk: str,
              tp: int) -> DisaggregatedRoleSpec:
    max_len = MAX_LEN if role == "prefill" else DECODE_MAX_LEN
    command = [sys.executable, "-m", "lws_tpu_torch.serving.disagg_worker", role,
               "--steps", str(DECODE_STEPS), "--max-len", str(max_len), "--device", "cpu"]
    env = [EnvVar("LWS_TPU_KV_PORT", str(kv_port)), EnvVar("LWS_TPU_API", api_url),
           EnvVar("LWS_TPU_KV_CHUNK", chunk), EnvVar("LWS_TPU_METRICS_PORT", str(metrics_port)),
           EnvVar("LWS_TPU_JOURNEY_SAMPLE", "1")]
    if tp:
        env.append(EnvVar("LWS_TPU_TP", str(tp)))
    if role == "decode":
        env.append(EnvVar("LWS_TPU_PROFILE_HZ", "50"))
    pod = PodTemplateSpec(spec=PodSpec(containers=[Container(name=role, command=command,
                                                             env=env)]))
    return DisaggregatedRoleSpec(
        name=role, replicas=1,
        template=LeaderWorkerSetTemplateSpec(spec=LeaderWorkerSetSpec(
            leader_worker_template=LeaderWorkerTemplate(size=1, worker_template=pod))),
    )


def http(url: str, body=None, accept=None):
    """(status, text) of one GET (or POST with `body`)."""
    headers = {"Accept": accept} if accept else {}
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return None, ""


def poll(fn, deadline: float, what: str, backend=None):
    while time.time() < deadline:
        if backend is not None:
            backend.poll_all()
        got = fn()
        if got:
            return got
        time.sleep(0.3)
    pytest.fail(f"{what} never happened")


def listener_pids(port: int, pids) -> set:
    """The processes among `pids` that hold a listening TCP socket on `port`."""
    inodes = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        with open(table) as f:
            for line in f.readlines()[1:]:
                cols = line.split()
                if int(cols[1].rsplit(":", 1)[1], 16) == port and cols[3] == "0A":
                    inodes.add(f"socket:[{cols[9]}]")
    out = set()
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                if os.readlink(f"/proc/{pid}/fd/{fd}") in inodes:
                    out.add(pid)
            except OSError:
                pass
    return out


class Pair:
    """The DS of two port roles under a control plane + API server."""

    def __init__(self, tmp_path, chunk: str, tp: int = 0) -> None:
        self.cp = ControlPlane()
        self.api = ApiServer(self.cp, port=0)
        self.api.start()
        self.url = f"http://127.0.0.1:{self.api.port}"
        kv_pre, kv_dec, m_pre, m_dec = free_ports(4)
        self.metrics = {"prefill": m_pre, "decode": m_dec}
        ds = DisaggregatedSet(meta=new_meta("llmd"), spec=DisaggregatedSetSpec(roles=[
            role_spec("prefill", kv_pre, m_pre, self.url, chunk, tp),
            role_spec("decode", kv_dec, m_dec, self.url, chunk, tp),
        ]))
        self.backend = make_backend(self.cp, tmp_path)
        self.cp.manager.register(self.backend, {"Pod": lambda o: [o.key()]})
        self.cp.create(ds)
        self.cp.run_until_stable()
        self.deadline = time.time() + 240
        client = RemoteClient(self.url)
        self.ep: dict = {}
        while time.time() < self.deadline and len(self.ep) < 2:
            self.backend.poll_all()
            self.cp.run_until_stable()
            for role in ("prefill", "decode"):
                if role not in self.ep:
                    ep = kt.discover_role_endpoint(client, "default", "llmd", role)
                    if ep is not None:
                        self.ep[role] = ep
            time.sleep(0.2)
        assert len(self.ep) == 2, f"-prv endpoints never published: {self.ep}"

    def procs(self) -> dict:
        """{role: its worker process}, by the pods' role labels."""
        uids = {p.meta.uid: p.meta.labels[DS_ROLE_LABEL_KEY] for p in self.cp.store.list("Pod")}
        return {uids[uid]: proc for uid, proc in self.backend._procs.items()}

    def request(self, rid: str, prompt):
        while time.time() < self.deadline:
            try:
                kt.submit_prompt(self.ep["prefill"], rid, kt.arrays_to_bytes(prompt=prompt))
                break
            except OSError:
                time.sleep(0.3)
        return wait_result(self.backend, self.ep["decode"], rid, self.deadline)

    def worker(self, role: str, path: str, body=None):
        return http(f"http://127.0.0.1:{self.metrics[role]}{path}", body)

    def journey(self, role: str, rid: str) -> dict:
        """The role's completed local journey leg for `rid`."""
        def done():
            code, text = self.worker(role, f"/debug/request/{rid}")
            leg = json.loads(text) if code == 200 else {}
            return leg if leg.get("completed") else None

        return poll(done, self.deadline, f"the {role} journey of {rid}")

    def close(self) -> None:
        self.backend.shutdown()
        self.api.stop()


def test_port_workers_serve_the_fleet_journey_fault_and_drain_surfaces(tmp_path, oracle):  # noqa: F811
    prompt, want = oracle
    pair = Pair(tmp_path, chunk="0")
    try:
        meta, payload = pair.request("req1", prompt)
        np.testing.assert_array_equal(kt.bytes_to_arrays(payload)["tokens"], want)
        for role in ("prefill", "decode"):
            assert pair.worker(role, "/healthz") == (200, "ok")
        # The fleet view: both port workers, distinct instances, TTFT from
        # the prefill leg and ITL from the decode leg, exemplars riding.
        def fleet():
            code, text = http(f"{pair.url}/metrics/fleet", accept="application/openmetrics-text")
            fams = parse_exposition(text) if code == 200 else {}
            roles = {labels.get("role") for fam in fams.values()
                     for _, labels, _, _ in fam["samples"]
                     if labels.get("instance") != "control-plane"}
            return (fams, text) if {"prefill", "decode"} <= roles and \
                "serving_itl_seconds" in fams else None

        fams, text = poll(fleet, pair.deadline, "the fleet scrape of both roles", pair.backend)
        by_role: dict = {}
        for fam in fams.values():
            for _, labels, _, _ in fam["samples"]:
                if labels.get("role") and labels.get("instance") != "control-plane":
                    by_role.setdefault(labels["role"], set()).add(labels["instance"])
        assert by_role["prefill"].isdisjoint(by_role["decode"]), by_role
        assert all(len(v) == 1 for v in by_role.values()), by_role
        assert any(labels.get("role") == "prefill" and labels.get("engine") == "disagg"
                   and name.endswith("_count") and value > 0
                   for name, labels, value, _ in fams["serving_ttft_seconds"]["samples"])
        assert any(labels.get("role") == "decode" and labels.get("engine") == "disagg"
                   and name.endswith("_count") and value > 0
                   for name, labels, value, _ in fams["serving_itl_seconds"]["samples"])
        assert 'trace_id="' in text
        # The fleet-joined journey: a completed prefill leg whose kv.gather
        # span comes from the prefill instance, and the decode leg.
        def joined():
            code, body = http(f"{pair.url}/debug/request/req1")
            got = json.loads(body) if code == 200 else {}
            legs = {leg["labels"].get("role"): leg["journey"] for leg in got.get("legs", [])
                    if leg["journey"].get("completed")}
            return got if {"prefill", "decode"} <= set(legs) else None

        got = poll(joined, pair.deadline, "the fleet join of req1", pair.backend)
        gather = {s.get("instance") for s in got["spans"] if s["name"] == "kv.gather"}
        assert gather & by_role["prefill"], [(s["name"], s.get("instance")) for s in got["spans"]]
        assert {"serve.prefill", "kv.gather", "kv.deserialize", "kv.reshard",
                "serve.decode_dispatch"} <= {s["name"] for s in got["spans"]}
        # A fault armed live on the decode worker: the raise leaves the
        # bundle unacked, prefill re-queues it, and the redelivery completes.
        code, body = pair.worker("decode", "/debug/faults",
                                 {"arm": {"disagg.decode.process": "fail_n_times:1"}})
        assert code == 200 and json.loads(body)["armed"] == {
            "disagg.decode.process": "fail_n_times:1"}
        assert pair.worker("decode", "/debug/faults", {"arm": {"x": "nope"}})[0] == 400
        meta, payload = pair.request("req2", prompt)
        np.testing.assert_array_equal(kt.bytes_to_arrays(payload)["tokens"], want)
        code, body = pair.worker("decode", "/debug/faults")
        assert code == 200 and json.loads(body)["trips"] == {"disagg.decode.process": 1}, body
        assert "errored" not in pair.journey("decode", "req2")["flags"]
        # A poison bundle ends its request errored, and its journey is kept so.
        meta, _ = pair.request("poison", POISON)
        assert "max_len" in meta["failed"], meta
        leg = pair.journey("decode", "poison")
        assert leg["outcome"] == "errored" and "errored" in leg["flags"], leg
        code, body = pair.worker("decode", "/debug/requests?outcome=errored")
        assert code == 200 and [r["id"] for r in json.loads(body)] == ["poison"]
        meta, payload = pair.request("req3", prompt)
        np.testing.assert_array_equal(kt.bytes_to_arrays(payload)["tokens"], want)
        code, body = pair.worker("decode", "/debug/profile?format=collapsed")
        assert code == 200 and body.strip(), body
        for path in ("/debug/history", "/debug/flightrecorder", "/debug/compile",
                     "/debug/decisions", "/debug/prefixes"):
            assert pair.worker("decode", path)[0] == 200, path
        # The HTTP drain: the prefill worker exits clean.
        procs = pair.procs()
        assert pair.worker("prefill", "/debug/drain", {}) == (200, '{"draining": true}')
        assert procs["prefill"].wait(timeout=60) == 0
    finally:
        pair.close()


def test_only_tp_rank_zero_serves_the_telemetry_port(tmp_path, oracle):  # noqa: F811
    prompt, want = oracle
    pair = Pair(tmp_path, chunk="2", tp=2)
    try:
        meta, payload = pair.request("req1", prompt)
        np.testing.assert_array_equal(kt.bytes_to_arrays(payload)["tokens"], want)
        assert meta["handoff"]["chunks"] == 3
        procs = pair.procs()
        for role, proc in procs.items():
            followers = children(proc.pid)
            assert followers and all(alive(k) for k in followers)
            assert listener_pids(pair.metrics[role], [proc.pid, *followers]) == {proc.pid}
        # The streamed handoff's chunk timelines: produced on prefill,
        # arrived on decode, one entry per chunk.
        assert len(pair.journey("prefill", "req1")["annotations"]["chunks_produced"]) == 3
        dec = pair.journey("decode", "req1")
        assert len(dec["annotations"]["chunks"]) == 3
        assert {"kv.deserialize", "kv.reshard", "serve.decode_dispatch"} <= \
            {s["name"] for s in dec["spans"]}
    finally:
        pair.close()
