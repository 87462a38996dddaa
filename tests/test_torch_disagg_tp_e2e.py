"""e2e: the port's tensor-parallel disaggregated workers as real processes
under the JAX control plane, on the CPU: the twin of
tests/test_e2e_disagg.py:867. Each role's one pod declares `LWS_TPU_TP=2`;
its worker process becomes tp rank 0 and spawns rank 1 (gloo), the prefill
role gathers the KV heads into the single-device bundle and the decode role
scatters them onto its own mesh. The tokens must equal the port's
single-engine oracle exactly, for the monolithic handoff
(`LWS_TPU_KV_CHUNK=0`) and the streamed one (`LWS_TPU_KV_CHUNK=2`).

Before the oracle request, a poison request goes through: the decode role
runs a smaller max_len than the prompt's rows, so rank 0 refuses the bundle
(the monolithic reshard broadcasts the refusal to both ranks; a streamed
one is refused on rank 0 before any rank is told to decode). The request
fails, and both ranks of both roles keep serving the next one. Then a
SIGTERM drain ends every worker process, the spawned ranks included, with
code 0."""

import os
import sys
import time

import numpy as np
import pytest

from lws_tpu.api.disagg import (
    DisaggregatedRoleSpec,
    DisaggregatedSet,
    DisaggregatedSetSpec,
    LeaderWorkerSetTemplateSpec,
)
from lws_tpu.api.pod import Container, EnvVar, PodSpec, PodTemplateSpec
from lws_tpu.api.types import LeaderWorkerSetSpec, LeaderWorkerTemplate
from lws_tpu.core.store import new_meta
from lws_tpu.runtime import ControlPlane
from lws_tpu.runtime.server import ApiServer
from lws_tpu_torch.client import RemoteClient
from lws_tpu_torch.serving import kv_transport as kt
from tests.test_e2e_local import make_backend
from tests.test_torch_disagg_e2e import DECODE_STEPS, MAX_LEN, free_ports, oracle  # noqa: F401

DECODE_MAX_LEN = 16  # the decode role's budget: the poison prompt's rows overflow it
POISON = np.arange(1, 21, dtype=np.int32)  # 20 rows > DECODE_MAX_LEN


def role_spec(role: str, kv_port: int, api_url: str, chunk: str) -> DisaggregatedRoleSpec:
    max_len = MAX_LEN if role == "prefill" else DECODE_MAX_LEN
    command = [sys.executable, "-m", "lws_tpu_torch.serving.disagg_worker", role,
               "--steps", str(DECODE_STEPS), "--max-len", str(max_len), "--device", "cpu"]
    env = [EnvVar("LWS_TPU_KV_PORT", str(kv_port)), EnvVar("LWS_TPU_API", api_url),
           EnvVar("LWS_TPU_KV_CHUNK", chunk), EnvVar("LWS_TPU_TP", "2")]
    pod = PodTemplateSpec(spec=PodSpec(containers=[Container(name=role, command=command,
                                                             env=env)]))
    return DisaggregatedRoleSpec(
        name=role, replicas=1,
        template=LeaderWorkerSetTemplateSpec(spec=LeaderWorkerSetSpec(
            leader_worker_template=LeaderWorkerTemplate(size=1, worker_template=pod))),
    )


def children(pid: int) -> list[int]:
    """The live processes whose parent is `pid`."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return out


def alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def wait_result(backend, endpoint, rid: str, deadline: float):
    while time.time() < deadline:
        backend.poll_all()
        try:
            got = kt.pull_result(endpoint, rid)
        except OSError:
            got = None
        if got is not None:
            return got
        time.sleep(0.2)
    pytest.fail(f"no decode result for {rid} over TCP")


@pytest.mark.parametrize("chunk", ["0", "2"], ids=["monolithic", "streamed"])
def test_tp_workers_hand_off_under_the_control_plane(tmp_path, oracle, chunk):  # noqa: F811
    prompt, want = oracle
    cp = ControlPlane()
    api = ApiServer(cp, port=0)
    api.start()
    api_url = f"http://127.0.0.1:{api.port}"
    prefill_port, decode_port = free_ports(2)
    ds = DisaggregatedSet(meta=new_meta("llmd"), spec=DisaggregatedSetSpec(roles=[
        role_spec("prefill", prefill_port, api_url, chunk),
        role_spec("decode", decode_port, api_url, chunk),
    ]))
    backend = make_backend(cp, tmp_path)
    cp.manager.register(backend, {"Pod": lambda o: [o.key()]})
    client = RemoteClient(api_url)
    try:
        cp.create(ds)
        cp.run_until_stable()
        deadline = time.time() + 240
        endpoints = {}
        while time.time() < deadline and len(endpoints) < 2:
            backend.poll_all()
            cp.run_until_stable()
            for role in ("prefill", "decode"):
                if role not in endpoints:
                    ep = kt.discover_role_endpoint(client, "default", "llmd", role)
                    if ep is not None:
                        endpoints[role] = ep
            time.sleep(0.2)
        assert len(endpoints) == 2, f"-prv endpoints never published: {endpoints}"
        while time.time() < deadline:
            try:
                kt.submit_prompt(endpoints["prefill"], "poison",
                                 kt.arrays_to_bytes(prompt=POISON))
                break
            except OSError:
                time.sleep(0.3)
        else:
            pytest.fail("the prefill endpoint never accepted the prompt")
        meta, _ = wait_result(backend, endpoints["decode"], "poison", deadline)
        assert "max_len" in meta["failed"], meta
        workers = {p.pid: p for p in backend._procs.values()}
        ranks = {pid: children(pid) for pid in workers}
        assert all(len(kids) >= 1 for kids in ranks.values()), ranks  # rank 1 of each role
        followers = [k for kids in ranks.values() for k in kids]
        assert all(alive(k) for k in followers)  # the poison failed the request, not a rank
        kt.submit_prompt(endpoints["prefill"], "req1", kt.arrays_to_bytes(prompt=prompt))
        meta, payload = wait_result(backend, endpoints["decode"], "req1", deadline)
        np.testing.assert_array_equal(kt.bytes_to_arrays(payload)["tokens"], want)
        handoff = meta["handoff"]
        assert handoff["tp_gathered"] is True and handoff["pos"] == len(prompt), handoff
        if chunk == "2":
            assert handoff["streamed"] is True and handoff["chunks"] == 3, handoff
        else:
            assert "streamed" not in handoff, handoff
        names = {sp["name"] for sp in meta["spans"]}
        assert {"kv.gather", "kv.reshard", "serve.decode_dispatch"} <= names, names
        reshard = next(sp for sp in meta["spans"] if sp["name"] == "kv.reshard")
        assert reshard["attrs"]["tp_sharded"] is True
        assert handoff["reshard_s"] == round(reshard["duration_s"], 4)
        # The SIGTERM drain: every worker exits 0 and reaps its spawned rank.
        backend.shutdown()
        for pid, proc in workers.items():
            assert proc.wait(timeout=120) == 0, pid
        t_end = time.time() + 60
        while time.time() < t_end and any(alive(k) for k in followers):
            time.sleep(0.2)
        assert not [k for k in followers if alive(k)], "a spawned rank outlived its role"
    finally:
        backend.shutdown()
        api.stop()
