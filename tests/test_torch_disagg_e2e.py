"""e2e: the port's disaggregated workers as real processes under the JAX
control plane, on the CPU. A DisaggregatedSet launches
`python -m lws_tpu_torch.serving.disagg_worker prefill|decode --device cpu`
as two OS processes (ControlPlane + ApiServer + the local process backend,
as tests/test_e2e_disagg.py sets them up). The decode worker discovers the
prefill worker through the DS's `-prv` service record over the HTTP API; a
prompt flows client -> prefill -> KV bytes over TCP -> decode -> client.
The tokens must equal the port's single-engine oracle (build_engine +
generate on the same seed) exactly, for the streamed handoff
(LWS_TPU_KV_CHUNK=2: the 5-token prompt ships in 3 chunks) and the
monolithic one (LWS_TPU_KV_CHUNK=0)."""

import socket
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
from lws_tpu_torch.models.flagship import flagship_config, kv_row_bytes
from lws_tpu_torch.serving import kv_transport as kt
from lws_tpu_torch.serving.disagg_worker import build_engine
from tests.test_e2e_local import make_backend

DECODE_STEPS = 6
MAX_LEN = 32


def free_ports(n: int) -> list[int]:
    """n distinct free ports (a port released by one probe can come back
    from the next)."""
    ports: list[int] = []
    while len(ports) < n:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            if s.getsockname()[1] not in ports:
                ports.append(s.getsockname()[1])
    return ports


def role_spec(role: str, kv_port: int, api_url: str, chunk: str) -> DisaggregatedRoleSpec:
    command = [sys.executable, "-m", "lws_tpu_torch.serving.disagg_worker", role,
               "--steps", str(DECODE_STEPS), "--max-len", str(MAX_LEN), "--device", "cpu"]
    env = [EnvVar("LWS_TPU_KV_PORT", str(kv_port)), EnvVar("LWS_TPU_API", api_url),
           EnvVar("LWS_TPU_KV_CHUNK", chunk)]
    pod = PodTemplateSpec(spec=PodSpec(containers=[Container(name=role, command=command,
                                                             env=env)]))
    return DisaggregatedRoleSpec(
        name=role, replicas=1,
        template=LeaderWorkerSetTemplateSpec(spec=LeaderWorkerSetSpec(
            leader_worker_template=LeaderWorkerTemplate(size=1, worker_template=pod))),
    )


@pytest.fixture(scope="module")
def oracle():
    prompt = np.array([5, 9, 2, 11, 7], dtype=np.int32)
    engine = build_engine(batch=1, max_len=MAX_LEN, device="cpu")
    return prompt, engine.generate(prompt.reshape(1, -1), max_new_tokens=DECODE_STEPS + 1).tokens


@pytest.mark.parametrize("chunk", ["2", "0"], ids=["streamed", "monolithic"])
def test_port_workers_hand_off_under_the_control_plane(tmp_path, oracle, chunk):
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
        assert len(cp.store.list("Pod")) == 2  # one prefill, one decode leader
        # The client discovers both endpoints the way the decode worker does.
        deadline = time.time() + 120
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
        # The pod is Ready once its process lives, which can precede the KV
        # port's bind: dial with retries, as a client behind a Service would.
        while time.time() < deadline:
            try:
                kt.submit_prompt(endpoints["prefill"], "req1", kt.arrays_to_bytes(prompt=prompt))
                break
            except OSError:
                time.sleep(0.3)
        else:
            pytest.fail("the prefill endpoint never accepted the prompt")
        result = meta = None
        while time.time() < deadline:
            backend.poll_all()
            try:
                got = kt.pull_result(endpoints["decode"], "req1")
            except OSError:
                got = None
            if got is not None:
                meta, payload = got
                result = kt.bytes_to_arrays(payload)["tokens"]
                break
            time.sleep(0.2)
        assert result is not None, "no decode result over TCP"
        handoff = meta["handoff"]
        for key in ("pos", "bundle_bytes", "prefill_s", "gather_s", "tp_gathered",
                    "deserialize_s", "reshard_s", "decode_s"):
            assert key in handoff, (key, handoff)
        # The result ships the handoff's span subtree, one tree across the
        # two processes, and the handoff record is read off its durations.
        spans = {sp["name"]: sp for sp in meta["spans"]}
        assert set(spans) == {"serve.request", "serve.prefill", "kv.gather", "kv.deserialize",
                              "kv.reshard", "serve.decode_dispatch"}, sorted(spans)
        assert len({sp["trace_id"] for sp in meta["spans"]}) == 1
        for key, name in (("prefill_s", "serve.prefill"), ("deserialize_s", "kv.deserialize"),
                          ("reshard_s", "kv.reshard"), ("decode_s", "serve.decode_dispatch")):
            assert handoff[key] == round(spans[name]["duration_s"], 4), (key, handoff)
        cfg = flagship_config("smoke", max_seq_len=MAX_LEN)
        assert handoff["pos"] == len(prompt)
        assert handoff["bundle_bytes"] >= len(prompt) * kv_row_bytes(cfg), handoff
        if chunk == "2":
            assert handoff["streamed"] is True and handoff["chunks"] == 3, handoff
        else:
            assert "streamed" not in handoff, handoff
        np.testing.assert_array_equal(result, want)
    finally:
        backend.shutdown()
        api.stop()
