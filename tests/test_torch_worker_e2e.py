"""e2e: the JAX control plane launches the port's group worker as real local
processes wired purely by the injected env contract, as
tests/test_e2e_local.py launches the JAX worker: a LeaderWorkerSet of size
2 runs `python -m lws_tpu_torch.runtime.worker psum|tp_forward|serve_tp|
serve_paged --device cpu`, the members form one gloo group with the leader
as the store, and each writes its result line. Both processes must report
ok=True / tp=2, identical payloads, and serve_paged's 16 prefix-hit
tokens; the greedy tokens must equal the port's single-process engines on
the same seed, and tp_forward's checksum the single-process forward's.

The coordinator's port is a free one, set through the backend's env
overrides (a pod template may set JAX_COORDINATOR_ADDRESS itself): the
contract's default port 8471 is the one the JAX package's e2e tests bind,
and the two files may run at the same time.
"""

import ast
import sys

import numpy as np
import pytest
import torch

from lws_tpu.api.pod import Container, EnvVar, PodSpec, PodTemplateSpec
from lws_tpu.api.types import LeaderWorkerSet, LeaderWorkerSetSpec, LeaderWorkerTemplate
from lws_tpu.core.store import new_meta
from lws_tpu.runtime import ControlPlane
from lws_tpu_torch.parallel.launch import free_port
from lws_tpu_torch.runtime import worker
from tests.test_e2e_local import make_backend, wait_for_files


def run_group(tmp_path, name: str, cmd: str) -> list[str]:
    """Run `cmd` as a 2-member group under the control plane; returns the
    members' result lines, leader first."""
    template = PodTemplateSpec(spec=PodSpec(containers=[Container(
        name="worker",
        command=[sys.executable, "-m", "lws_tpu_torch.runtime.worker", cmd, "--device", "cpu"],
        env=[EnvVar("LWS_TPU_RESULT_FILE", str(tmp_path / "$(POD_NAME).txt"))],
    )]))
    lws = LeaderWorkerSet(meta=new_meta(name), spec=LeaderWorkerSetSpec(
        replicas=1, leader_worker_template=LeaderWorkerTemplate(worker_template=template, size=2)))
    cp = ControlPlane()
    backend = make_backend(cp, tmp_path, extra_env={
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}"})
    cp.manager.register(backend, {"Pod": lambda o: [o.key()]})
    files = [f"{name}-0.txt", f"{name}-0-1.txt"]
    try:
        cp.create(lws)
        cp.run_until_stable()
        wait_for_files(cp, backend, tmp_path, set(files))
        return [(tmp_path / f).read_text().strip() for f in files]
    finally:
        backend.shutdown()


def payload(line: str) -> str:
    return line.split(" ", 1)[1]  # without process=i/n


def test_group_runs_distributed_psum(tmp_path):
    lines = run_group(tmp_path, "tpsum", "psum")
    assert [l.split()[0] for l in lines] == ["process=0", "process=1"]
    for line in lines:
        assert "total=3.0 expected=3.0 ok=True" in line, lines


def test_group_runs_tp_sharded_forward(tmp_path):
    from lws_tpu_torch.models.llama import forward, init_params

    lines = run_group(tmp_path, "ttpfwd", "tp_forward")
    assert all("devices=2 tp=2" in l for l in lines), lines
    assert len({payload(l) for l in lines}) == 1, f"processes disagree: {lines}"
    cfg = worker._small_cfg(32, torch.device("cpu"))
    model = init_params(cfg, torch.Generator().manual_seed(worker.SEED), device="cpu")
    with torch.no_grad():
        want = float(forward(model, torch.arange(16)[None, :])[0].abs().sum())
    got = float(lines[0].split("checksum=")[1])
    assert got == pytest.approx(want, rel=1e-5), (got, want)  # f32 sums in another order


def test_group_serves_tp_sharded_engine(tmp_path):
    from lws_tpu_torch.models.llama import init_params
    from lws_tpu_torch.serving.engine import Engine

    lines = run_group(tmp_path, "tservetp", "serve_tp")
    assert all(" tp=2 " in l for l in lines), lines
    assert len({payload(l) for l in lines}) == 1, f"processes sampled different tokens: {lines}"
    got = ast.literal_eval(lines[0].split("tokens=")[1])
    cfg = worker._small_cfg(64, torch.device("cpu"))
    engine = Engine(cfg, init_params(cfg, torch.Generator().manual_seed(worker.SEED),
                                     device="cpu"), batch_size=2, max_len=64, device="cpu")
    token, cache = engine.prefill((np.arange(32, dtype=np.int32) % 64).reshape(2, 16))
    _, _, toks = engine.decode_n(token, cache, 8)
    assert got == [int(t) for t in toks.numpy().ravel()]  # 2 slots x 8 steps


def test_group_serves_paged_prefix_sampling(tmp_path):
    """Both members report identical tokens and prefix hits: allocation is
    the same host schedule on each, and the unseeded sampled request draws
    from the leader's broadcast entropy."""
    from lws_tpu_torch.models.llama import init_params
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    lines = run_group(tmp_path, "tservepg", "serve_paged")
    assert all(" tp=2 " in l and " hits=16 " in l for l in lines), lines  # 2 blocks of 8
    assert len({payload(l) for l in lines}) == 1, f"processes diverged: {lines}"
    got = ast.literal_eval(lines[0].split("tokens=")[1])
    cfg = worker._small_cfg(64, torch.device("cpu"))
    engine = PagedBatchEngine(cfg, init_params(cfg, torch.Generator().manual_seed(worker.SEED),
                                               device="cpu"),
                              slots=2, max_len=32, block_size=8, prefix_cache=True, device="cpu")
    a = engine.submit(np.concatenate([np.arange(16) % 64, [40, 41]]).astype(np.int32), 6)
    engine.run_until_drained()
    assert got[:6] == engine.result(a)  # the greedy request, token for token
    assert len(got) == 12 and all(0 <= t < cfg.vocab_size for t in got)
