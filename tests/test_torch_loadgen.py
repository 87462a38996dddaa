"""The port's open-loop load runner (lws_tpu_torch/loadgen/runner.py) over
the port's engines, on the CPU: the cases of tests/test_loadgen.py (the
open-loop run whose client and server ledgers agree, an overloaded target's
incompletes, the dense target's queue/TTFT split, wall offsets under a time
scale), with each completed request's greedy tokens held to the JAX
engine's for the same prompt on the same converted weights, and
`build_local_target` for every engine kind."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lws_tpu.models import llama as jl
from lws_tpu.serving.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from lws_tpu_torch import loadgen
from lws_tpu_torch.core import metrics, slo
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

PAGED = dict(slots=4, max_len=64, block_size=8, prefix_cache=True)


@pytest.fixture(scope="module")
def model():
    """tests/test_loadgen.py's engine model."""
    jcfg = jl.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_ff=128, max_seq_len=128, dtype=jnp.float32,
                          param_dtype=jnp.float32, remat=False)
    jparams = jax.jit(lambda: jl.init_params(jcfg, jax.random.key(0)))()
    tcfg = config_from_jax(jcfg)
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _prefix_hits() -> float:
    return sum(metrics.REGISTRY.counter_value("serving_prefix_cache_hits_total",
                                              {"engine": "paged", "tier": t})
               for t in ("hbm", "host", "remote"))


def _count(name: str, labels: dict) -> float:
    fams = metrics.parse_exposition(metrics.REGISTRY.render())
    return sum(v for n, lab, v, _ in fams.get(name, {"samples": []})["samples"]
               if n == f"{name}_count" and lab == labels)


def test_open_loop_run_completes_and_ledgers_agree(model, monkeypatch):
    monkeypatch.setenv("LWS_TPU_PAGED_ATTN", "interpret")
    spec = loadgen.load_scenario("shared_prefix")
    schedule = loadgen.build_schedule(spec, seed=21)
    targets = loadgen.class_targets(spec)
    engine = PagedBatchEngine(model[2], model[3], device="cpu", **PAGED)
    labels = {"engine": "paged", "klass": "assist"}
    before_tokens = metrics.REGISTRY.counter_value("serving_tokens_total", labels)
    before_requests = metrics.REGISTRY.counter_value("serving_requests_total", {"engine": "paged"})
    before_ttft = _count("serving_ttft_seconds", labels)
    before_hits = _prefix_hits()
    result = loadgen.run_schedule(schedule, loadgen.EngineTarget(engine, "paged"),
                                  max_wall_s=90.0)
    report = loadgen.summarize(result, targets, spec["horizon_s"], "shared_prefix", 21)
    n = len(schedule)
    assert report["all"]["count"] == report["all"]["completed"] == n
    assert report["all"]["tokens"] == sum(r.max_new_tokens for r in schedule)
    assert report["classes"]["assist"]["ttft_p95"] is not None
    # The server-side ledger moved, class-labelled, by the same counts.
    assert metrics.REGISTRY.counter_value("serving_tokens_total", labels) - before_tokens == \
        report["all"]["tokens"]
    assert metrics.REGISTRY.counter_value("serving_requests_total", {"engine": "paged"}) - \
        before_requests == n
    assert _count("serving_ttft_seconds", labels) - before_ttft == n
    assert _prefix_hits() > before_hits
    assert report["offered_rps"] == pytest.approx(n / spec["horizon_s"])
    # Every completed request's greedy stream is the JAX engine's.
    jeng = JaxPagedBatchEngine(model[0], model[1], **PAGED)
    got = {tuple(r.prompt.tolist()): r.tokens for r in engine._completed.values()}
    assert len(got) == len({tuple(r.prompt.tolist()) for r in schedule})
    for req in schedule:
        rid = jeng.submit(req.prompt, req.max_new_tokens)
        jeng.run_until_drained()
        assert got[tuple(req.prompt.tolist())] == jeng.result(rid), req.index


def test_overloaded_run_reports_incompletes():
    class DeafTarget:
        def submit(self, req, arrival_wall_t):
            return None

        def step(self):
            time.sleep(0.001)

        def poll(self, handle):
            return None

    spec = loadgen.load_scenario("burst")
    schedule = loadgen.build_schedule(spec, seed=3)[:5]
    result = loadgen.run_schedule(schedule, DeafTarget(), max_wall_s=0.5)
    report = loadgen.summarize(result, {}, spec["horizon_s"], "burst", 3)
    assert report["all"]["completed"] == 0
    assert report["all"]["attainment"] == 0.0
    assert report["all"]["tokens"] == 0


def test_dense_target_splits_queue_from_ttft():
    """The dense target's submit() blocks through generate(): the wall
    overrides keep queue wait and TTFT apart."""

    class FakeDense:
        max_len = 64

        def generate(self, prompt, max_new_tokens, klass=""):
            assert isinstance(prompt, np.ndarray) and prompt.shape[0] == 1
            time.sleep(0.08)

            class R:
                tokens = np.zeros((1, max_new_tokens), np.int32)
                ttft_s = 0.01

            return R()

    spec = loadgen.load_scenario("burst")
    schedule = loadgen.build_schedule(spec, seed=3)[:2]
    result = loadgen.run_schedule(schedule, loadgen.EngineTarget(FakeDense(), "dense"),
                                  max_wall_s=10.0)
    for out in result.outcomes:
        assert out.completed
        assert out.ttft_s <= out.total_s
        assert out.ttft_s == pytest.approx(out.queue_s + 0.01, abs=0.03)


def test_wall_offsets_respect_time_scale():
    class InstantPair:
        def submit(self, req, arrival_wall_t):
            return req.index

        def step(self):
            time.sleep(0.001)

        def poll(self, handle):
            return {"n_tokens": 3, "ttft_after_admit_wall_s": 0.1}

    spec = loadgen.load_scenario("burst")
    schedule = loadgen.build_schedule(spec, seed=3)[:1]
    result = loadgen.run_schedule(schedule, InstantPair(), time_scale=2.0, max_wall_s=10.0)
    (out,) = result.outcomes
    assert out.ttft_s == pytest.approx(out.queue_s + 0.05, abs=0.01)


@pytest.mark.parametrize("kind", ["dense", "batch", "paged"])
def test_build_local_target_runs_each_engine_kind(kind, monkeypatch):
    monkeypatch.setattr(slo, "RECORDER", slo.SLORecorder(registry=metrics.MetricsRegistry()))
    spec = loadgen.load_scenario("steady_poisson")
    schedule = loadgen.build_schedule(spec, seed=1)[:6]
    target = loadgen.build_local_target(kind, spec, device="cpu")
    assert target.kind == kind and target.engine.device.type == "cpu"
    result = loadgen.run_schedule(schedule, target, max_wall_s=60.0)
    report = loadgen.summarize(result, loadgen.class_targets(spec), spec["horizon_s"])
    assert report["all"]["completed"] == len(schedule)
    assert report["all"]["tokens"] == sum(r.max_new_tokens for r in schedule)
    fams = metrics.parse_exposition(slo.RECORDER._registry.render())
    ttft = sum(v for n, lab, v, _ in fams["serving_ttft_seconds"]["samples"]
               if n.endswith("_count") and lab["engine"] == kind)
    assert ttft == len(schedule)  # the server-side ledger saw every request


def test_build_local_target_runs_on_the_card_by_default(monkeypatch):
    """Without `device`, the target is built on the card: with none, it
    raises rather than carrying on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loadgen.build_local_target("paged", loadgen.load_scenario("burst"))
    with pytest.raises(ValueError):
        loadgen.build_local_target("nope", loadgen.load_scenario("burst"), device="cpu")
