"""The load runner's `DisaggTarget` over a live disaggregated pair of the
port, on the CPU (lws_tpu/loadgen/runner.py:159-212's counterpart). The
pair is the workers' own legs in two threads of this process: the prefill
role hands each queued prompt off through `disagg_worker.handle_prompt`
(streamed past `CHUNK` rows), the decode role pulls bundles with
`disagg_worker.decode_processor` and its stream receiver, each over its
own loopback KVServer. The JAX package's `shared_prefix` scenario, seed 0,
plays open-loop against the pair through `DisaggTarget`: every request
completes with its tokens on the client side and is counted on both legs'
server-side SLO series, under its workload class."""

import threading

import numpy as np
import pytest

from lws_tpu.loadgen import scenario as jscenario
from lws_tpu_torch import loadgen
from lws_tpu_torch.core import metrics, slo
from lws_tpu_torch.serving import disagg_worker as dw
from lws_tpu_torch.serving import kv_transport as kt

STEPS = 6
CHUNK = 16
REQUESTS = 8


def hist_count(registry, name: str, match: dict) -> float:
    fam = metrics.parse_exposition(registry.render()).get(name)
    if fam is None:
        return 0.0
    return sum(v for n, labels, v, _ in fam["samples"] if n == f"{name}_count"
               and all(labels.get(k) == want for k, want in match.items()))


@pytest.fixture
def pair(monkeypatch):
    """A prefill and a decode role on the smoke flagship, each a thread
    serving its KVServer; yields the two endpoints and a fresh registry the
    legs' SLO series land in."""
    registry = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "REGISTRY", registry)
    monkeypatch.setattr(slo, "RECORDER", slo.SLORecorder())
    pre = dw.build_engine(batch=1, max_len=64, device="cpu")
    dec = dw.build_engine(batch=1, max_len=64, device="cpu")
    servers = [kt.KVServer(port=0, host="127.0.0.1") for _ in range(2)]
    prefill_ep, decode_ep = (("127.0.0.1", s.port) for s in servers)
    stop = threading.Event()

    def prefill_role():
        while not stop.is_set():
            item = servers[0].next_prompt(timeout=0.1)
            if item is not None:
                dw.handle_prompt(pre, servers[0], *item, CHUNK)

    def decode_role():
        process = dw.decode_processor(dec, servers[1], STEPS)
        while not stop.is_set():
            try:
                kt.pull_bundle(prefill_ep, timeout=0.2, process=process, ack_timeout=60.0,
                               receiver_factory=dw.receiver_factory(dec))
            except OSError:
                pass  # the prefill server closed at teardown

    threads = [threading.Thread(target=fn, daemon=True) for fn in (prefill_role, decode_role)]
    for t in threads:
        t.start()
    try:
        yield prefill_ep, decode_ep, registry
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        for s in servers:
            s.close()


def test_disagg_target_drives_the_pair_open_loop(pair):
    prefill_ep, decode_ep, registry = pair
    spec = loadgen.load_scenario("shared_prefix")
    assert spec == jscenario.load_scenario("shared_prefix")
    schedule = loadgen.build_schedule(spec, 0)[:REQUESTS]
    assert any(len(r.prompt) > CHUNK for r in schedule)  # some requests stream
    target = loadgen.DisaggTarget(prefill_ep, decode_ep, id_prefix="lgt")
    result = loadgen.run_schedule(schedule, target, max_wall_s=120.0)
    outs = result.outcomes
    assert len(outs) == REQUESTS
    assert all(o.completed and not o.failed for o in outs), outs
    assert all(o.n_tokens == STEPS + 1 for o in outs), [o.n_tokens for o in outs]
    report = loadgen.summarize(result, loadgen.class_targets(spec), spec["horizon_s"],
                               spec["name"], 0)
    assert report["all"]["count"] == report["all"]["completed"] == REQUESTS
    # Both legs' server-side series count every request under its class.
    for klass in {r.klass for r in schedule}:
        n = sum(r.klass == klass for r in schedule)
        labels = {"engine": "disagg", "klass": klass}
        assert hist_count(registry, "serving_ttft_seconds", labels) == n  # the prefill leg
        assert hist_count(registry, "serving_itl_seconds", labels) == n  # the decode leg
    assert registry.counter_value("serving_kv_handoffs_total") == REQUESTS
    assert np.isclose(registry.counter_value("serving_kv_handoff_bytes_total"),
                      registry.counter_value("serving_kv_transfer_bytes_total",
                                             {"role": "decode"}))
