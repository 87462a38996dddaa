"""The chaos suite of the KV wire (tests/test_chaos_serving.py) on the
port's wire, resilience primitives and workers, each case run on both
packages: the port's `serving/kv_transport.py`, `core/faults.py` and
`core/resilience.py`, and the JAX package's, over real localhost sockets
under deterministic fault schedules. The same schedule must give the same
trips, requeues, replays, dedups and recorded metrics on both.

Mutation proofs: each resilience mechanism (deadline, retry, breaker,
drain, dedup) has a case that disables it through
LWS_TPU_RESILIENCE_DISABLE and shows the failure it exists to close
re-opens, on both wires.

The stream cases hand off a real streamed prefill (a tiny f32 model, the
port's converted from JAX's weights) and hold every replay's decoded
tokens to the fault-free oracle. Port-only cases: the in-flight chunk
gauge and the transfer counters by role, a port puller dropping its ack
against a JAX server, the decode worker's processor (deadline expiry,
dedup, poison guard) and the fault schedule's env grammar.

Left out: the worker telemetry server's /debug/drain and /debug/faults
(not ported), the fleet scrape's fault point (a control-plane point), and
the slow-marked multi-process e2e."""

import copy
import random
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from lws_tpu.core import faults as jfaults
from lws_tpu.core import flightrecorder as jflightrecorder
from lws_tpu.core import metrics as jmetrics
from lws_tpu.core import resilience as jresilience
from lws_tpu.serving import kv_transport as jkt
from lws_tpu_torch.core import faults, flightrecorder, metrics, resilience
from lws_tpu_torch.serving import kv_transport as kt

PKGS = {
    "jax": SimpleNamespace(name="jax", kt=jkt, faults=jfaults, metrics=jmetrics,
                           resilience=jresilience, flightrecorder=jflightrecorder),
    "port": SimpleNamespace(name="port", kt=kt, faults=faults, metrics=metrics,
                            resilience=resilience, flightrecorder=flightrecorder),
}


@pytest.fixture(scope="module", autouse=True)
def jax_metrics_restored():
    """The JAX package's process-global metrics registry is left as found
    (tests/test_torch_kv_transport.py's rule: a later JAX test reads it)."""
    reg = jmetrics.REGISTRY
    with reg._lock:
        saved = copy.deepcopy((reg._label_sets, reg._counters, reg._gauges, reg._histograms))
    yield
    with reg._lock:
        reg._label_sets, reg._counters, reg._gauges, reg._histograms = saved


@pytest.fixture(params=sorted(PKGS))
def w(request):
    """One package's wire; its injector disarmed after the case."""
    pkg = PKGS[request.param]
    yield pkg
    pkg.faults.INJECTOR.disarm()


@pytest.fixture
def server(w):
    s = w.kt.KVServer(port=0, host="127.0.0.1")
    yield s
    s.close()


def ep(server):
    return ("127.0.0.1", server.port)


def no_sleep(_s: float) -> None:
    """The retry sleeper of a chaos case: no wall-clock backoff."""


def counter(w, name, labels=None) -> float:
    return w.metrics.REGISTRY.counter_value(name, labels)


def wait_for(predicate, timeout=5.0):
    """The final ack is one-way: the server counts it after the client
    returned."""
    deadline = time.time() + timeout
    while time.time() < deadline and not predicate():
        time.sleep(0.02)
    return predicate()


# ---------------------------------------------------------------------------
# Retry


def test_retry_recovers_from_transient_connect_failures(w, server):
    server.post_result("r1", {"id": "r1"}, b"out")
    w.faults.INJECTOR.arm("kv.client.connect", "fail_n_times:2:ConnectionError")
    labels = {"site": "chaos.pull", "outcome": "retry"}
    before = counter(w, "serving_retries_total", labels)
    got = w.resilience.call(lambda: w.kt.pull_result(ep(server), "r1"), site="chaos.pull",
                            policy=w.resilience.RetryPolicy(max_attempts=4, base_s=0.0, cap_s=0.0),
                            sleeper=no_sleep)
    assert got is not None and got[1] == b"out"
    assert counter(w, "serving_retries_total", labels) == before + 2
    assert w.faults.INJECTOR.snapshot()["trips"] == {"kv.client.connect": 2}


def test_retry_disabled_fails_on_first_transient(w, server, monkeypatch):
    monkeypatch.setenv(w.resilience.DISABLE_ENV, "retry")
    server.post_result("r2", {"id": "r2"}, b"out")
    w.faults.INJECTOR.arm("kv.client.connect", "fail_n_times:2:ConnectionError")
    with pytest.raises(ConnectionError):
        w.resilience.call(lambda: w.kt.pull_result(ep(server), "r2"), site="chaos.pull",
                          policy=w.resilience.RetryPolicy(max_attempts=4, base_s=0.0, cap_s=0.0),
                          sleeper=no_sleep)
    assert w.faults.INJECTOR.snapshot()["trips"] == {"kv.client.connect": 1}


def test_retry_exhaustion_and_budget(w):
    calls = {"n": 0}

    def always_fails():
        calls["n"] += 1
        raise OSError("down")

    with pytest.raises(OSError):
        w.resilience.call(always_fails, site="chaos.exhaust",
                          policy=w.resilience.RetryPolicy(max_attempts=3, base_s=0.0),
                          sleeper=no_sleep)
    assert calls["n"] == 3
    assert counter(w, "serving_retries_total",
                   {"site": "chaos.exhaust", "outcome": "exhausted"}) >= 1.0
    # A dry budget stops the storm after the first failure.
    calls["n"] = 0
    with pytest.raises(OSError):
        w.resilience.call(always_fails, site="chaos.budget",
                          policy=w.resilience.RetryPolicy(max_attempts=5, base_s=0.0),
                          budget=w.resilience.RetryBudget(capacity=0.0), sleeper=no_sleep)
    assert calls["n"] == 1
    assert counter(w, "serving_retries_total",
                   {"site": "chaos.budget", "outcome": "budget_exhausted"}) >= 1.0
    # A clean first attempt earns a token back, up to the capacity.
    budget = w.resilience.RetryBudget(capacity=2.0, earn=0.5)
    assert budget.try_spend() and budget.remaining() == 1.0
    w.resilience.call(lambda: 1, site="chaos.budget", budget=budget, sleeper=no_sleep)
    assert budget.remaining() == 1.5


def test_retry_backoff_is_decorrelated_jitter_and_seedable():
    """A seeded jitter gives the same sleeps on both packages."""
    def sleeps(res):
        out: list[float] = []
        with pytest.raises(OSError):
            res.call(lambda: (_ for _ in ()).throw(OSError("down")), site="chaos.jitter",
                     policy=res.RetryPolicy(max_attempts=4, base_s=0.05, cap_s=1.0),
                     sleeper=out.append, rng=random.Random(7))
        return out

    got = sleeps(resilience)
    assert got == sleeps(resilience) == sleeps(jresilience) and len(got) == 3
    assert all(0.05 <= s <= 1.0 for s in got)


# ---------------------------------------------------------------------------
# Deadlines


@pytest.fixture
def black_hole():
    """A peer that accepts and then says nothing: the hang shape."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(4)
    yield ("127.0.0.1", sock.getsockname()[1])
    sock.close()


def test_deadline_trips_instead_of_hanging(w, black_hole):
    labels = {"site": "chaos.deadline"}
    before = counter(w, "serving_deadline_expirations_total", labels)
    t0 = time.perf_counter()
    with w.resilience.bind(w.resilience.Deadline(0.08)):
        with pytest.raises(w.resilience.DeadlineExceeded):
            w.resilience.call(lambda: w.kt.pull_result(black_hole, "nope"), site="chaos.deadline",
                              policy=w.resilience.RetryPolicy(max_attempts=3, base_s=0.0),
                              sleeper=no_sleep)
    assert time.perf_counter() - t0 < 1.0  # bounded by the budget, not the 10 s transport
    assert counter(w, "serving_deadline_expirations_total", labels) >= before + 1


def test_deadline_disabled_waits_full_socket_timeout(w, black_hole, monkeypatch):
    monkeypatch.setenv(w.resilience.DISABLE_ENV, "deadline")
    t0 = time.perf_counter()
    with w.resilience.bind(w.resilience.Deadline(0.05)):
        with pytest.raises(OSError) as err:
            w.kt.pull_result(black_hole, "nope", timeout=0.3)
    assert not isinstance(err.value, w.resilience.DeadlineExceeded)
    assert time.perf_counter() - t0 >= 0.25  # waited past the dead budget


def test_deadline_rides_frame_meta_to_the_worker(w, server):
    with w.resilience.bind(w.resilience.Deadline(5.0)):
        w.kt.submit_prompt(ep(server), "dl1", b"prompt")
    meta, _ = server.next_prompt(timeout=2.0)
    assert 0.0 < float(meta["deadline_s"]) <= 5.0
    restored = w.resilience.Deadline.from_wire(meta["deadline_s"])
    assert restored is not None and not restored.expired()


def test_injected_delay_makes_slow_network_trip_deadline(w, server):
    server.post_result("slow1", {"id": "slow1"}, b"out")
    w.faults.INJECTOR.arm("kv.server.recv", "delay:0.1")
    with w.resilience.bind(w.resilience.Deadline(0.05)):
        with pytest.raises(w.resilience.DeadlineExceeded):
            w.resilience.call(lambda: w.kt.pull_result(ep(server), "slow1"), site="chaos.slow",
                              policy=w.resilience.RetryPolicy(max_attempts=2, base_s=0.0),
                              sleeper=no_sleep)
    w.faults.INJECTOR.disarm()
    # The slow server found a dead client and never popped the entry.
    assert w.kt.pull_result(ep(server), "slow1") is not None


def test_deadline_budget_pays_for_queue_time(w, server):
    with w.resilience.bind(w.resilience.Deadline(0.05)):
        w.kt.submit_prompt(ep(server), "qw1", b"p")
    time.sleep(0.1)  # the prompt queues past its whole budget
    meta, _ = server.next_prompt(timeout=2.0)
    assert float(meta["deadline_s"]) == 0.0, meta
    server.offer_bundle({"id": "qw2", "deadline_s": 0.05}, b"b")
    time.sleep(0.1)
    bmeta, _ = w.kt.pull_bundle(ep(server), timeout=1.0)
    assert float(bmeta["deadline_s"]) == 0.0, bmeta
    assert "_offered_t" not in bmeta  # the internal anchor never reaches the wire


# ---------------------------------------------------------------------------
# Circuit breaker


def test_breaker_opens_half_opens_and_recovers(w):
    fake = {"t": 0.0}
    breaker = w.resilience.CircuitBreaker("chaos@peer", failure_threshold=2,
                                          reset_timeout_s=5.0, clock=lambda: fake["t"])
    w.flightrecorder.RECORDER.clear()
    assert breaker.allow() and breaker.state == "closed"
    breaker.record_failure()
    assert breaker.state == "closed"
    breaker.record_failure()
    assert breaker.state == "open" and not breaker.allow()
    assert w.metrics.REGISTRY.gauge_value("serving_circuit_state",
                                          {"endpoint": "chaos@peer"}) == 2.0
    fake["t"] = 6.0
    assert breaker.allow() and breaker.state == "half_open"
    assert not breaker.allow()  # one probe at a time
    breaker.record_failure()
    assert breaker.state == "open" and not breaker.allow()
    fake["t"] = 12.0
    assert breaker.allow()
    breaker.record_success()
    assert breaker.state == "closed" and breaker.allow()
    kinds = [(e["from_state"], e["to_state"]) for e in w.flightrecorder.RECORDER.events()
             if e["kind"] == "circuit_breaker" and e["endpoint"] == "chaos@peer"]
    assert kinds == [("closed", "open"), ("open", "half_open"), ("half_open", "open"),
                     ("open", "half_open"), ("half_open", "closed")]
    breaker.retire()
    assert w.metrics.REGISTRY.gauge_value("serving_circuit_state",
                                          {"endpoint": "chaos@peer"}) is None


def test_breaker_fails_fast_on_dead_endpoint(w):
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        dead = ("127.0.0.1", probe.getsockname()[1])
    breaker = w.resilience.CircuitBreaker("chaos@dead", failure_threshold=1,
                                          reset_timeout_s=60.0)
    with pytest.raises(OSError):
        breaker.call(lambda: w.kt.pull_result(dead, "x"))
    assert breaker.state == "open"
    t0 = time.perf_counter()
    with pytest.raises(w.resilience.CircuitOpenError):
        breaker.call(lambda: w.kt.pull_result(dead, "x"))
    assert time.perf_counter() - t0 < 0.05  # failed fast, no dial
    breaker.record_success()


def test_breaker_disabled_keeps_dialing(w, monkeypatch):
    monkeypatch.setenv(w.resilience.DISABLE_ENV, "breaker")
    breaker = w.resilience.CircuitBreaker("chaos@disabled", failure_threshold=1,
                                          reset_timeout_s=60.0)
    calls = {"n": 0}

    def dial():
        calls["n"] += 1
        raise OSError("refused")

    for _ in range(3):
        with pytest.raises(OSError):
            breaker.call(dial)
    assert calls["n"] == 3 and breaker.state == "closed"


# ---------------------------------------------------------------------------
# At-least-once replay and dedup


def test_ack_loss_replays_bundle_and_dedup_decodes_once(w, server):
    server.offer_bundle({"id": "req1"}, b"kvbytes")
    w.faults.INJECTOR.arm("kv.ack", "drop:1")
    seen = w.resilience.SeenIds(site="chaos")
    before = counter(w, "serving_replays_deduped_total", {"site": "chaos"})
    decodes = {"n": 0}

    def process(meta, payload):
        if seen.seen(meta["id"]):
            return
        decodes["n"] += 1
        assert payload == b"kvbytes"

    w.kt.pull_bundle(ep(server), timeout=1.0, process=process)
    assert server.delivery_counts()[0] == 0  # unacked: re-queued
    w.kt.pull_bundle(ep(server), timeout=1.0, process=process)
    assert decodes["n"] == 1
    assert wait_for(lambda: server.delivery_counts()[0] == 1)
    assert w.kt.pull_bundle(ep(server), timeout=0.2) is None  # consumed
    assert counter(w, "serving_replays_deduped_total", {"site": "chaos"}) == before + 1
    assert w.faults.INJECTOR.snapshot()["trips"] == {"kv.ack": 1}
    assert any(e["kind"] == "kv_requeue" and e["request_id"] == "req1"
               for e in w.flightrecorder.RECORDER.events())


def test_dedup_disabled_decodes_replay_twice(w, server, monkeypatch):
    monkeypatch.setenv(w.resilience.DISABLE_ENV, "dedup")
    server.offer_bundle({"id": "req2"}, b"kv")
    w.faults.INJECTOR.arm("kv.ack", "drop:1")
    seen = w.resilience.SeenIds(site="chaos")
    decodes = {"n": 0}

    def process(meta, payload):
        if seen.seen(meta["id"]):
            return
        decodes["n"] += 1

    w.kt.pull_bundle(ep(server), timeout=1.0, process=process)
    w.kt.pull_bundle(ep(server), timeout=1.0, process=process)
    assert decodes["n"] == 2


def test_two_phase_dedup_failed_first_attempt_retries_for_real(w, server):
    server.offer_bundle({"id": "tp1"}, b"x")
    seen = w.resilience.SeenIds(site="chaos")
    attempts = []

    def process(meta, payload):
        if seen.contains(meta["id"]):
            return
        attempts.append(meta["id"])
        if len(attempts) == 1:
            raise OSError("died before post_result")
        seen.record(meta["id"])

    with pytest.raises(OSError):
        w.kt.pull_bundle(ep(server), timeout=1.0, process=process)
    w.kt.pull_bundle(ep(server), timeout=2.0, process=process)
    assert attempts == ["tp1", "tp1"] and seen.contains("tp1")


def test_seen_ids_bound_evicts_oldest(w):
    seen = w.resilience.SeenIds(capacity=3, site="chaos")
    for rid in ("a", "b", "c"):
        assert not seen.seen(rid)
    assert not seen.seen("d")  # evicts "a"
    assert len(seen) == 3
    assert not seen.seen("a")
    assert seen.seen("c")


def test_decode_crash_mid_process_requeues_bundle(w, server):
    server.offer_bundle({"id": "crash1"}, b"payload")
    w.faults.INJECTOR.arm("disagg.decode.process", "exit:1")

    def process(meta, payload):
        w.faults.fire("disagg.decode.process")  # the worker's chaos hook

    with pytest.raises(SystemExit):
        w.kt.pull_bundle(ep(server), timeout=1.0, process=process)
    got = w.kt.pull_bundle(ep(server), timeout=2.0)  # a successor pulls
    assert got is not None and got[0]["id"] == "crash1" and got[1] == b"payload"


# ---------------------------------------------------------------------------
# partial_write: the mid-frame deaths


def test_partial_write_requeues_bundle_intact(w, server):
    payload = bytes(range(256)) * 4
    server.offer_bundle({"id": "pw1"}, payload)
    w.faults.INJECTOR.arm("kv.server.send_bundle", "partial_write:6:1")
    with pytest.raises(OSError):
        w.kt.pull_bundle(ep(server), timeout=1.0)
    got = w.kt.pull_bundle(ep(server), timeout=2.0)
    assert got is not None and got[0]["id"] == "pw1" and got[1] == payload


def test_partial_write_reinserts_result_for_retry(w, server):
    server.post_result("pw2", {"id": "pw2"}, b"result-bytes")
    w.faults.INJECTOR.arm("kv.server.send_result", "partial_write:4:1")
    assert w.kt.pull_result(ep(server), "pw2") is None  # truncated = not ready
    got = w.kt.pull_result(ep(server), "pw2")
    assert got is not None and got[1] == b"result-bytes"
    assert wait_for(lambda: server.delivery_counts()[1] == 1)


def test_pace_fault_emulates_bandwidth_on_both_paths(w, server):
    payload = bytes(200_000)
    server.offer_bundle({"id": "paced"}, payload)
    w.faults.INJECTOR.arm("kv.server.send_bundle", "pace:10")  # ~20 ms for 200 kB
    t0 = time.perf_counter()
    got = w.kt.pull_bundle(ep(server), timeout=2.0)
    assert got is not None and got[1] == payload
    assert time.perf_counter() - t0 >= 0.015


# ---------------------------------------------------------------------------
# Graceful drain


def _drain_worker(w, gate, server, hold, done, processed):
    def process(meta, payload):
        processed.append(meta["id"])
        hold.wait(timeout=10)

    while not gate.draining:
        try:
            if w.kt.pull_bundle(ep(server), timeout=0.2, process=process) is None:
                continue
        except OSError:
            break
    done.set()


def test_drain_finishes_in_flight_and_parks_the_rest(w, server):
    for i in range(3):
        server.offer_bundle({"id": f"d{i}"}, b"x")
    gate = w.resilience.DrainGate()
    hold, done = threading.Event(), threading.Event()
    processed: list = []
    threading.Thread(target=_drain_worker, args=(w, gate, server, hold, done, processed),
                     daemon=True).start()
    assert wait_for(lambda: processed)
    assert processed == ["d0"]
    assert gate.request("test")  # the drain arrives mid-processing
    hold.set()
    assert done.wait(timeout=5)
    assert wait_for(lambda: server.delivery_counts()[0] == 1)  # the in-flight item acked
    assert processed == ["d0"]
    survivors = {w.kt.pull_bundle(ep(server), timeout=1.0)[0]["id"] for _ in range(2)}
    assert survivors == {"d1", "d2"}


def test_drain_disabled_keeps_admitting(w, server, monkeypatch):
    monkeypatch.setenv(w.resilience.DISABLE_ENV, "drain")
    for i in range(3):
        server.offer_bundle({"id": f"nd{i}"}, b"x")
    gate = w.resilience.DrainGate()
    hold, done = threading.Event(), threading.Event()
    hold.set()
    processed: list = []
    threading.Thread(target=_drain_worker, args=(w, gate, server, hold, done, processed),
                     daemon=True).start()
    assert gate.request("test") is False  # refused: the mechanism is off
    assert wait_for(lambda: len(processed) == 3)
    monkeypatch.delenv(w.resilience.DISABLE_ENV)
    gate.request("cleanup")
    assert done.wait(timeout=5)
    gate.reset()


# ---------------------------------------------------------------------------
# The streamed handoff under faults: never a torn cache


@pytest.fixture(scope="module")
def stream_rig():
    """tests/test_chaos_serving.py's tiny engines for both packages (the
    port's from JAX's weights) and each one's fault-free oracle."""
    import jax
    import jax.numpy as jnp

    from lws_tpu.models.llama import LlamaConfig, init_params
    from lws_tpu.serving import disagg_worker as jdw
    from lws_tpu.serving.engine import Engine as JaxEngine
    from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
    from lws_tpu_torch.serving import disagg_worker as dw
    from lws_tpu_torch.serving.engine import Engine

    jcfg = LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=64,
                       max_seq_len=64, dtype=jnp.float32, remat=False)
    jparams = jax.jit(lambda: init_params(jcfg, jax.random.key(0)))()
    cfg = config_from_jax(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompt = np.asarray(jax.random.randint(jax.random.key(5), (13,), 0, 64), np.int32)
    rigs = {
        "jax": SimpleNamespace(
            engine=lambda: JaxEngine(jcfg, jparams, batch_size=1, max_len=32),
            produce=lambda eng, server, rid: jdw._prefill_streamed(
                eng, server, jkt, {"id": rid}, rid, prompt, 4, None),
            decode=jdw._decode_bundle, assembler=lambda: jkt.CacheAssembler(max_len=32)),
        "port": SimpleNamespace(
            engine=lambda: Engine(cfg, params, batch_size=1, max_len=32, device="cpu"),
            produce=lambda eng, server, rid: dw._prefill_streamed(
                eng, server, {"id": rid}, rid, prompt, 4, None),
            decode=dw._decode_bundle,
            assembler=lambda: kt.CacheAssembler(max_len=32, device="cpu")),
    }
    for name, rig in rigs.items():
        rig.prompt = prompt
        pre = rig.engine()
        rig.prefill_engine = pre
        token, cache = pre.prefill(prompt.reshape(1, -1))
        bundle = PKGS[name].kt.cache_to_bundle(cache, token)
        rig.want, _, _ = rig.decode(rig.engine(), bundle, steps=5)
    np.testing.assert_array_equal(rigs["port"].want, rigs["jax"].want)
    return rigs


def _pull_assembled(w, rig, server, **kw):
    return w.kt.pull_bundle(ep(server), timeout=2.0, ack_timeout=30.0,
                            receiver_factory=lambda m: rig.assembler(), **kw)


def test_stream_partial_write_requeues_and_replays_byte_identical(w, server, stream_rig):
    rig = stream_rig[w.name]
    rig.produce(rig.prefill_engine, server, "pw-stream")
    w.faults.INJECTOR.arm("kv.stream.send_chunk", "partial_write:6:1")
    with pytest.raises(OSError):
        _pull_assembled(w, rig, server)
    assert server.delivery_counts()[0] == 0
    meta, payload = _pull_assembled(w, rig, server)
    assert meta["chunks"] == 4  # 13 rows in 4-row chunks, replayed whole
    got, stats, _ = rig.decode(rig.engine(), payload, steps=5)
    np.testing.assert_array_equal(got, rig.want)
    assert stats["streamed"]
    assert w.faults.INJECTOR.snapshot()["trips"] == {"kv.stream.send_chunk": 1}


def test_stream_recv_drop_requeues_and_replays_byte_identical(w, server, stream_rig):
    rig = stream_rig[w.name]
    rig.produce(rig.prefill_engine, server, "drop-stream")
    w.faults.INJECTOR.arm("kv.stream.recv_chunk", "drop:1")
    with pytest.raises(OSError, match="injected kv stream recv loss"):
        _pull_assembled(w, rig, server)
    w.faults.INJECTOR.disarm()
    meta, payload = _pull_assembled(w, rig, server)
    got, _, _ = rig.decode(rig.engine(), payload, steps=5)
    np.testing.assert_array_equal(got, rig.want)
    assert any(e["kind"] == "kv_stream_torn" and e["request_id"] == "drop-stream"
               for e in w.flightrecorder.RECORDER.events())


def test_stream_decode_death_mid_stream_requeue_then_replay_dedup(w, server, stream_rig):
    rig = stream_rig[w.name]
    rig.produce(rig.prefill_engine, server, "death-stream")
    w.faults.INJECTOR.arm("kv.stream.recv_chunk", "exit:1")
    w.faults.INJECTOR.arm("kv.ack", "drop:1")
    seen = w.resilience.SeenIds(site="chaos-stream")
    before = counter(w, "serving_replays_deduped_total", {"site": "chaos-stream"})
    decodes = []

    def process(meta, payload):
        if seen.contains(meta["id"]):
            return  # a replay: ack without re-decoding
        got, _, _ = rig.decode(rig.engine(), payload, steps=5)
        decodes.append(got)
        seen.record(meta["id"])

    with pytest.raises(SystemExit):  # decode dies mid-stream
        _pull_assembled(w, rig, server, process=process)
    assert server.delivery_counts()[0] == 0 and not decodes
    _pull_assembled(w, rig, server, process=process)  # decodes; its ack is dropped
    assert len(decodes) == 1
    _pull_assembled(w, rig, server, process=process)  # the replay: deduped
    assert len(decodes) == 1
    np.testing.assert_array_equal(decodes[0], rig.want)
    assert wait_for(lambda: server.delivery_counts()[0] == 1)
    assert w.kt.pull_bundle(ep(server), timeout=0.2) is None
    assert counter(w, "serving_replays_deduped_total", {"site": "chaos-stream"}) == before + 1
    assert w.faults.INJECTOR.snapshot()["trips"] == {"kv.stream.recv_chunk": 1, "kv.ack": 1}


def test_stream_pace_throttles_each_chunk(w, server, stream_rig):
    """pace at kv.stream.send_chunk sleeps each chunk's bytes, and the
    paced stream still replays JAX's tokens."""
    rig = stream_rig[w.name]
    rig.produce(rig.prefill_engine, server, "paced-stream")
    w.faults.INJECTOR.arm("kv.stream.send_chunk", "pace:0.1")  # 100 kB/s
    t0 = time.perf_counter()
    meta, payload = _pull_assembled(w, rig, server)
    assert time.perf_counter() - t0 >= meta["payload_bytes"] / 0.1e6 * 0.9
    got, _, _ = rig.decode(rig.engine(), payload, steps=5)
    np.testing.assert_array_equal(got, rig.want)
    assert w.faults.INJECTOR.snapshot()["trips"] == {"kv.stream.send_chunk": 4}


# ---------------------------------------------------------------------------
# Port-only: the wire's gauges and counters, across frameworks, the worker


def test_inflight_gauge_and_transfer_counters_follow_the_bytes(stream_rig):
    """serving_kv_stream_inflight_chunks rises with each chunk produced and
    falls with its first ack (a torn delivery's replay releases nothing
    twice); serving_kv_transfer_bytes_total counts the bytes each role
    moved; serving_kv_copy_bytes_total the arrays_to_bytes join."""
    rig = stream_rig["port"]
    server = kt.KVServer(port=0, host="127.0.0.1")
    reg = metrics.REGISTRY
    try:
        sent0 = reg.counter_value("serving_kv_transfer_bytes_total", {"role": "prefill"})
        got0 = reg.counter_value("serving_kv_transfer_bytes_total", {"role": "decode"})
        # Earlier cases' handler threads may still be settling their acks.
        time.sleep(0.2)
        gauge0 = reg.gauge_value("serving_kv_stream_inflight_chunks") or 0.0
        rig.produce(rig.prefill_engine, server, "gauge")
        assert reg.gauge_value("serving_kv_stream_inflight_chunks") == gauge0 + 4
        faults.INJECTOR.arm("kv.stream.send_chunk", "partial_write:6:1")
        try:
            with pytest.raises(OSError):
                _pull_assembled(PKGS["port"], rig, server)
        finally:
            faults.INJECTOR.disarm()
        meta, _ = _pull_assembled(PKGS["port"], rig, server)
        assert reg.gauge_value("serving_kv_stream_inflight_chunks") == gauge0
        # The server counts its END after sending it: wait for that count.
        assert wait_for(lambda: reg.counter_value("serving_kv_transfer_bytes_total",
                                                  {"role": "prefill"}) == sent0 + meta["payload_bytes"])
        assert reg.counter_value("serving_kv_transfer_bytes_total",
                                 {"role": "decode"}) == got0 + meta["payload_bytes"]
        bundle = kt.arrays_to_bytes(x=np.zeros(10, np.float32))
        copy0 = reg.counter_value("serving_kv_copy_bytes_total", {"site": "arrays_to_bytes"})
        kt.arrays_to_bytes(x=np.zeros(10, np.float32))
        assert reg.counter_value("serving_kv_copy_bytes_total",
                                 {"site": "arrays_to_bytes"}) == copy0 + 40
        server.offer_bundle({"id": "mono"}, bundle)
        kt.pull_bundle(ep(server), timeout=1.0)
        assert wait_for(lambda: reg.counter_value("serving_kv_transfer_bytes_total",
                                                  {"role": "prefill"})
                        == sent0 + meta["payload_bytes"] + len(bundle))
    finally:
        server.close()


def test_port_ack_drop_against_jax_server_replays(stream_rig):
    """Across frameworks: the port's puller drops its ack (its own
    injector), the JAX server re-queues, and the replay lands in the port's
    dedup guard."""
    server = jkt.KVServer(port=0, host="127.0.0.1")
    try:
        server.offer_bundle({"id": "x1"}, b"kv")
        faults.INJECTOR.arm("kv.ack", "drop:1")
        seen = resilience.SeenIds(site="chaos-cross")
        decodes = []

        def process(meta, payload):
            if not seen.seen(meta["id"]):
                decodes.append(payload)

        kt.pull_bundle(ep(server), timeout=1.0, process=process)
        kt.pull_bundle(ep(server), timeout=1.0, process=process)
        assert decodes == [b"kv"]
        assert wait_for(lambda: server.delivery_counts()[0] == 1)
    finally:
        faults.INJECTOR.disarm()
        server.close()


def test_decode_processor_guards(stream_rig):
    """The decode worker's processor: an expired deadline posts a failed
    result and counts serving_deadline_expirations_total{site=decode.admit};
    a replay is acked without a second decode; a bundle past the decode
    budget is consumed with a failed result; a good bundle's result carries
    the handoff record and the span subtree."""
    from lws_tpu_torch.serving import disagg_worker as dw

    rig = stream_rig["port"]
    server = kt.KVServer(port=0, host="127.0.0.1")
    try:
        dec = rig.engine()
        process = dw.decode_processor(dec, server, steps=5)
        token, cache = rig.prefill_engine.prefill(rig.prompt[None])
        good = kt.cache_to_bundle(cache, token)
        before = metrics.REGISTRY.counter_value("serving_deadline_expirations_total",
                                                {"site": "decode.admit"})
        process({"id": "late", "deadline_s": 0.0}, good)
        meta, _ = kt.pull_result(ep(server), "late")
        assert meta["failed"] == "deadline exceeded before decode"
        assert metrics.REGISTRY.counter_value("serving_deadline_expirations_total",
                                              {"site": "decode.admit"}) == before + 1
        process({"id": "ok", "handoff": {"pos": 13}}, good)
        meta, payload = kt.pull_result(ep(server), "ok")
        np.testing.assert_array_equal(kt.bytes_to_arrays(payload)["tokens"], rig.want)
        assert {s["name"] for s in meta["spans"]} >= {"kv.deserialize", "serve.decode_dispatch"}
        process({"id": "ok", "handoff": {"pos": 13}}, good)  # a replay
        assert kt.pull_result(ep(server), "ok") is None  # not decoded or posted again
        big = kt.CacheAssembler(max_len=8, device="cpu")
        with pytest.raises(ValueError):
            big.chunk({"pos_range": [0, 13]}, kt.bytes_to_arrays(good))
        process({"id": "poison"}, kt.PoisonPayload(ValueError("13 KV rows but max_len=8")))
        meta, _ = kt.pull_result(ep(server), "poison")
        assert "max_len" in meta["failed"]
    finally:
        server.close()


def test_fault_schedules_arm_from_the_env_alike(monkeypatch):
    """LWS_TPU_FAULTS arms both injectors the same way: the parsed points,
    the specs, and the refusal of a malformed entry."""
    text = "kv.ack=drop:1; kv.stream.send_chunk=partial_write:8:1,kv.client.connect=delay:0"
    assert faults.parse(text) == jfaults.parse(text)
    monkeypatch.setenv("LWS_TPU_FAULTS", text)
    assert faults.FaultInjector().snapshot() == jfaults.FaultInjector().snapshot()
    try:
        faults.arm_from_env()
        assert faults.INJECTOR.snapshot()["armed"] == faults.parse(text)
    finally:
        faults.INJECTOR.disarm()
    for bad in ("kv.ack", "=drop", "kv.ack=drop:1,,x"):
        for mod in (faults, jfaults):
            with pytest.raises(ValueError):
                mod.parse(bad)
